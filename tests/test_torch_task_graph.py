"""The port's HEFT task scheduler (``repro_torch.core.task_graph``)
against the JAX reference's, on the same DAGs.

The module is pure Python, copied: the same graph must give the same
schedule — assignments, start and end times, makespan, idle shares and
critical path — with no tolerance.  The DAGs are the reference test's
(``tests/test_task_graph.py``) and random ones drawn by hypothesis.
"""
import random
import time

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import task_graph as ref_tg
from repro_torch.core import task_graph as tg

DEVICES = {"cpu0": "cpu", "gpu0": "gpu"}


def _lr_graph(mod):
    g = mod.TaskGraph()
    g.add("prng", {"cpu": 0.5, "gpu": 2.0}, output_bytes=6e9)
    g.add("fis", {"gpu": 0.6}, deps=["prng"])
    g.add("rank", {"gpu": 1.0, "cpu": 8.0}, deps=["fis"])
    g.add("expand", {"gpu": 0.4, "cpu": 1.5}, deps=["rank"])
    return g


def _host_only_graph(mod):
    g = mod.TaskGraph()
    g.add("solve", {"cpu": 1.0})
    return g


def _fig5_graph(mod, rounds=6):
    """The listrank workload's Fig. 5 pipeline at Hybrid-Low's ratio."""
    g = mod.TaskGraph()
    for r in range(rounds):
        g.add(f"prng{r}", {"cpu": 0.002, "gpu": 0.0004 * 3.9},
              output_bytes=4e5)
        g.add(f"fis{r}", {"gpu": 0.001, "cpu": 0.001 * 3.9},
              deps=[f"prng{r}"] + ([f"fis{r-1}"] if r else []))
    g.add("expand", {"gpu": 0.001, "cpu": 0.0039},
          deps=[f"fis{rounds-1}"])
    return g


def _random_graph(mod, seed, n):
    rng = random.Random(seed)
    g = mod.TaskGraph()
    names = []
    for i in range(n):
        deps = [d for d in names if rng.random() < 0.3]
        costs = {}
        if rng.random() < 0.9:
            costs["cpu"] = rng.uniform(0.1, 2.0)
        if rng.random() < 0.9 or not costs:
            costs["gpu"] = rng.uniform(0.1, 2.0)
        g.add(f"t{i}", costs, deps=deps, output_bytes=rng.uniform(0, 1e9))
        names.append(f"t{i}")
    return g


def _assert_same_schedule(mine, ref):
    assert set(mine.assignments) == set(ref.assignments)
    for name, a in mine.assignments.items():
        r = ref.assignments[name]
        assert (a.task, a.device, a.device_class, a.start, a.end) == \
            (r.task, r.device, r.device_class, r.start, r.end), name
    assert mine.makespan == ref.makespan
    assert mine.idle_frac == ref.idle_frac
    assert mine.critical_path == ref.critical_path
    assert mine.resource_efficiency() == ref.resource_efficiency()


@pytest.mark.parametrize("build", [_lr_graph, _host_only_graph, _fig5_graph],
                         ids=["lr", "host_only", "fig5"])
@pytest.mark.parametrize("link_bw", [6e9, 0.0])
def test_schedule_matches_reference(build, link_bw):
    _assert_same_schedule(build(tg).schedule(DEVICES, link_bw=link_bw),
                          build(ref_tg).schedule(DEVICES, link_bw=link_bw))


@given(seed=st.integers(0, 10_000), n=st.integers(2, 12))
@settings(max_examples=60, deadline=None)
def test_random_dag_schedule_matches_reference(seed, n):
    _assert_same_schedule(_random_graph(tg, seed, n).schedule(DEVICES),
                          _random_graph(ref_tg, seed, n).schedule(DEVICES))


def test_graph_errors_match_reference():
    for mod in (tg, ref_tg):
        g = mod.TaskGraph()
        g.add("a", {"cpu": 1.0})
        with pytest.raises(ValueError, match="unknown dep"):
            g.add("b", {"cpu": 1.0}, deps=["missing"])
        with pytest.raises(ValueError, match="duplicate"):
            g.add("a", {"cpu": 1.0})
        with pytest.raises(ValueError, match="no device"):
            g.add("c", {"tpu": 1.0}, deps=["a"])
            g.schedule(DEVICES)


def _sleeper(dt, tag):
    def fn(*deps):
        time.sleep(dt)
        return (tag, deps)
    return fn


def test_execute_concurrent_matches_serial_and_overlaps():
    """Two independent branches and a join: the lanes' results equal the
    serial run's, and the branches overlap."""
    dt = 0.05
    g = tg.TaskGraph()
    g.add("a", {"cpu": dt}, fn=_sleeper(dt, "a"))
    g.add("b", {"gpu": dt}, fn=_sleeper(dt, "b"))
    g.add("a2", {"cpu": dt}, deps=["a"], fn=_sleeper(dt, "a2"))
    g.add("b2", {"gpu": dt}, deps=["b"], fn=_sleeper(dt, "b2"))
    g.add("join", {"cpu": dt, "gpu": dt}, deps=["a2", "b2"],
          fn=lambda x, y: ("join", x, y))
    sched = g.schedule(DEVICES)
    serial = g.execute(sched)
    t_serial = g.last_measured_makespan
    conc = g.execute(sched, concurrent=True)
    t_conc = g.last_measured_makespan
    assert serial == conc
    assert t_conc < t_serial - dt / 2, (t_conc, t_serial)


def test_execute_concurrent_error_skips_dependents():
    ran = []
    g = tg.TaskGraph()
    g.add("bad", {"cpu": 0.01}, fn=lambda: 1 / 0)
    g.add("dep", {"gpu": 0.01}, deps=["bad"],
          fn=lambda b: ran.append(("dep", b)))
    with pytest.raises(ZeroDivisionError):
        g.execute(g.schedule(DEVICES), concurrent=True)
    assert ran == []
