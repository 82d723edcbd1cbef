"""The port's other eight Table-1 workloads, ``force_simulated`` and
the port-side benchmark drivers against the JAX reference, on the CPU.

Both packages run ``run_hybrid`` on a simulated CPU pair (the port's
with ``device="cpu"``, asked for explicitly) from the same seeded numpy
inputs.  Tolerances: spgemm 1e-4 against the reference's value and the
reference test's 2e-3 against ``A @ B``; raycast 1e-4; montecarlo 1e-5
relative; listrank, dither exact; concomp the same partition (labels
canonicalised to each component's least vertex: the merge's labels
depend on the split, which depends on timing); lbm 1e-5 and mass
conserved at 1e-4; bundle's final error within 1e-3 relative.

raycast is held against the reference's per-ray functions run op by op
(``jax.disable_jit()``): its compiled march contracts ``o + d * t``
into one fused multiply-add, and every ray starts on the volume's
z = 0 face, so whether the first step's sample counts flips with that
rounding (up to one step's sample, ~0.017, on about a quarter of the
rays).  The port rounds the product and the sum apart, as the
reference's own op-by-op run does.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import host_offload as ref_host_offload
from repro.core.hybrid_executor import HybridExecutor as RefExecutor
from repro.core.hybrid_executor import detect_platform as ref_detect
from repro.workloads import ALL_WORKLOADS as REF_ALL_WORKLOADS
from repro_torch.core import host_offload
from repro_torch.core.hybrid_executor import HybridExecutor, detect_platform
from repro_torch.workloads import ALL_WORKLOADS, conv

NEW = ["spgemm", "raycast", "montecarlo", "listrank", "concomp", "lbm",
       "dither", "bundle"]
SIZES = {"spgemm": dict(n=128, density=0.05),
         "raycast": dict(n_rays=1 << 10, d=16),
         "montecarlo": dict(n_photons=1 << 14, unit=1 << 10),
         "listrank": dict(n=1 << 12), "concomp": dict(n=1 << 11),
         "lbm": dict(d=12, n_steps=2), "dither": dict(h=48, w=40),
         "bundle": dict(n_cams=3, n_pts=64)}


def _mods(name):
    return (importlib.import_module(f"repro_torch.workloads.{name}"),
            importlib.import_module(f"repro.workloads.{name}"))


def _port(**kw):
    return HybridExecutor(device="cpu", simulated_ratio=4.0, **kw)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _canonical(labels):
    """Relabel each component by its least vertex."""
    _, first, inv = np.unique(np.asarray(labels), return_index=True,
                              return_inverse=True)
    return first[inv]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def _inputs(name, mod):
    """Every input array the workload's ``run_hybrid`` starts from."""
    if name == "spgemm":
        return mod.make_matrices(128, 0.05)
    if name == "raycast":
        return (mod.make_volume(16), *mod.make_rays(1 << 10))
    if name == "montecarlo":             # the stream run_hybrid draws
        if hasattr(mod, "make_stream"):
            return (mod.make_stream(1 << 14),)
        return (ref_host_offload.host_prng_stream(
            42, (1 << 14) * mod.N_STEPS).reshape(1 << 14, mod.N_STEPS),)
    if name == "listrank":
        return mod.make_list(1 << 12)
    if name == "concomp":
        return mod.make_graph(1 << 11)
    if name == "lbm":
        return (mod.init_state(12),)
    if name == "dither":
        return (mod.make_image(48, 40),)
    return mod.make_problem(3, 64)


@pytest.mark.parametrize("name", NEW)
def test_inputs_are_the_references_bit_for_bit(name):
    mine, ref = _mods(name)
    ours = _inputs(name, mine)
    theirs = _inputs(name, ref)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(b, int):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_host_prng_stream_is_the_references_bit_for_bit():
    for seed, n in ((7, 1000), (42, 1 << 12)):
        np.testing.assert_array_equal(
            host_offload.host_prng_stream(seed, n),
            ref_host_offload.host_prng_stream(seed, n))


# ---------------------------------------------------------------------------
# run_hybrid values
# ---------------------------------------------------------------------------
def _ref_raycast_op_by_op(ref, n_rays, d):
    vol = ref.make_volume(d)
    ro, rd = ref.make_rays(n_rays)
    with jax.disable_jit():
        return np.asarray(ref._march(vol, ro, rd, ref._entry(ro, rd)))


@pytest.mark.parametrize("name", NEW)
def test_run_hybrid_matches_reference(name):
    mine, ref = _mods(name)
    kw = SIZES[name]
    out = mine.run_hybrid(_port(), **kw)
    assert out.simulated and out.result.workload
    value = _np(out.value)
    if name == "raycast":
        np.testing.assert_allclose(
            value, _ref_raycast_op_by_op(ref, **kw), rtol=1e-4, atol=1e-4)
        assert out.result.hybrid_time > 0
        return
    ref_out = ref.run_hybrid(RefExecutor(simulated_ratio=4.0), **kw)
    assert out.result.workload == ref_out.result.workload
    ref_value = np.asarray(ref_out.value)
    if name == "spgemm":
        np.testing.assert_allclose(value, ref_value, rtol=1e-4, atol=1e-4)
        A, B = mine.make_matrices(**kw)
        np.testing.assert_allclose(value, A @ B, rtol=2e-3, atol=2e-3)
    elif name == "montecarlo":
        assert value == pytest.approx(float(ref_value), rel=1e-5)
    elif name in ("listrank", "dither"):
        np.testing.assert_array_equal(value, ref_value)
    elif name == "concomp":
        np.testing.assert_array_equal(_canonical(value),
                                      _canonical(ref_value))
    elif name == "lbm":
        np.testing.assert_allclose(value, ref_value, rtol=1e-5, atol=1e-5)
        mass0 = float(mine.init_state(kw["d"]).astype(np.float64).sum())
        assert float(value.astype(np.float64).sum()) == pytest.approx(
            mass0, rel=1e-4)
    else:                                    # bundle
        assert value == pytest.approx(float(ref_value), rel=1e-3)
    # the same plan shape; the task-graph workloads' model is the
    # reference's (the same slowdowns price the same schedule)
    assert len(out.plan.units) == len(ref_out.plan.units)
    assert set(out.result.busy_times) == set(ref_out.result.busy_times)


def test_listrank_ranks_walk_the_list():
    from repro_torch.workloads import listrank
    succ, head = listrank.make_list(1 << 10)
    rank = listrank.pointer_jump_rank(torch.from_numpy(succ)).numpy()
    node, n = head, len(succ)
    for r in range(n - 1, -1, -1):
        assert rank[node] == r
        node = succ[node]


def test_concomp_paths_match_reference_and_scipy():
    """Both groups' labelings (BFS on the host, label propagation on the
    device) give the least vertex of each component, as the reference's
    do, and the partition scipy's."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from repro.workloads import concomp as ref
    from repro_torch.workloads import concomp
    n, edges = concomp.make_graph(1 << 10, 2.0, seed=3)
    lp = concomp.label_prop_components(n, torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(
        lp, np.asarray(ref.label_prop_components(n, jnp.asarray(edges))))
    np.testing.assert_array_equal(concomp.bfs_components_np(n, edges),
                                  ref.bfs_components_np(n, edges))
    np.testing.assert_array_equal(lp, concomp.bfs_components_np(n, edges))
    adj = coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                     shape=(n, n))
    _, sp = connected_components(adj, directed=False)
    np.testing.assert_array_equal(_canonical(sp), _canonical(lp))


@pytest.mark.parametrize("d", [6, 12])
def test_lbm_step_all_matches_reference(d):
    from repro.workloads import lbm as ref
    from repro_torch.workloads import lbm
    f = lbm.init_state(d)
    mine = lbm.step_all(lbm.step_all(torch.from_numpy(f))).numpy()
    theirs = np.asarray(ref.step_all(ref.step_all(ref.init_state(d))))
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(96, 80), (1, 7), (7, 1), (5, 5)])
def test_fsd_dither_matches_reference_exactly(h, w):
    from repro.workloads import dither as ref
    from repro_torch.workloads import dither
    img = dither.make_image(h, w)
    np.testing.assert_array_equal(
        dither.fsd_dither(torch.from_numpy(img)).numpy(),
        np.asarray(ref.fsd_dither(jnp.asarray(img))))


# ---------------------------------------------------------------------------
# the executor's options and the drivers
# ---------------------------------------------------------------------------
def test_all_workloads_is_the_references_list():
    assert ALL_WORKLOADS == REF_ALL_WORKLOADS


@pytest.mark.parametrize("ratio", [1.0, 3.9])
def test_force_simulated_builds_the_references_pair(ratio):
    mine, sim = detect_platform(ratio, device="cpu", force_simulated=True)
    theirs, ref_sim = ref_detect(ratio, force_simulated=True)
    assert sim and ref_sim
    assert [(g.name, g.device_class, g.slowdown) for g in mine] == \
        [(g.name, g.device_class, g.slowdown) for g in theirs]
    # on the card the same pair lives on the GPU (no CUDA call is needed
    # to build it)
    groups, sim = detect_platform(ratio, device="cuda:0",
                                  force_simulated=True)
    assert sim and [str(g.devices[0]) for g in groups] == ["cuda:0"] * 2
    assert [g.slowdown for g in groups] == [1.0, ratio]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            detect_platform(ratio, force_simulated=True)


@pytest.mark.parametrize("ratio", [1.0, 3.9])
def test_simulated_and_real_gpu_pairs_never_share_calibration(ratio):
    """The simulated pair's ``host`` group runs on the GPU; the real
    pair's on the CPU at slowdown 1: at a ratio of 1.0 their keys
    (workload, group, slowdown) coincide, so the two keep apart stores."""
    real = HybridExecutor(device="cuda:0")
    sim = HybridExecutor(device="cuda:0", simulated_ratio=ratio,
                         force_simulated=True)
    assert not real.simulated and sim.simulated
    assert (real.backend, sim.backend) == ("torch:cuda",
                                           "torch:cuda:simulated")
    assert real.cache is not sim.cache
    sim.cache.put("cc-key-test", "host", 0.5, ratio)
    sim.cache.put("cc-key-test", "accel", 0.25, 1.0)
    assert real.cache.get("cc-key-test", "host", 1.0) is None
    assert real.cache.get("cc-key-test", "accel", 1.0) is None
    real.cache.put("cc-key-test2", "host", 0.5, 1.0)
    assert sim.cache.get("cc-key-test2", "host", ratio) is None
    assert _port().backend == "torch:cpu"


def test_scheduled_output_reads_the_schedule():
    """A task-graph call's output: the schedule's makespan is the hybrid
    time, each device is busy for its non-idle share of it, and the plan
    holds the units given."""
    from repro_torch.core.hybrid_executor import scheduled_output
    from repro_torch.core.task_graph import TaskGraph
    g = TaskGraph()
    g.add("a", {"accel": 1.0, "host": 4.0})
    g.add("b", {"host": 2.0}, deps=["a"])
    g.add("c", {"accel": 3.0, "host": 12.0})
    sched = g.schedule({"accel": "accel", "host": "host"}, link_bw=6e9)
    out = scheduled_output(_port(), "T", sched, {"host": 18.0}, "v", [2, 1])
    assert (out.value, out.plan.units, out.simulated, out.trace) == (
        "v", [2, 1], True, None)
    r = out.result
    assert (r.workload, r.hybrid_time, r.single_times) == (
        "T", sched.makespan, {"host": 18.0})
    assert set(r.busy_times) == {"accel", "host"}
    for d, f in sched.idle_frac.items():
        assert r.busy_times[d] == pytest.approx((1 - f) * sched.makespan)


@pytest.mark.parametrize("k_host", [0, 24, 48])
def test_conv_run_hybrid_with_split_honours_the_split(k_host):
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    ex = _port(force_simulated=True)
    out = conv.run_hybrid_with_split(ex, [96 - k_host, k_host], size=96,
                                     ksize=5)
    assert out.result.steals == 0
    assert out.trace.group_units.get("host", 0) == k_host
    assert out.trace.group_units.get("accel", 0) == 96 - k_host
    img, w = conv.make_inputs(96, 5)
    np.testing.assert_allclose(
        out.value.numpy(),
        conv2d_ref(torch.from_numpy(img), torch.from_numpy(w)).numpy(),
        rtol=2e-4, atol=2e-4)


TINY = dict(
    sort=dict(n=1 << 12, n_bins=16), hist=dict(n=1 << 14, n_bins=64),
    spmv=dict(n=256, density=0.02), bilateral=dict(size=48, radius=2),
    conv=dict(size=64, ksize=5), **SIZES)


def test_table2_runs_all_thirteen_on_the_cpu_pair(monkeypatch, capsys):
    from repro_torch.benchmarks import table2_hybrid
    monkeypatch.setattr(table2_hybrid, "SIZES", TINY)
    results = table2_hybrid.run(csv=False, device="cpu")
    assert list(results) == ["Hybrid-High", "Hybrid-Low"]
    names = {"sort", "hist", "spmv", "spgemm", "RC", "Bilat", "Conv", "MC",
             "LR", "CC", "LBM", "Dither", "Bundle"}
    for rs in results.values():
        assert [r.workload for r in rs] and {r.workload for r in rs} == names
        assert all(np.isfinite(r.hybrid_time) and r.hybrid_time > 0
                   for r in rs)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(",")[0] for line in lines] == [
        "table2/Hybrid-High/MEAN", "table2/Hybrid-Low/MEAN"]


def _reference_benchmark(name):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FIGURE_RUNS = {
    "fig4_overlap": dict(size=64, ksize=5, n_chunks=8),
    "split_sweep": dict(size=64, ksize=5, n_points=3),
    "fig3_scaling": {},
}
SMALL_SWEEPS = {"conv": [dict(size=s, ksize=5) for s in (32, 64)],
                "hist": [dict(n=1 << 12)],
                "spmv": [dict(n=128)],
                "montecarlo": [dict(n_photons=1 << 12, unit=1 << 10)]}


@pytest.mark.parametrize("name", sorted(FIGURE_RUNS))
def test_figure_drivers_print_the_references_rows(name, monkeypatch,
                                                  capsys):
    """Each driver prints the reference's rows (the same labels in the
    same order; the numbers are this run's) on the CPU pair."""
    mine = importlib.import_module(f"repro_torch.benchmarks.{name}")
    ref = _reference_benchmark(name)
    if name == "fig3_scaling":
        monkeypatch.setattr(mine, "SWEEPS", SMALL_SWEEPS)
        monkeypatch.setattr(ref, "SWEEPS", SMALL_SWEEPS)
    out = mine.run(device="cpu", **FIGURE_RUNS[name])
    ours = capsys.readouterr().out.splitlines()
    ref.run(**FIGURE_RUNS[name])
    theirs = capsys.readouterr().out.splitlines()

    def labels(lines):
        return [line.split(",")[0] for line in lines
                if not line.startswith(" ")]
    assert labels(ours) == labels(theirs) and ours
    if name == "fig4_overlap":
        assert out.result.mode == "virtual"
        assert "|mode=virtual|" in ours[1]
