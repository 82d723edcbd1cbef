"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric loads by name, names and units keep to their
characters, the configurations are what the program builds, and the
operation counts are the figures PERF.md quotes."""
import re

import pytest

from bench.harness import counts, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.cell(BENCH, name)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    conf = spec.config(BENCH, cell["config"])
    mix = spec.traffic(cell["traffic"])
    params = spec.cell_params(name)
    assert conf["n_slots"] >= 1 and mix["loop"] in ("open", "closed")
    assert params["gap_limit"] > 0 and params["check_requests"] >= 1
    if mix["loop"] == "open":
        assert params["rate_rps"] > 0
    reported = spec.metrics(BENCH, name, False) + spec.metrics(BENCH, name,
                                                               True)
    assert any(m["name"] == "setup_s" for m in reported)
    assert len(spec.metrics(BENCH, name, True)) >= 1


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(spec.reader(name))


@pytest.mark.parametrize("name", CELLS + METRICS + CONFIGS)
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=METRICS)
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    if metric["name"] in e2e:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in e2e and metric["layer"]
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric["name"].endswith("_roofline") or "_roofline." in \
            metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def _file(name):
    return spec.load_json(spec.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_config_entry_is_its_file(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"bench/configs/{name}.json"
    assert sorted(entry["reduced"]) == sorted(_file(name)["reduced"])
    assert spec.config(BENCH, name) == _file(name)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (spec.BENCH / "configs").glob("*.json")))
def test_config_is_what_the_program_builds(name):
    from repro_torch.configs import registry

    conf = _file(name)
    assert set(conf["reduced"]) <= set(conf["departures"])
    assert spec.mismatches(conf, registry.get(conf["registry_name"])) == {}


def test_mismatch_is_found():
    from repro_torch.configs import registry

    conf = dict(_file("deepseek-v2-lite-16b"), moe_intermediate_size=1024)
    got = spec.mismatches(conf, registry.get("deepseek-v2-lite-16b"))
    assert got == {"moe_intermediate_size": (1024, 1408)}
    conf = dict(_file("minicpm3-4b"), scale_emb=12)
    got = spec.mismatches(conf, registry.get("minicpm3-4b"))
    assert got == {"scale_emb": (12, None)}


def test_prefill_flops():
    ds = _file("deepseek-v2-lite-16b")
    mc = _file("minicpm3-4b")
    assert counts.active_params(ds) == 2_451_308_544
    assert counts.active_params(mc) == 4_073_492_480
    assert counts.prefill_flops(ds, 2048) == pytest.approx(1.062038e13,
                                                           rel=1e-5)
    assert counts.prefill_flops(mc, 2048) == pytest.approx(1.834933e13,
                                                           rel=1e-5)
