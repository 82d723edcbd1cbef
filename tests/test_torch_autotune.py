"""The port's autotuning (``repro_torch.kernels.autotune`` and each
kernel's ``candidates`` / ``shape_bucket`` / ``cost_terms`` /
``tuned_config``) against the JAX reference, on the CPU.

* The search: both packages' ``autotune`` run the reference's own
  scenarios (``tests/test_autotune.py``, ``tests/test_cost_model.py``)
  with the same candidates, the same injected deterministic timer and
  the same cost predictions (one hardware profile installed in both),
  each on its own tune file, and must return the same configs and write
  the same entries (the backend key aside: ``cpu`` against
  ``torch:cpu``).
* The shape buckets equal the reference's letter for letter, so
  transfer works across the same buckets.
* Every non-CUDA candidate agrees with the reference's counterpart
  config at the reference test's tolerance (conv against
  ``conv2d_ref`` / ``conv2d_shift_add``: ``conv2d_pallas`` raises on
  this jax).
* With the search off every op computes bitwise what it computed
  before autotuning (the CPU peer of each kernel); with it on, ``sdpa``
  without a config reads no tune cache (the model layer resolves its
  own through ``model_config``) and ``gmm_model`` reads the hit of its
  bucket, neither timing anything (``tests/test_torch_tuned_layers.py``
  holds the model layers' lookup against the reference's).
* ``candidates`` on a CUDA device never lists an entry a route rules
  out for correctness (pure functions: they run here).
* The port's entries are keyed ``torch:cpu``; the reference never
  reads them.
* No module of the port imports JAX or the reference.
"""
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as ref_cm
from repro.kernels import autotune as ref_at
from repro_torch.core import cost_model as cm
from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels import autotune as at
from repro_torch.kernels.bilateral import ops as bilateral_ops
from repro_torch.kernels.bilateral.bilateral import bilateral_lut_torch
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.conv2d import conv2d_shift_add
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm.gmm import gmm_torch
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.kernels.hist.hist import hist_bincount
from repro_torch.kernels.sort_bitonic import ops as sort_ops
from repro_torch.kernels.sort_bitonic.ref import sort_rows_ref
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv.ref import spmv_ell_ref

ROOT = os.path.join(os.path.dirname(__file__), "..")
# (autotune module, cost_model module, store key of the CPU)
PKGS = {"ref": (ref_at, ref_cm, jax.default_backend()),
        "port": (at, cm, "torch:cpu")}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Search on, the model on, no top-K/transfer override, and one
    hardware profile installed in both packages (equal predictions)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_COST_MODEL", "1")
    monkeypatch.delenv("REPRO_TUNE_TOPK", raising=False)
    monkeypatch.delenv("REPRO_TUNE_TRANSFER", raising=False)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    for a, c, key in PKGS.values():
        prof = c.HardwareProfile(backend=key, matmul_flops=1e12,
                                 ew_flops=1e11, mem_bw=1e11,
                                 dispatch_s=1e-5, host_bw=1e10)
        monkeypatch.setattr(c, "get_profile", lambda *args, _p=prof: _p)
        a.reset_tune_cache()
    yield tmp_path
    for a, _, _ in PKGS.values():
        a.reset_tune_cache()


def _stub_timer(seed):
    """The i-th timed candidate always gets the i-th value of a seeded
    stream."""
    rng = np.random.default_rng(seed)
    return lambda fn: float(rng.random())


def _noop_maker(cfg):
    return lambda: None


def _counting(timed, value=None):
    """A timer that records each call and returns ``value`` (or the
    call's ordinal: the first measured candidate wins)."""
    def timer(fn):
        timed.append(1)
        return float(len(timed)) if value is None else value
    return timer


CANDS = [{"impl": "a"}, {"impl": "b"}, {"impl": "c"}, {"impl": "d"}]
DEFAULT = {"impl": "a", "tile": 1}
# the cost-model scenarios' candidates: three families
CANDS2 = [{"impl": "a", "tile": 1}, {"impl": "a", "tile": 2},
          {"impl": "a", "tile": 3}, {"impl": "b", "tile": 1},
          {"impl": "b", "tile": 2}, {"impl": "c", "tile": 1}]
DEFAULT2 = {"impl": "a", "tile": 0}


def _family_cost(c):
    """Family "a" predicted cheapest, larger tile cheaper in a family."""
    def cost_fn(cfg):
        fam = {"a": 1.0, "b": 2.0, "c": 4.0}[cfg.get("impl", "a")]
        return c.CostTerms(flops=1e9 * fam / max(cfg.get("tile", 1), 1))
    return cost_fn


# ----------------------------- the reference's scenarios, run by both
def sc_determinism(a, c, key, path, mp):
    cfg1 = a.autotune("k", "s", CANDS, _noop_maker, DEFAULT,
                      timer=_stub_timer(7))
    mp.setenv("REPRO_TUNE_CACHE", str(path.parent / "other.json"))
    a.reset_tune_cache()
    cfg2 = a.autotune("k", "s", CANDS, _noop_maker, DEFAULT,
                      timer=_stub_timer(7))
    times = np.random.default_rng(7).random(len(CANDS))
    assert cfg1 == cfg2 == {**DEFAULT, **CANDS[int(np.argmin(times))]}
    return cfg1, cfg2


def sc_failing_candidates(a, c, key, path, mp):
    def maker(cfg):
        if cfg["impl"] in ("a", "c"):
            raise ValueError("unsupported tiling")
        return lambda: None
    times = iter([0.5, 0.1])                  # b, d
    cfg = a.autotune("k", "s", CANDS, maker, DEFAULT,
                     timer=lambda fn: next(times))
    assert cfg["impl"] == "d"
    return cfg


def sc_all_failing(a, c, key, path, mp):
    def maker(cfg):
        raise ValueError("nope")
    cfg = a.autotune("k", "s", CANDS, maker, DEFAULT)
    entry = a.get_tune_cache().get(key, "k", "s")
    assert cfg == DEFAULT and entry is None   # not cached
    return cfg, entry


def sc_file_roundtrip(a, c, key, path, mp):
    calls = []
    cfg1 = a.autotune("k", "s", CANDS, _noop_maker, DEFAULT,
                      timer=_counting(calls))
    disk = json.loads(path.read_text())[key]["k"]["s"]
    a.reset_tune_cache()                      # drop memory, keep file
    cfg2 = a.autotune("k", "s", CANDS, _noop_maker, DEFAULT,
                      timer=_counting(calls))
    assert cfg1 == cfg2 == disk["config"] and len(calls) == len(CANDS)
    return cfg1, cfg2, len(calls), disk


def sc_distinct_buckets(a, c, key, path, mp):
    t = iter(range(1, 100))
    timer = (lambda fn: float(next(t)))
    a.autotune("k1", "s1", CANDS, _noop_maker, DEFAULT, timer=timer)
    a.autotune("k1", "s2", CANDS[:2], _noop_maker, DEFAULT, timer=timer)
    a.autotune("k2", "s1", CANDS[:2], _noop_maker, DEFAULT, timer=timer)
    cache = a.get_tune_cache()
    return [cache.get(key, k, s) for k, s in
            (("k1", "s1"), ("k1", "s2"), ("k2", "s1"), ("k2", "s3"))]


def sc_corrupt_file(a, c, key, path, mp):
    path.write_text("{not json")
    a.reset_tune_cache()
    cfg = a.autotune("k", "s", CANDS, _noop_maker, DEFAULT,
                     timer=_stub_timer(0))
    return cfg, json.loads(path.read_text())[key]   # repaired


def sc_disabled(a, c, key, path, mp):
    mp.setenv("REPRO_AUTOTUNE", "0")

    def boom(fn):
        pytest.fail("search ran while disabled")
    return a.autotune("k", "s", CANDS, _noop_maker, DEFAULT, timer=boom)


def sc_pinned(a, c, key, path, mp):
    mp.setenv("REPRO_TUNE_PIN_K", '{"impl": "pinned"}')

    def boom(fn):
        pytest.fail("search ran while pinned")
    cfg = a.autotune("k", "s", CANDS, _noop_maker, DEFAULT, timer=boom)
    assert cfg == {**DEFAULT, "impl": "pinned"}
    return cfg


def sc_topk_family_bests(a, c, key, path, mp):
    mp.setenv("REPRO_TUNE_TOPK", "3")
    timed = []
    cfg = a.autotune("k", "s1", CANDS2, _noop_maker, DEFAULT2,
                     timer=_counting(timed), cost_fn=_family_cost(c))
    assert len(timed) == 3 and cfg == {**DEFAULT2, "impl": "a", "tile": 3}
    return cfg, len(timed)


def sc_topk_zero_full(a, c, key, path, mp):
    mp.setenv("REPRO_TUNE_TOPK", "0")
    timed = []
    cfg = a.autotune("k", "s2", CANDS2, _noop_maker, DEFAULT2,
                     timer=_counting(timed), cost_fn=_family_cost(c))
    assert len(timed) == len(CANDS2)
    return cfg, len(timed)


def sc_model_off_full(a, c, key, path, mp):
    mp.setenv("REPRO_COST_MODEL", "0")
    timed = []
    cfg = a.autotune("k", "s3", CANDS2, _noop_maker, DEFAULT2,
                     timer=_counting(timed), cost_fn=_family_cost(c))
    assert len(timed) == len(CANDS2)
    return cfg, len(timed)


def sc_transfer(a, c, key, path, mp):
    def timer_full(fn):
        timer_full.i += 1
        return 0.1 if timer_full.i == 2 else 1.0 + timer_full.i
    timer_full.i = 0
    cfg_a = a.autotune("k", "N128_B16", CANDS2, _noop_maker, DEFAULT2,
                       timer=timer_full, cost_fn=None)
    timed = []
    cfg_b = a.autotune("k", "N256_B16", CANDS2, _noop_maker, DEFAULT2,
                       timer=_counting(timed, 0.5),
                       cost_fn=_family_cost(c))
    entry = a.get_tune_cache().get(key, "k", "N256_B16")
    assert len(timed) == 1 and cfg_b == cfg_a
    assert entry["via"] == "transfer:N128_B16"
    timer_full.i = 0
    mp.setenv("REPRO_TUNE_TRANSFER", "0")
    cfg_full = a.autotune("k", "N512_B16", CANDS2, _noop_maker, DEFAULT2,
                          timer=timer_full, cost_fn=None)
    assert cfg_full == cfg_b
    return cfg_a, cfg_b, entry, cfg_full


def sc_fit_guard(a, c, key, path, mp):
    a.get_tune_cache().put(key, "k2", "N128_B16", {"impl": "a", "tile": 64},
                           10.0)

    def cost_fn(cfg):
        return c.CostTerms(flops=1e12 if cfg.get("tile") == 64 else 1e9)
    timed = []
    cfg = a.autotune("k2", "N256_B16", CANDS2, _noop_maker, DEFAULT2,
                     timer=_counting(timed), cost_fn=cost_fn)
    assert len(timed) > 1                     # searched, did not transfer
    return cfg, len(timed)


def sc_incompatible_names(a, c, key, path, mp):
    a.get_tune_cache().put(key, "k3", "H128_W128_K5",
                           {"impl": "b", "tile": 1}, 10.0)
    near = a.nearest_bucket(a.get_tune_cache().buckets(key, "k3"),
                            "N256_B16")
    assert near is None
    return near


def sc_boolean_dims(a, c, key, path, mp):
    buckets = {"BH8_T1024_S1024_D64_c1": {"config": {"impl": "x"},
                                          "us": 1.0}}
    far = a.nearest_bucket(buckets, "BH8_T1024_S1024_D64_c0")
    near = a.nearest_bucket(buckets, "BH8_T512_S512_D64_c1")
    assert far is None and near[0] == "BH8_T1024_S1024_D64_c1"
    return far, near


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_determinism, sc_failing_candidates, sc_all_failing,
    sc_file_roundtrip, sc_distinct_buckets, sc_corrupt_file, sc_disabled,
    sc_pinned, sc_topk_family_bests, sc_topk_zero_full, sc_model_off_full,
    sc_transfer, sc_fit_guard, sc_incompatible_names, sc_boolean_dims)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_autotune_matches_reference(stores, monkeypatch, scenario):
    """Both packages' ``autotune`` through one scenario, each on its own
    tune file: the same results and the same entries written."""
    results, entries = {}, {}
    for name, (a, c, key) in PKGS.items():
        path = stores / name / "tune.json"
        path.parent.mkdir()
        with monkeypatch.context() as mp:
            mp.setenv("REPRO_TUNE_CACHE", str(path))
            a.reset_tune_cache()
            results[name] = SCENARIOS[scenario](a, c, key, path, mp)
            a.reset_tune_cache()
        entries[name] = (json.loads(path.read_text()).get(key)
                         if path.exists() else None)
    assert results["port"] == results["ref"]
    assert entries["port"] == entries["ref"]


def test_port_reuses_the_reference_knobs():
    for name in ("ENV_DISABLE", "ENV_CACHE", "ENV_PIN_PREFIX", "ENV_TOPK",
                 "ENV_TRANSFER", "DEFAULT_TOPK"):
        assert getattr(at, name) == getattr(ref_at, name)
    assert cm.ENV_DISABLE == ref_cm.ENV_DISABLE == "REPRO_COST_MODEL"
    assert at.bucket(1000) == ref_at.bucket(1000) == 1024
    assert at.freeze({"b": 1, "a": 2}) == ref_at.freeze({"b": 1, "a": 2})
    assert at.thaw(at.freeze({"b": 1, "a": 2})) == {"a": 2, "b": 1}


# ------------------------------------------------------- shape buckets
BUCKET_CASES = [
    ("conv2d", [(239, 3600, 15), (512, 512, 15), (33, 100, 5), (1, 1, 1)]),
    ("hist", [(1 << 22, 256), (1000, 16), (4097, 100), (1, 1)]),
    ("spmv", [(512, 3451), (512, 98), (33, 4), (1, 1)]),
    ("bilateral", [(239, 3600, 15), (50, 48, 5), (129, 77, 7)]),
    ("sort_bitonic", [(16384, 1024), (33, 64), (70, 128), (1, 2)]),
    ("flash_attention", [(256, 1024, 1024, 112, True),
                         (16, 77, 130, 112, False), (8, 100, 100, 32, True)]),
    ("gmm", [(384, 4, 7168, 2048), (2, 100, 96, 80), (8, 256, 256, 512)]),
]
PORT_OPS = {"conv2d": conv_ops, "hist": hist_ops, "spmv": spmv_ops,
            "bilateral": bilateral_ops, "sort_bitonic": sort_ops,
            "flash_attention": flash_ops, "gmm": gmm_ops}


@pytest.mark.parametrize("kernel,shapes", BUCKET_CASES,
                         ids=[k for k, _ in BUCKET_CASES])
def test_shape_buckets_are_the_references(kernel, shapes):
    import importlib
    ref_ops = importlib.import_module(f"repro.kernels.{kernel}.ops")
    for args in shapes:
        assert PORT_OPS[kernel].shape_bucket(*args) == \
            ref_ops.shape_bucket(*args), args


# ------------------------------- native candidates vs the reference's
@pytest.mark.parametrize("H,W,K", [(50, 70, 15), (64, 48, 3), (33, 100, 5)])
def test_conv2d_native_configs_match_reference(H, W, K):
    from repro.kernels.conv2d import ops as ref_ops
    rng = np.random.default_rng(H * W + K)
    img = rng.standard_normal((H, W)).astype(np.float32)
    w = rng.standard_normal((K, K)).astype(np.float32)
    for port_impl, ref_impl in (("torch_conv", "xla_conv"),
                                ("torch_shift", "xla_shift")):
        ref = np.asarray(ref_ops.conv2d(jnp.asarray(img), jnp.asarray(w),
                                        config={"impl": ref_impl}))
        out = conv_ops.conv2d(_t(img), _t(w), config={"impl": port_impl})
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4,
                                   err_msg=port_impl)


@pytest.mark.parametrize("n,bins", [(1000, 16), (4097, 100), (257, 7)])
def test_hist_native_configs_match_reference(n, bins):
    from repro.kernels.hist import ops as ref_ops
    x = np.random.default_rng(n).integers(0, bins, n, dtype=np.int32)
    for port_impl, ref_impl in (("torch_bincount", "xla_bincount"),
                                ("torch_sort", "xla_sort"),
                                ("host_bincount", "host_bincount")):
        ref = np.asarray(ref_ops.histogram(jnp.asarray(x), bins,
                                           config={"impl": ref_impl}))
        out = hist_ops.histogram(_t(x), bins, config={"impl": port_impl})
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=port_impl)
        assert out.dtype == torch.int32


def test_hist_native_configs_ignore_keys_out_of_range():
    x = _t(np.array([-3, 0, 1, 5, 7, 2, 9, 1], np.int32))
    want = hist_bincount(x, 6)
    for impl in ("torch_bincount", "torch_sort", "host_bincount"):
        assert torch.equal(hist_ops.histogram(x, 6, config={"impl": impl}),
                           want), impl


@pytest.mark.parametrize("R,C,K", [(100, 80, 8), (33, 100, 4)])
def test_spmv_native_config_matches_reference(R, C, K):
    from repro.kernels.spmv import ops as ref_ops
    rng = np.random.default_rng(R + C + K)
    vals = rng.standard_normal((R, K)).astype(np.float32)
    idx = rng.integers(0, C, (R, K), dtype=np.int32)
    x = rng.standard_normal(C).astype(np.float32)
    ref = np.asarray(ref_ops.spmv_ell(jnp.asarray(vals), jnp.asarray(idx),
                                      jnp.asarray(x),
                                      config={"impl": "xla_ell"}))
    out = spmv_ops.spmv_ell(_t(vals), _t(idx), _t(x),
                            config={"impl": "torch_ell"})
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_bilateral_native_config_matches_reference():
    from repro.kernels.bilateral import ops as ref_ops
    img = (np.random.default_rng(3).random((50, 48)) * 255).astype(
        np.float32)
    ref = np.asarray(ref_ops.bilateral(jnp.asarray(img), 2.0, 25.0, 2,
                                       config={"impl": "xla_lut"}))
    out = bilateral_ops.bilateral(_t(img), 2.0, 25.0, 2,
                                  config={"impl": "torch_lut"})
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("G,L", [(33, 64), (70, 128)])
def test_sort_native_configs_match_reference(G, L):
    from repro.kernels.sort_bitonic import ops as ref_ops
    x = np.random.default_rng(G * L).standard_normal((G, L)).astype(
        np.float32)
    for port_impl, ref_impl in (("torch_sort", "xla_sort"),
                                ("torch_bitonic", "xla_bitonic")):
        ref = np.asarray(ref_ops.sort_rows(jnp.asarray(x),
                                           config={"impl": ref_impl}))
        out = sort_ops.sort_rows(_t(x), config={"impl": port_impl})
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=port_impl)


@pytest.mark.parametrize("T,causal", [(100, True), (128, True), (96, False)])
def test_attention_native_configs_match_reference(T, causal):
    """T=100/96 are not multiples of the block: the ragged last block."""
    from repro.kernels.flash_attention import ops as ref_ops
    rng = np.random.default_rng(T)
    q = rng.standard_normal((2, T, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, T, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, T, 2, 32)).astype(np.float32)
    for port_cfg, ref_cfg in (
            ({"impl": "torch_blocked", "block_q": 64},
             {"impl": "xla_blocked", "block_q": 64}),
            ({"impl": "torch_blocked", "block_q": 256},
             {"impl": "xla_blocked", "block_q": 256}),
            ({"impl": "torch_ref"}, {"impl": "xla_ref"})):
        ref = np.asarray(ref_ops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            config=ref_cfg))
        out = flash_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                        config=port_cfg)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5,
                                   err_msg=str(port_cfg))


@pytest.mark.parametrize("E,C,D,F", [(2, 100, 96, 80), (4, 64, 32, 48)])
def test_gmm_native_configs_match_reference(E, C, D, F):
    from repro.kernels.gmm import ops as ref_ops
    rng = np.random.default_rng(E * C)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    ref = np.asarray(ref_ops.gmm(jnp.asarray(x), jnp.asarray(w),
                                 config={"impl": "xla_einsum"}))
    for impl in ("torch_einsum", "torch_plain"):
        out = gmm_ops.gmm(_t(x), _t(w), config={"impl": impl})
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4,
                                   err_msg=impl)


# --------------------------------------- the search off: as before
def _search_off_cases():
    rng = np.random.default_rng(11)
    img = _t(rng.standard_normal((37, 53)).astype(np.float32))
    w = _t(rng.standard_normal((5, 5)).astype(np.float32))
    keys = _t(rng.integers(-2, 40, 5000, dtype=np.int32))
    vals = _t(rng.standard_normal((40, 9)).astype(np.float32))
    idx = _t(rng.integers(0, 30, (40, 9), dtype=np.int32))
    xv = _t(rng.standard_normal(30).astype(np.float32))
    pix = _t((rng.random((37, 53)) * 255).astype(np.float32))
    sp, rl = (_t(a) for a in bilateral_luts(3.0, 30.0, 2))
    rows = _t(rng.standard_normal((9, 64)).astype(np.float32))
    q = _t(rng.standard_normal((2, 40, 4, 16)).astype(np.float32))
    kv = _t(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    xe = _t(rng.standard_normal((3, 5, 24)).astype(np.float32)).to(
        torch.bfloat16)
    we = _t(rng.standard_normal((3, 24, 16)).astype(np.float32)).to(
        torch.bfloat16)

    def attn_before():
        qf, kf, vf = flash_ops._flatten_gqa(q, kv, kv, repeat=True)
        return attention_ref(qf, kf, vf, True).reshape(2, 4, 40, 16) \
            .transpose(1, 2)

    return {
        "conv2d": (lambda: conv_ops.conv2d(img, w),
                   lambda: conv2d_shift_add(img, w)),
        "histogram": (lambda: hist_ops.histogram(keys, 40),
                      lambda: hist_bincount(keys, 40)),
        "spmv_ell": (lambda: spmv_ops.spmv_ell(vals, idx, xv),
                     lambda: spmv_ell_ref(vals, idx, xv)),
        "bilateral_filter": (
            lambda: bilateral_ops.bilateral_filter(pix, sp, rl),
            lambda: bilateral_lut_torch(pix, sp, rl)),
        "sort_rows": (lambda: sort_ops.sort_rows(rows),
                      lambda: sort_rows_ref(rows)),
        "flash_attention": (lambda: flash_ops.flash_attention(q, kv, kv),
                            attn_before),
        "sdpa": (lambda: flash_ops.sdpa(q, kv, kv), attn_before),
        "gmm": (lambda: gmm_ops.gmm(xe, we), lambda: gmm_torch(xe, we)),
        "gmm_model": (lambda: gmm_ops.gmm_model(xe, we),
                      lambda: gmm_torch(xe, we)),
    }


SEARCH_OFF = sorted(_search_off_cases())


@pytest.mark.parametrize("op", SEARCH_OFF)
def test_search_off_is_bitwise_the_cpu_peer(monkeypatch, op):
    """REPRO_AUTOTUNE=0: each op runs what it ran before autotuning."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    new, before = _search_off_cases()[op]
    assert torch.equal(new(), before())


@pytest.mark.parametrize("op", ["sdpa", "gmm_model"])
def test_lm_entries_read_no_tune_cache(stores, op, monkeypatch):
    """Where the tune cache holds another winner for the bucket, ``sdpa``
    without a config keeps the device's default: it reads no tune cache
    (the model layer passes ``model_config``'s pin or hit).
    ``gmm_model`` is the MoE layers' lookup itself: it runs the hit
    (``torch_einsum``, not the CPU default ``torch_plain``).  Neither
    searches."""
    cache = at.get_tune_cache()
    cache.put("torch:cpu", "flash_attention",
              flash_ops.shape_bucket(8, 40, 40, 16, True),
              {"impl": "torch_blocked", "block_q": 8}, 1.0)
    cache.put("torch:cpu", "gmm", gmm_ops.shape_bucket(3, 5, 24, 16),
              {"impl": "torch_einsum"}, 1.0)

    def boom(fn):
        pytest.fail("the LM path searched")
    prev = at.set_timer(boom)
    try:
        new, before = _search_off_cases()[op]
        if op == "gmm_model":
            ran, einsum = [], gmm_ops.gmm_ref
            monkeypatch.setattr(gmm_ops, "gmm_ref", lambda x, w: (
                ran.append(einsum(x, w)), ran[-1])[1])
            out = new()
            assert len(ran) == 1 and out is ran[0]
        else:
            assert torch.equal(new(), before())
    finally:
        at.set_timer(prev)


# ------------------------------------------------- validity of the space
def _entries(cands):
    return {c.get("entry") for c in cands if c["impl"] == "cuda"}


@pytest.mark.parametrize("case,forbidden,allowed", [
    (lambda d: conv_ops.candidates(239, 3600, 17, d), "conv2d_reg_f32",
     {"conv2d_f32"}),
    (lambda d: conv_ops.candidates(239, 3600, 15, d), None,
     {"conv2d_reg_f32", "conv2d_f32"}),
    (lambda d: hist_ops.candidates(1 << 20, 1817, d), "hist_priv_i32",
     {"hist_i32"}),
    (lambda d: hist_ops.candidates(1 << 20, 1816, d), None,
     {"hist_priv_i32", "hist_i32"}),
    (lambda d: bilateral_ops.candidates(239, 3600, 17, d), "bilateral_reg_f32",
     {"bilateral_f32"}),
    (lambda d: bilateral_ops.candidates(239, 3600, 15, d, 257),
     "bilateral_reg_f32", {"bilateral_f32"}),
    (lambda d: bilateral_ops.candidates(239, 3600, 15, d), None,
     {"bilateral_reg_f32", "bilateral_f32"}),
    (lambda d: flash_ops.candidates(1024, 1024, 112, True, d,
                                    torch.float32),
     "flash_attention_wgmma_bf16", {"flash_attention_fma_f32"}),
    (lambda d: flash_ops.candidates(64, 64, 130, True, d, torch.bfloat16),
     "flash_attention_wgmma_bf16", {"flash_attention_fma_bf16"}),
    (lambda d: flash_ops.candidates(1024, 1024, 112, True, d,
                                    torch.bfloat16), None,
     {"flash_attention_wgmma_bf16", "flash_attention_fma_bf16"}),
    (lambda d: gmm_ops.candidates(384, 4, 7168, 2048, d, torch.float32),
     "gmm_wgmma_bf16", {"gmm_fma_f32"}),
    (lambda d: gmm_ops.candidates(4, 4, 36, 20, d, torch.bfloat16, False),
     "gmm_wgmma_bf16", {"gmm_fma_bf16"}),
    (lambda d: gmm_ops.candidates(384, 4, 7168, 2048, d, torch.bfloat16),
     None, {"gmm_wgmma_bf16", "gmm_fma_bf16"}),
    (lambda d: spmv_ops.candidates(512, 3451, d), None,
     {"spmv_ell_seg_f32", "spmv_ell_f32"}),
])
def test_cuda_candidates_keep_the_routes_rules(case, forbidden, allowed):
    """On a CUDA device the space lists only entries that compute the
    shape correctly; on the CPU it lists no CUDA entry at all."""
    cands = case("cuda")
    assert _entries(cands) == allowed and forbidden not in _entries(cands)
    assert not _entries(case("cpu"))
    assert all(c["impl"] != "cuda" for c in case(torch.device("cpu")))


def test_sort_candidates_need_power_of_two_rows():
    assert {c["impl"] for c in sort_ops.candidates(8, 1024, "cuda")} == {
        "torch_sort", "torch_bitonic", "cuda"}
    assert {c["impl"] for c in sort_ops.candidates(8, 1000, "cuda")} == {
        "torch_sort"}
    assert {c["impl"] for c in sort_ops.candidates(8, 16384, "cuda")} == {
        "torch_sort", "torch_bitonic"}


def test_spmv_candidates_cover_every_threads_a_row():
    cands = spmv_ops.candidates(512, 98, "cuda")
    assert [(c.get("entry"), c.get("tpr")) for c in cands[1:]] == [
        ("spmv_ell_seg_f32", 32), ("spmv_ell_seg_f32", 64),
        ("spmv_ell_seg_f32", 128), ("spmv_ell_seg_f32", 256),
        ("spmv_ell_f32", None)]


@pytest.mark.parametrize("call", ["conv2d", "hist", "spmv", "bilateral",
                                  "sort", "attention", "gmm"])
def test_cuda_config_on_a_cpu_tensor_raises(call):
    """A pinned or cached CUDA config is never re-routed to the CPU."""
    cfg = {"impl": "cuda"}
    calls = {
        "conv2d": lambda: conv_ops.conv2d(torch.zeros(8, 8),
                                          torch.zeros(3, 3), config=cfg),
        "hist": lambda: hist_ops.histogram(
            torch.zeros(8, dtype=torch.int32), 4, config=cfg),
        "spmv": lambda: spmv_ops.spmv_ell(
            torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.int32),
            torch.zeros(4), config=cfg),
        "bilateral": lambda: bilateral_ops.bilateral_filter(
            torch.zeros(8, 8), torch.zeros(3, 3), torch.zeros(256),
            config=cfg),
        "sort": lambda: sort_ops.sort_rows(torch.zeros(4, 8), config=cfg),
        "attention": lambda: flash_ops.flash_attention(
            torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 1, 16),
            torch.zeros(1, 8, 1, 16), config=cfg),
        "gmm": lambda: gmm_ops.gmm(torch.zeros(2, 4, 8),
                                   torch.zeros(2, 8, 4), config=cfg),
    }
    with pytest.raises(ValueError):
        calls[call]()


@pytest.mark.parametrize("kernel,cfg,args", [
    ("conv2d", {"impl": "torch_shift"}, (239, 3600, 15)),
    ("conv2d", {"impl": "cuda", "entry": "conv2d_f32"}, (239, 3600, 15)),
    ("hist", {"impl": "torch_sort"}, (1 << 22, 256)),
    ("hist", {"impl": "cuda", "entry": "hist_i32"}, (1 << 22, 256)),
    ("spmv", {"impl": "cuda", "entry": "spmv_ell_seg_f32", "tpr": 64},
     (512, 3451)),
    ("bilateral", {"impl": "cuda", "entry": "bilateral_f32"},
     (239, 3600, 15)),
    ("sort_bitonic", {"impl": "cuda"}, (16384, 1024)),
    ("flash_attention", {"impl": "cuda",
                         "entry": "flash_attention_wgmma_bf16"},
     (256, 1024, 1024, 112, True, 2)),
    ("gmm", {"impl": "cuda", "entry": "gmm_wgmma_bf16"},
     (384, 4, 7168, 2048, 2)),
])
def test_every_candidate_has_cost_terms(kernel, cfg, args):
    ct = PORT_OPS[kernel].cost_terms(cfg, *args)
    assert ct.flops > 0 and ct.bytes > 0


def test_route_entry_is_the_family_best_predicted():
    """The model ranks each CUDA family's route entry first, so the
    top-K search always measures the kernel the route would run."""
    prof = cm.static_profile("cuda")
    for K in (98, 600, 1500, 3451):
        cands = [c for c in spmv_ops.candidates(512, K, "cuda")
                 if c["impl"] == "cuda"]
        best = min(cands, key=lambda c: prof.predict(
            spmv_ops.cost_terms(c, 512, K)))
        assert (best["entry"], best["tpr"]) == spmv_ops.route(K)
    for ops_, args, entry in (
            (conv_ops, (239, 3600, 15), "conv2d_reg_f32"),
            (bilateral_ops, (239, 3600, 15), "bilateral_reg_f32")):
        cands = [c for c in ops_.candidates(*args, "cuda")
                 if c["impl"] == "cuda"]
        best = min(cands, key=lambda c: prof.predict(
            ops_.cost_terms(c, *args)))
        assert best["entry"] == entry


# ------------------------------------------------------ store keys
def test_port_entries_are_keyed_torch_cpu(stores):
    """The port tunes a real op into the shared file under
    ``torch:cpu``; the reference then finds no entry for its bucket and
    searches, and both sections live on in the file."""
    img = np.random.default_rng(1).standard_normal((16, 16)).astype(
        np.float32)
    w = np.random.default_rng(2).standard_normal((3, 3)).astype(np.float32)
    timed = []
    prev = at.set_timer(_counting(timed))
    try:
        cfg = conv_ops.tuned_config(_t(img), _t(w))
    finally:
        at.set_timer(prev)
    assert len(timed) == 2 and cfg == {"impl": "torch_conv"}
    bkt = conv_ops.shape_bucket(16, 16, 3)
    data = json.loads((stores / "tune.json").read_text())
    assert list(data) == ["torch:cpu"]
    assert data["torch:cpu"]["conv2d"][bkt]["config"] == cfg
    assert ref_at.tuned_entry("conv2d", bkt) is None
    ref_timed = []
    ref_cfg = ref_at.autotune("conv2d", bkt, [{"impl": "xla_conv"}],
                              _noop_maker, {"impl": "xla_shift"},
                              timer=_counting(ref_timed))
    assert ref_timed == [1] and ref_cfg == {"impl": "xla_conv"}
    data = json.loads((stores / "tune.json").read_text())
    assert set(data) == {"torch:cpu", jax.default_backend()}
    assert at.tuned_entry("conv2d", bkt)["config"] == cfg


def test_ops_search_once_then_hit(stores):
    """tuned_config searches on a miss and measures nothing on the next
    call; the winner computes the reference's value."""
    from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref
    img = np.random.default_rng(4).standard_normal((16, 16)).astype(
        np.float32)
    w = np.random.default_rng(5).standard_normal((3, 3)).astype(np.float32)
    timed = []
    prev = at.set_timer(_counting(timed))
    try:
        cfg1 = conv_ops.tuned_config(_t(img), _t(w))
        n = len(timed)
        cfg2 = conv_ops.tuned_config(_t(img), _t(w))
    finally:
        at.set_timer(prev)
    assert n > 0 and cfg1 == cfg2 and len(timed) == n
    np.testing.assert_allclose(
        conv_ops.conv2d(_t(img), _t(w), config=cfg1).numpy(),
        np.asarray(jax_conv_ref(jnp.asarray(img), jnp.asarray(w))),
        rtol=2e-4, atol=2e-4)


def _kernel_fails(cfg):
    """A space where the hand-written kernel's candidate raises (a
    build or launch failure) and the native ones run."""
    def fn():
        if cfg["impl"] == "cuda":
            raise RuntimeError("kernel failed to launch")
    return fn


CUDA_SPACE = [{"impl": "torch_a"}, {"impl": "cuda", "entry": "e1"},
              {"impl": "torch_b"}]


@pytest.mark.parametrize("path", ["search", "transfer"])
def test_failing_kernel_candidate_on_a_cuda_device_raises(stores, path):
    """On a CUDA device a kernel candidate that raises stops the search
    (or the transfer seed) with its error, and nothing is cached: a
    broken kernel is never tuned away in favour of a native one."""
    if path == "transfer":
        at.get_tune_cache().put("torch:cuda", "k", "H64_W64_K5",
                                {"impl": "cuda", "entry": "e1"}, 1.0)
    timed = []

    def timer(fn):
        timed.append(1)
        fn()
        return float(len(timed))
    with pytest.raises(RuntimeError, match="kernel failed"):
        at.autotune("k", "H128_W64_K5", CUDA_SPACE, _kernel_fails,
                    {"impl": "cuda"}, timer=timer, device="cuda")
    assert at.tuned_entry("k", "H128_W64_K5", device="cuda") is None


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_failing_native_candidates_are_skipped(stores, device):
    """Native candidates that raise are skipped on either device (the
    reference's behaviour); the kernel candidate is skipped only off a
    CUDA device, where it is not the platform's implementation."""
    def natives_fail(cfg):
        def fn():
            if cfg["impl"] != ("cuda" if device == "cuda" else "torch_b"):
                raise RuntimeError("native failed")
        return fn

    def timer(fn):
        fn()
        return 1.0
    cfg = at.autotune("k", "s", CUDA_SPACE, natives_fail, {"impl": "x"},
                      timer=timer, device=device)
    assert cfg == ({"impl": "cuda", "entry": "e1"} if device == "cuda"
                   else {"impl": "torch_b"})


# ------------------------------------------------ the port stands alone
def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


@pytest.mark.parametrize("B,H,Kv", [(1, 8, 2), (1, 4, 4), (2, 4, 2)])
def test_flatten_gqa_is_contiguous_at_every_batch(B, H, Kv):
    """At B = 1 the reshape of the transposed heads is a strided view;
    the kernel refuses those, so the flattened operands are copies (the
    cold_start search at B = 1 found its CUDA candidates failing)."""
    q = torch.randn(B, 16, H, 8)
    k, v = torch.randn(B, 16, Kv, 8), torch.randn(B, 16, Kv, 8)
    for repeat in (False, True):
        for t in flash_ops._flatten_gqa(q, k, v, repeat=repeat):
            assert t.is_contiguous()
    qf, _, _ = flash_ops._flatten_gqa(q, k, v)
    assert torch.equal(qf, q.transpose(1, 2).reshape(B * H, 16, 8))


@pytest.mark.parametrize("name", ["conv", "hist", "bilateral"])
def test_workloads_resolve_once_per_device_with_the_search_on(stores, name,
                                                              monkeypatch):
    """On the simulated pair (both groups on the CPU) a workload resolves
    its tuned config once, at one chunk's shape, and computes what it
    computes with the search off."""
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.workloads import bilateral, conv, hist
    run = {"conv": lambda ex: conv.run_hybrid(ex, size=64, ksize=5),
           "hist": lambda ex: hist.run_hybrid(ex, n=1 << 12, n_bins=16),
           "bilateral": lambda ex: bilateral.run_hybrid(
               ex, size=48, sigma_s=2.0, sigma_r=25.0, radius=2)}[name]
    kernel = {"conv": "conv2d", "hist": "hist", "bilateral": "bilateral"}
    timed = []
    prev = at.set_timer(_counting(timed))
    try:
        tuned = run(HybridExecutor(device="cpu"))
    finally:
        at.set_timer(prev)
    entries = json.loads((stores / "tune.json").read_text())["torch:cpu"]
    assert list(entries) == [kernel[name]]
    (bkt, entry), = entries[kernel[name]].items()
    assert len(timed) == {"conv": 2, "hist": 3, "bilateral": 1}[name]
    # one of 16 chunks: conv's 4 rows + 4 halo rows of 64, bilateral's
    # 3 + 4 of 48 (bucket 8 x 64), hist's 4 units of 64 keys
    assert bkt == {"conv": "H8_W64_K5", "bilateral": "H8_W64_K5",
                   "hist": "N256_B16"}[name]
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    plain = run(HybridExecutor(device="cpu"))
    torch.testing.assert_close(tuned.value, plain.value, rtol=2e-4,
                               atol=2e-4)


def test_spmv_resolves_every_tile_width_in_set_up(stores, monkeypatch):
    """spmv tunes one ELL config per tile-width bucket before it
    calibrates, so no candidate is timed inside calibration or the
    timed call, however the plan moves; the values are the search-off
    values (at the workload's tolerance: the two calls may split the
    rows apart, which changes the summation order)."""
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.workloads import spmv
    window = []
    for name in ("calibrate", "run_work_shared"):
        orig = getattr(HybridExecutor, name)

        def wrapped(self, *a, _orig=orig, **k):
            window.append(1)
            try:
                return _orig(self, *a, **k)
            finally:
                window.pop()
        monkeypatch.setattr(HybridExecutor, name, wrapped)
    timed = []

    def timer(fn):
        assert not window, "a candidate was timed inside the call"
        timed.append(1)
        return 1.0
    n, density = 1024, 0.01
    prev = at.set_timer(timer)
    try:
        tuned = spmv.run_hybrid(HybridExecutor(device="cpu"), n, density)
        first = len(timed)
        spmv.run_hybrid(HybridExecutor(device="cpu"), n, density)
    finally:
        at.set_timer(prev)
    A = spmv.make_matrix(n, density)
    widths = {at.bucket(max(int(k), 1)) for k in (A != 0).sum(1)}
    entries = json.loads((stores / "tune.json").read_text())
    tuned_k = {int(b.split("_K")[1]) for b in entries["torch:cpu"]["spmv"]}
    assert tuned_k == widths and first == len(widths) > 1
    assert len(timed) == first                      # the second call hits
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    plain = spmv.run_hybrid(HybridExecutor(device="cpu"), n, density)
    torch.testing.assert_close(tuned.value, plain.value, rtol=1e-4,
                               atol=1e-4)
