"""The port's hybrid workloads (``repro_torch.workloads``) against the
JAX reference's, on the CPU.

Both packages run ``run_hybrid`` on a simulated CPU pair (the port's
with ``device="cpu"``, asked for explicitly) from the same seeded numpy
inputs.  Tolerances: hist exact (integer counts); conv 2e-4 (the
port's host peer is the shift-add, the reference's default the XLA
convolution: K^2 f32 products summed in another order); spmv 1e-4
against the reference's value and against the dense product in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hybrid_executor import HybridExecutor as RefExecutor
from repro.workloads import conv as ref_conv
from repro.workloads import hist as ref_hist
from repro.workloads import spmv as ref_spmv
from repro_torch.core.hybrid_executor import HybridExecutor
from repro_torch.workloads import conv, hist, spmv

SIZES = {"conv": dict(size=96, ksize=5), "hist": dict(n=1 << 14, n_bins=64),
         "spmv": dict(n=512, density=0.02)}
MODULES = {"conv": (conv, ref_conv), "hist": (hist, ref_hist),
           "spmv": (spmv, ref_spmv)}
TOL = {"conv": 2e-4, "hist": 0.0, "spmv": 1e-4}


def _port():
    return HybridExecutor(device="cpu", simulated_ratio=4.0)


def _check_value(name, mine, ref):
    if TOL[name] == 0:
        np.testing.assert_array_equal(mine, ref)
    else:
        np.testing.assert_allclose(mine, ref, rtol=TOL[name],
                                   atol=TOL[name])


def test_inputs_are_the_references_bit_for_bit():
    img, w = conv.make_inputs(96, 5)
    rimg, rw = ref_conv.make_inputs(96, 5)
    np.testing.assert_array_equal(img, np.asarray(rimg))
    np.testing.assert_array_equal(w, np.asarray(rw))
    np.testing.assert_array_equal(hist.make_inputs(1 << 14, 64),
                                  np.asarray(ref_hist.make_inputs(1 << 14,
                                                                  64)))
    np.testing.assert_array_equal(spmv.make_matrix(256, 0.02),
                                  ref_spmv.make_matrix(256, 0.02))
    # the x that the reference's make_share_spec draws inline
    np.testing.assert_array_equal(
        spmv.make_vector(256), np.asarray(jnp.asarray(
            np.random.default_rng(1).standard_normal(256)
            .astype(np.float32))))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_run_hybrid_matches_reference(name):
    mod, ref_mod = MODULES[name]
    out = mod.run_hybrid(_port(), **SIZES[name])
    ref = ref_mod.run_hybrid(RefExecutor(simulated_ratio=4.0),
                             **SIZES[name])
    assert out.result.mode == ref.result.mode == "virtual"
    assert out.simulated
    assert out.value.device.type == "cpu"
    _check_value(name, out.value.numpy(), np.asarray(ref.value))


def test_spmv_value_matches_dense_product():
    out = spmv.run_hybrid(_port(), n=512, density=0.02)
    A = spmv.make_matrix(512, 0.02).astype(np.float64)
    np.testing.assert_allclose(out.value.numpy(),
                               A @ spmv.make_vector(512), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_each_chunk_runs_exactly_once(name):
    """Warm steady state: the executed chunks tile the work units
    exactly once, in unit order."""
    mod = MODULES[name][0]
    ex = _port()
    mod.run_hybrid(ex, **SIZES[name])                  # cold: warms
    out = mod.run_hybrid(ex, **SIZES[name])
    chunks = sorted((c.start, c.units) for c in out.trace.chunks)
    pos = 0
    for start, units in chunks:
        assert start == pos
        pos += units
    assert pos == sum(out.plan.units)
    assert len(out.trace.records) == len(chunks) == out.result.n_chunks
    assert sum(out.trace.group_units.values()) == pos


@pytest.mark.parametrize("name", sorted(MODULES))
def test_plan_override_is_honored(name):
    mod = MODULES[name][0]
    ex = _port()
    total = sum(mod.run_hybrid(ex, **SIZES[name]).plan.units)
    chunk = max(total // ex.n_chunks, 1)
    split = [total - 2 * chunk, 2 * chunk]
    out = mod.run_hybrid(ex, plan_override=split, **SIZES[name])
    assert [out.trace.group_units.get(g, 0) for g in ("accel", "host")] \
        == split
    assert out.result.steals == 0
    ref = out.value.numpy()
    base = mod.run_hybrid(_port(), **SIZES[name]).value.numpy()
    _check_value(name, ref, base)


def test_sequential_baseline_gives_the_same_value():
    ex = _port()
    a = conv.run_hybrid(ex, size=64, ksize=3)
    b = conv.run_hybrid(ex, size=64, ksize=3, sequential=True)
    assert b.result.mode == "sequential"
    assert torch.equal(a.value, b.value)
