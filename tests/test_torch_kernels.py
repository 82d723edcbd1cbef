"""The port's kernel modules (``repro_torch.kernels``) against the JAX
reference, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function
and its port.  On the CPU a port wrapper runs its CPU peer (shift-add,
bincount, the ELL gather-sum); the hand-written CUDA kernels run only
on a GPU, in ``test_torch_cuda.py``.
The reference's ``conv2d_pallas`` does not run on this jax version, so
conv is held against ``conv2d_ref`` and ``conv2d_shift_add``; hist,
spmv, the row sorter and the bilateral filter are also held against
their Pallas kernels in interpret mode.

Tolerances are the reference's own (tests/test_kernels.py): hist and
sort exact (integer counts; a sort is a permutation), spmv 2e-5 (f32
sums in another order), conv 2e-4 (K^2 f32 products summed in another
order), bilateral 1e-3 (the LUT filter against the direct one, and f32
sums in another order), binned spmv against the dense product 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.host_offload import bilateral_luts as jax_luts
from repro.kernels.bilateral.bilateral import bilateral_pallas
from repro.kernels.bilateral.ref import bilateral_ref as jax_bilateral_ref
from repro.kernels.conv2d.conv2d import conv2d_shift_add as jax_shift_add
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref
from repro.kernels.hist.hist import hist_pallas
from repro.kernels.hist.ref import hist_ref as jax_hist_ref
from repro.kernels.spmv import ops as jax_spmv_ops
from repro.kernels.spmv.ref import spmv_coo_ref as jax_coo_ref
from repro.kernels.spmv.ref import spmv_ell_ref as jax_ell_ref
from repro.kernels.sort_bitonic.sort_bitonic import sort_rows_pallas
from repro.kernels.spmv.spmv import spmv_ell_pallas
from repro.workloads import sort as ref_sort
from repro_torch.core.cost_model import probe_add_one
from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels import common
from repro_torch.kernels.bilateral import ops as bilateral_ops
from repro_torch.kernels.bilateral.bilateral import (bilateral_cuda,
                                                     bilateral_lut_torch)
from repro_torch.kernels.bilateral.ref import bilateral_ref
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.conv2d import conv2d_cuda, conv2d_shift_add
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.kernels.hist.hist import hist_bincount, hist_cuda
from repro_torch.kernels.hist.ref import hist_ref
from repro_torch.kernels.sort_bitonic import ops as sort_ops
from repro_torch.kernels.sort_bitonic.ref import sort_rows_ref
from repro_torch.kernels.sort_bitonic.sort_bitonic import (
    bitonic_rows_torch, sort_rows_cuda)
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv.ref import spmv_ell_ref
from repro_torch.kernels.spmv.spmv import spmv_ell_cuda
from repro_torch.workloads import sort as sort_w

CONV_IMPLS = {"ref": conv2d_ref, "ops": conv_ops.conv2d,
              "shift_add": conv2d_shift_add}
HIST_IMPLS = {"ref": hist_ref, "ops": hist_ops.histogram,
              "bincount": hist_bincount}
ELL_IMPLS = {"ref": spmv_ell_ref, "ops": spmv_ops.spmv_ell}
SORT_IMPLS = {"ref": sort_rows_ref, "ops": sort_ops.sort_rows,
              "bitonic": bitonic_rows_torch}
BILAT_IMPLS = {"ops": bilateral_ops.bilateral_filter,
               "lut": bilateral_lut_torch}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- conv
@pytest.mark.parametrize("impl", sorted(CONV_IMPLS))
@pytest.mark.parametrize("H,W,K", [(64, 48, 3), (130, 96, 5), (50, 64, 15)])
def test_conv2d_matches_reference(H, W, K, impl):
    rng = np.random.default_rng(H * W + K)
    img = rng.standard_normal((H, W)).astype(np.float32)
    w = rng.standard_normal((K, K)).astype(np.float32)
    out = CONV_IMPLS[impl](_t(img), _t(w)).numpy()
    for ref in (jax_conv_ref(jnp.asarray(img), jnp.asarray(w)),
                jax_shift_add(jnp.asarray(img), jnp.asarray(w))):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)


# --------------------------------------------------------------- hist
@pytest.mark.parametrize("impl", sorted(HIST_IMPLS))
@pytest.mark.parametrize("n,bins,tile", [
    (1000, 16, 256), (4096, 256, 2048), (5000, 100, 512), (257, 7, 128)])
def test_hist_matches_reference(n, bins, tile, impl):
    x = np.random.default_rng(n).integers(0, bins, n, dtype=np.int32)
    out = HIST_IMPLS[impl](_t(x), bins).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(
        jax_hist_ref(jnp.asarray(x), bins)))
    np.testing.assert_array_equal(out, np.asarray(
        hist_pallas(jnp.asarray(x), bins, tile=tile, interpret=True)))


@pytest.mark.parametrize("impl", sorted(HIST_IMPLS))
def test_hist_ignores_keys_out_of_range(impl):
    """Keys outside [0, n_bins) count nowhere, as in the one-hot Pallas
    kernel (which compares each key against every bin)."""
    x = np.random.default_rng(3).integers(-3, 12, 777, dtype=np.int32)
    out = HIST_IMPLS[impl](_t(x), 9).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        hist_pallas(jnp.asarray(x), 9, tile=128, interpret=True)))


# --------------------------------------------------------------- spmv
@pytest.mark.parametrize("impl", sorted(ELL_IMPLS))
@pytest.mark.parametrize("R,C,K", [(100, 80, 8), (256, 256, 16),
                                   (33, 100, 4)])
def test_spmv_ell_matches_reference(R, C, K, impl):
    rng = np.random.default_rng(R + C + K)
    vals = rng.standard_normal((R, K)).astype(np.float32)
    idx = rng.integers(0, C, (R, K), dtype=np.int32)
    x = rng.standard_normal(C).astype(np.float32)
    out = ELL_IMPLS[impl](_t(vals), _t(idx), _t(x)).numpy()
    jv, ji, jx = jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(x)
    for ref in (jax_ell_ref(jv, ji, jx),
                spmv_ell_pallas(jv, ji, jx, row_tile=64, interpret=True)):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


def test_spmv_coo_matches_reference():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 50, 400, dtype=np.int32)
    cols = rng.integers(0, 70, 400, dtype=np.int32)
    vals = rng.standard_normal(400).astype(np.float32)
    x = rng.standard_normal(70).astype(np.float32)
    out = spmv_ops.spmv_coo(_t(rows), _t(cols), _t(vals), _t(x), 50)
    ref = jax_coo_ref(jnp.asarray(rows), jnp.asarray(cols),
                      jnp.asarray(vals), jnp.asarray(x), 50)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def _binned_matrix():
    rng = np.random.default_rng(0)
    A = ((rng.random((200, 150)) < 0.05)
         * rng.standard_normal((200, 150))).astype(np.float32)
    A[3] = rng.standard_normal(150)          # dense row -> COO tail
    return A, rng.standard_normal(150).astype(np.float32)


def test_spmv_prepare_packs_like_reference():
    """The numpy row binning is the reference's, bit for bit."""
    A, _ = _binned_matrix()
    m = spmv_ops.prepare(A, k_threshold=16, device="cpu")
    r = jax_spmv_ops.prepare(A, k_threshold=16)
    for field in ("ell_vals", "ell_idx", "ell_rows", "coo_rows",
                  "coo_cols", "coo_vals"):
        np.testing.assert_array_equal(getattr(m, field).numpy(),
                                      np.asarray(getattr(r, field)),
                                      err_msg=field)
    assert (m.n_rows, m.n_cols) == (r.n_rows, r.n_cols)


def test_spmv_binned_end_to_end():
    A, x = _binned_matrix()
    m = spmv_ops.prepare(A, k_threshold=16, device="cpu")
    assert m.coo_vals.shape[0] > 0           # the tail path is exercised
    np.testing.assert_allclose(spmv_ops.spmv(m, _t(x)).numpy(), A @ x,
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- sort
@pytest.mark.parametrize("impl", sorted(SORT_IMPLS))
@pytest.mark.parametrize("G,L", [(10, 16), (70, 64), (33, 256)])
def test_sort_rows_matches_reference(G, L, impl):
    x = np.random.default_rng(G * L).standard_normal((G, L)).astype(
        np.float32)
    out = SORT_IMPLS[impl](_t(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        sort_rows_pallas(jnp.asarray(x), row_tile=32, interpret=True)))


@pytest.mark.parametrize("impl", sorted(SORT_IMPLS))
def test_sort_rows_duplicates_infs_and_signed_zeros(impl):
    """Rows the leaf sorter meets: +inf padding, -inf, duplicates and
    -0.0 beside 0.0 (equal under ==, which is what a sort orders by)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    x[0, 100:] = np.inf
    x[1, :20] = -np.inf
    x[1, 20:40] = np.inf
    x[2] = np.round(x[2])
    x[3, ::2], x[3, 1::2] = -0.0, 0.0
    x[4] = 1.5
    out = SORT_IMPLS[impl](_t(x))
    assert torch.equal(out, torch.from_numpy(np.sort(x, axis=1)))
    assert torch.equal(out, torch.tensor(np.asarray(sort_rows_pallas(
        jnp.asarray(x), row_tile=32, interpret=True))))


@pytest.mark.parametrize("n,tile", [(4096, 1024), (3000, 256), (5, 16)])
def test_leaf_sort_bitonic_matches_reference(n, tile):
    x = np.random.default_rng(n).random(n, dtype=np.float32)
    out = sort_w.leaf_sort_bitonic(_t(x), tile=tile)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        ref_sort.leaf_sort_bitonic(jnp.asarray(x), tile=tile)))


# ---------------------------------------------------------- bilateral
@pytest.mark.parametrize("impl", sorted(BILAT_IMPLS))
@pytest.mark.parametrize("H,W,radius", [(64, 48, 2), (37, 53, 3)])
def test_bilateral_lut_matches_reference(H, W, radius, impl):
    img = (np.random.default_rng(H * W).random((H, W)) * 255).astype(
        np.float32)
    sp, rl = bilateral_luts(2.0, 25.0, radius)
    out = BILAT_IMPLS[impl](_t(img), _t(sp), _t(rl)).numpy()
    ref = bilateral_pallas(jnp.asarray(img), jnp.asarray(sp),
                           jnp.asarray(rl), row_tile=16, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("H,W,radius", [(64, 48, 2), (37, 53, 3)])
def test_bilateral_direct_matches_reference(H, W, radius):
    img = (np.random.default_rng(H + W).random((H, W)) * 255).astype(
        np.float32)
    out = bilateral_ref(_t(img), 2.0, 25.0, radius).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_bilateral_ref(
        jnp.asarray(img), 2.0, 25.0, radius)), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        bilateral_ops.bilateral(_t(img), 2.0, 25.0, radius).numpy(), out,
        rtol=5e-3, atol=5e-2)


def test_bilateral_luts_are_the_references():
    for args in ((2.0, 25.0, 2), (3.0, 30.0, 7)):
        for mine, ref in zip(bilateral_luts(*args), jax_luts(*args)):
            np.testing.assert_array_equal(mine, ref)


# -------------------------------------------------------------- probe
def test_probe_add_one_cpu():
    t = _t(np.random.default_rng(5).standard_normal((128, 128)).astype(
        np.float32))
    assert torch.equal(probe_add_one(t), t + 1.0)


# ------------------------------------------- dispatch and the library
@pytest.mark.parametrize("call", ["conv2d", "hist", "spmv_ell",
                                  "sort_bitonic", "bilateral"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper never falls back: a tensor that is not on a GPU
    is refused before any pointer leaves Python."""
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        if call == "conv2d":
            conv2d_cuda(x, torch.zeros((3, 3)))
        elif call == "hist":
            hist_cuda(torch.zeros(8, dtype=torch.int32), 4)
        elif call == "spmv_ell":
            spmv_ell_cuda(x, torch.zeros((4, 4), dtype=torch.int32),
                          torch.zeros(4))
        elif call == "sort_bitonic":
            sort_rows_cuda(x)
        else:
            bilateral_cuda(x, torch.zeros((3, 3)), torch.zeros(256))


_OTHER_CONFIG = {"impl": "pallas"}
OPS_CALLS = {
    "conv2d": lambda: conv_ops.conv2d(torch.zeros((8, 8)),
                                      torch.zeros((3, 3)),
                                      config=_OTHER_CONFIG),
    "histogram": lambda: hist_ops.histogram(
        torch.zeros(8, dtype=torch.int32), 4, config=_OTHER_CONFIG),
    "spmv_ell": lambda: spmv_ops.spmv_ell(
        torch.zeros((4, 4)), torch.zeros((4, 4), dtype=torch.int32),
        torch.zeros(4), config=_OTHER_CONFIG),
    "sort_rows": lambda: sort_ops.sort_rows(torch.zeros((4, 8)),
                                            config=_OTHER_CONFIG),
    "bilateral_filter": lambda: bilateral_ops.bilateral_filter(
        torch.zeros((8, 8)), torch.zeros((3, 3)), torch.zeros(256),
        config=_OTHER_CONFIG),
}


@pytest.mark.parametrize("call", sorted(OPS_CALLS))
def test_ops_refuse_other_configs(call):
    """Only the default tiling exists until autotuning is ported."""
    with pytest.raises(ValueError):
        OPS_CALLS[call]()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(common.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        common.find_nvcc()


def test_resolve_device_needs_an_explicit_cpu():
    assert common.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert common.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            common.resolve_device(None)
