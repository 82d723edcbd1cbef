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

Flash attention and the grouped matmul are held against their Pallas
kernels in interpret mode and their oracles.

Tolerances are the reference's own (tests/test_kernels.py): hist and
sort exact (integer counts; a sort is a permutation), spmv 2e-5 (f32
sums in another order), conv 2e-4 (K^2 f32 products summed in another
order), bilateral 1e-3 (the LUT filter against the direct one, and f32
sums in another order), binned spmv against the dense product 1e-4,
attention 2e-5 in f32 and 0.05 in bf16 (the online softmax against the
unblocked one), gmm 2e-4 in f32 (sums in another order) and 1e-2 in
bf16 (one rounding of the output to bf16, relative 2^-8).
"""
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.host_offload import bilateral_luts as jax_luts
from repro.kernels.bilateral.bilateral import bilateral_pallas
from repro.kernels.bilateral.ref import bilateral_ref as jax_bilateral_ref
from repro.kernels.conv2d.conv2d import conv2d_shift_add as jax_shift_add
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.gmm.gmm import gmm_pallas
from repro.kernels.gmm.ref import gmm_ref as jax_gmm_ref
from repro.kernels.hist.hist import hist_pallas
from repro.kernels.hist.ref import hist_ref as jax_hist_ref
from repro.kernels.spmv import ops as jax_spmv_ops
from repro.kernels.spmv.ref import spmv_coo_ref as jax_coo_ref
from repro.kernels.spmv.ref import spmv_ell_ref as jax_ell_ref
from repro.kernels.sort_bitonic.sort_bitonic import sort_rows_pallas
from repro.kernels.spmv.spmv import spmv_ell_pallas
from repro.workloads import sort as ref_sort
from repro_torch.core import cost_model
from repro_torch.core.cost_model import probe_add_one
from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels import common
from repro_torch.kernels.bilateral import bilateral as bilateral_kernel
from repro_torch.kernels.bilateral import ops as bilateral_ops
from repro_torch.kernels.bilateral.bilateral import (bilateral_cuda,
                                                     bilateral_lut_torch)
from repro_torch.kernels.bilateral.ref import bilateral_ref
from repro_torch.kernels.conv2d import conv2d as conv_kernel
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.conv2d import conv2d_cuda, conv2d_shift_add
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (
    flash_attention as flash_kernel)
from repro_torch.kernels.gmm import gmm as gmm_kernel
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm.gmm import gmm_cuda, gmm_torch
from repro_torch.kernels.gmm.ref import gmm_ref
from repro_torch.kernels.hist import hist as hist_kernel
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.kernels.hist.hist import hist_bincount, hist_cuda
from repro_torch.kernels.hist.ref import hist_ref
from repro_torch.kernels.sort_bitonic import ops as sort_ops
from repro_torch.kernels.sort_bitonic.ref import sort_rows_ref
from repro_torch.kernels.sort_bitonic import sort_bitonic as sort_kernel
from repro_torch.kernels.sort_bitonic.sort_bitonic import (
    bitonic_rows_torch, sort_rows_cuda)
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import spmv as spmv_kernel
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
GMM_IMPLS = {"ref": gmm_ref, "ops": gmm_ops.gmm, "model": gmm_ops.gmm_model,
             "plain": gmm_torch}


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


@pytest.mark.parametrize("impl", sorted(ELL_IMPLS))
@pytest.mark.parametrize("K", [98, 3451])
def test_spmv_ell_offset_view_matches_reference(K, impl):
    """A view one row into its storage ([1:], as the kernel's per-row
    alignment heads must take it) gives the reference's product of the
    same rows."""
    rng = np.random.default_rng(K)
    vals = rng.standard_normal((9, K)).astype(np.float32)
    idx = rng.integers(0, 200, (9, K), dtype=np.int32)
    x = rng.standard_normal(200).astype(np.float32)
    out = ELL_IMPLS[impl](_t(vals)[1:], _t(idx)[1:], _t(x)).numpy()
    ref = jax_ell_ref(jnp.asarray(vals[1:]), jnp.asarray(idx[1:]),
                      jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)


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


# ----------------------------------------------------- flash attention
def _attn_inputs(B, T, S, H, Kv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, T, H, d), (B, S, Kv, d), (B, S, Kv, d)))
    if dtype == "bf16":
        # both sides start from the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _jax_flat(q, k, v, dtype):
    """(B, T, H, d) numpy -> the reference kernel's (B*H, T, d), K/V
    heads repeated as its _flatten_gqa does."""
    B, T, H, d = q.shape
    rep = H // k.shape[2]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    return tuple(jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
        B * H, a.shape[1], d), jd) for a in (q, k, v))


def _from_jax_flat(of, B, H):
    BH, T, d = of.shape
    return np.asarray(of, np.float32).reshape(B, H, T, d).transpose(
        0, 2, 1, 3)


# (B, T, S, H, Kv, d, causal, dtype): the reference test's shapes, d 112
# (kimi-k2) beside 32, GQA, ragged T, T != S, and bf16 at both widths
ATTN_CASES = [
    (2, 128, 128, 4, 4, 32, True, "f32"),
    (2, 100, 100, 4, 2, 112, True, "f32"),
    (2, 128, 128, 8, 1, 32, False, "f32"),
    (1, 77, 77, 4, 2, 112, False, "f32"),
    (2, 64, 96, 4, 2, 32, True, "f32"),
    (1, 96, 40, 4, 4, 32, False, "f32"),
    (1, 128, 128, 4, 2, 64, True, "bf16"),
    (1, 100, 100, 8, 2, 112, True, "bf16"),
]


@pytest.mark.parametrize("B,T,S,H,Kv,d,causal,dtype", ATTN_CASES)
def test_flash_attention_matches_reference(B, T, S, H, Kv, d, causal, dtype):
    """The port's entry on the CPU (the unblocked oracle, K7's plain
    version) against the Pallas kernel in interpret mode and the
    reference's oracle."""
    q, k, v = _attn_inputs(B, T, S, H, Kv, d, dtype, T * d + S + H)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = flash_ops.flash_attention(_t(q).to(td), _t(k).to(td),
                                    _t(v).to(td), causal=causal)
    assert out.dtype == td and out.shape == (B, T, H, d)
    out = out.float().numpy()
    tol = 0.05 if dtype == "bf16" else 2e-5
    qf, kf, vf = _jax_flat(q, k, v, dtype)
    for ref in (flash_attention_pallas(qf, kf, vf, causal=causal,
                                       block_q=64, block_k=64,
                                       interpret=True),
                jax_attn_ref(qf, kf, vf, causal=causal)):
        np.testing.assert_allclose(out, _from_jax_flat(ref, B, H),
                                   rtol=tol, atol=tol)


def test_flash_attention_entries_agree_on_cpu():
    """sdpa, flash_attention with and without use_kernel, and the oracle
    on the flattened heads are one function on the CPU."""
    q, k, v = (_t(a) for a in _attn_inputs(2, 50, 50, 4, 2, 32, "f32", 5))
    out = flash_ops.sdpa(q, k, v, causal=True)
    assert torch.equal(out, flash_ops.flash_attention(q, k, v))
    assert torch.equal(out, flash_ops.flash_attention(q, k, v,
                                                      use_kernel=False))
    flat = attention_ref(*flash_ops._flatten_gqa(q, k, v, repeat=True))
    assert torch.equal(out, flat.reshape(2, 4, 50, 32).transpose(1, 2))


def test_flatten_gqa_keeps_kv_heads():
    """The kernel reads query head h's K/V at h // (H / Kv): flattening
    keeps the Kv heads, and row b*Kv + h // rep is the repeated row
    b*H + h."""
    q, k, v = (_t(a) for a in _attn_inputs(2, 8, 8, 6, 2, 16, "f32", 9))
    _, kf, _ = flash_ops._flatten_gqa(q, k, v)
    _, kr, _ = flash_ops._flatten_gqa(q, k, v, repeat=True)
    assert kf.shape == (4, 8, 16) and kr.shape == (12, 8, 16)
    for b in range(2):
        for h in range(6):
            assert torch.equal(kr[b * 6 + h], kf[b * 2 + h // 3])


# ---------------------------------------------------------------- gmm
@pytest.mark.parametrize("impl", sorted(GMM_IMPLS))
@pytest.mark.parametrize("E,C,D,F,tc,tf,td", [
    (4, 64, 32, 48, 32, 32, 16), (2, 100, 96, 80, 64, 64, 32),
    (8, 128, 128, 128, 128, 128, 128), (3, 1, 40, 24, 8, 8, 8)])
def test_gmm_matches_reference(E, C, D, F, tc, tf, td, impl):
    rng = np.random.default_rng(E * C + D * F)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    out = GMM_IMPLS[impl](_t(x), _t(w))
    assert out.shape == (E, C, F) and out.dtype == torch.float32
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for ref in (gmm_pallas(jx, jw, tile_c=tc, tile_f=tf, tile_d=td,
                           interpret=True), jax_gmm_ref(jx, jw)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)


def test_gmm_bf16_plain_version_matches_reference():
    """bf16 operands: the plain version upcasts to f32 and rounds the
    result once, as the Pallas kernel and the reference's einsum do."""
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((6, 20, 96)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((6, 96, 40)) / 10, jnp.bfloat16)
    out = gmm_torch(_t(np.asarray(x, np.float32)).bfloat16(),
                    _t(np.asarray(w, np.float32)).bfloat16())
    assert out.dtype == torch.bfloat16
    for ref in (gmm_pallas(x, w, tile_c=8, tile_f=8, tile_d=32,
                           interpret=True), jax_gmm_ref(x, w)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=1e-2,
                                   atol=1e-2)


# -------------------------------------------------------------- probe
def test_probe_add_one_cpu():
    t = _t(np.random.default_rng(5).standard_normal((128, 128)).astype(
        np.float32))
    assert torch.equal(probe_add_one(t), t + 1.0)


# ------------------------------------------- dispatch and the library
@pytest.mark.parametrize("call", ["conv2d", "hist", "spmv_ell",
                                  "sort_bitonic", "bilateral",
                                  "flash_attention", "gmm"])
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
        elif call == "flash_attention":
            flash_attention_cuda(x[None], x[None], x[None])
        elif call == "gmm":
            gmm_cuda(x[None], x[None])
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
    "flash_attention": lambda: flash_ops.flash_attention(
        torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 1, 16)),
        torch.zeros((1, 8, 1, 16)), config=_OTHER_CONFIG),
    "gmm": lambda: gmm_ops.gmm(torch.zeros((2, 4, 8)),
                               torch.zeros((2, 8, 4)),
                               config=_OTHER_CONFIG),
}


@pytest.mark.parametrize("call", sorted(OPS_CALLS))
def test_ops_refuse_other_configs(call):
    """A config naming an implementation the port does not have (the
    reference's Pallas kernels) raises: it is never re-routed."""
    with pytest.raises(ValueError):
        OPS_CALLS[call]()


# --------------------------------------------- the K7 and K8 routes
@pytest.mark.parametrize("dtype,d,aligned,entry", [
    (torch.bfloat16, 112, True, "flash_attention_wgmma_bf16"),
    (torch.bfloat16, 32, True, "flash_attention_wgmma_bf16"),
    (torch.bfloat16, 64, True, "flash_attention_wgmma_bf16"),
    (torch.bfloat16, 80, True, "flash_attention_wgmma_bf16"),
    (torch.bfloat16, 128, True, "flash_attention_wgmma_bf16"),
    (torch.bfloat16, 8, True, "flash_attention_wgmma_bf16"),
    (torch.bfloat16, 36, True, "flash_attention_fma_bf16"),
    (torch.bfloat16, 136, True, "flash_attention_fma_bf16"),
    (torch.bfloat16, 256, True, "flash_attention_fma_bf16"),
    (torch.bfloat16, 112, False, "flash_attention_fma_bf16"),
    (torch.float32, 112, True, "flash_attention_fma_f32"),
    (torch.float32, 64, True, "flash_attention_fma_f32")])
def test_flash_attention_route(dtype, d, aligned, entry):
    """bf16 with 16-byte rows, d <= 128 and aligned bases goes to the
    tensor cores; f32 (TF32 would break its 2e-5) and every other shape
    to the CUDA cores."""
    assert flash_kernel.route(dtype, d, aligned) == entry
    assert entry in common.ENTRY_LAUNCHES


@pytest.mark.parametrize("dtype,D,F,aligned,entry", [
    (torch.bfloat16, 7168, 2048, True, "gmm_wgmma_bf16"),
    (torch.bfloat16, 2048, 7168, True, "gmm_wgmma_bf16"),
    (torch.bfloat16, 8, 24, True, "gmm_wgmma_bf16"),
    (torch.bfloat16, 33, 136, True, "gmm_fma_bf16"),
    (torch.bfloat16, 32, 130, True, "gmm_fma_bf16"),
    (torch.bfloat16, 7168, 2048, False, "gmm_fma_bf16"),
    (torch.float32, 7168, 2048, True, "gmm_fma_f32"),
    (torch.float32, 33, 11, True, "gmm_fma_f32")])
def test_gmm_route(dtype, D, F, aligned, entry):
    assert gmm_kernel.route(dtype, D, F, aligned) == entry
    assert entry in common.ENTRY_LAUNCHES


@pytest.mark.parametrize("route", [flash_kernel.route,
                                   lambda dt, d, a: gmm_kernel.route(
                                       dt, d, d, a)])
def test_routes_refuse_other_dtypes(route):
    with pytest.raises(ValueError, match="not supported"):
        route(torch.float16, 64, True)


# ------------------------------------------------ the K5 and K6 routes
@pytest.mark.parametrize("K,n_levels,entry", [
    (15, 256, "bilateral_reg_f32"), (1, 256, "bilateral_reg_f32"),
    (3, 256, "bilateral_reg_f32"), (5, 256, "bilateral_reg_f32"),
    (7, 256, "bilateral_reg_f32"), (9, 256, "bilateral_reg_f32"),
    (11, 256, "bilateral_reg_f32"), (13, 256, "bilateral_reg_f32"),
    (15, 1, "bilateral_reg_f32"), (3, 100, "bilateral_reg_f32"),
    (17, 256, "bilateral_f32"), (19, 256, "bilateral_f32"),
    (15, 257, "bilateral_f32"), (3, 1000, "bilateral_f32")])
def test_bilateral_route(K, n_levels, entry):
    """Odd K up to 15 (radius 1-7, every radius the workloads use) with
    at most 256 levels take the register-blocked kernel; larger K or
    level counts keep the first version."""
    assert bilateral_kernel.route(K, n_levels) == entry
    assert entry in common.ENTRY_LAUNCHES


@pytest.mark.parametrize("K", [1, 3, 5, 7, 9, 11, 13, 15])
def test_bilateral_register_route_fits_static_shared_memory(K):
    """The register route's block (halo window, spatial LUT and 32
    copies of 256 levels) stays under the 48 KB a launch gets without
    an opt-in, and above the first version's (the replicated table)."""
    reg = bilateral_kernel.smem_bytes(bilateral_kernel.REG_ENTRY, K, 256)
    tiled = bilateral_kernel.smem_bytes(bilateral_kernel.TILED_ENTRY, K, 256)
    assert reg <= 48 * 1024
    assert reg - 4 * (64 + K - 1) * (16 + K - 1) - 4 * K * K == 32 * 256 * 4
    assert tiled < reg


def test_new_k5_k6_entries_are_bound():
    """The entry tally names the register-route entries of K5 and K6 and
    K6's first version; K5's first version is gone."""
    entries = common.entry_counts()
    for name in (sort_kernel.ENTRY, bilateral_kernel.REG_ENTRY,
                 bilateral_kernel.TILED_ENTRY,
                 "bilateral_level_index_check"):
        assert name in entries and name in common._SIGNATURES
    assert sort_kernel.ENTRY == "sort_rows_reg_f32"
    assert "sort_rows_f32" not in entries


# ------------------------------------------------ the K3 and K4 routes
@pytest.mark.parametrize("K,tpr", [
    (0, 32), (1, 32), (4, 32), (68, 32), (98, 32), (512, 32), (513, 64),
    (1024, 64), (1025, 128), (2048, 128), (2049, 256), (3451, 256),
    (100_000, 256)])
def test_spmv_route(K, tpr):
    """Every K takes the segmented-row entry; threads a row grow with K:
    the main path's light tiles (K = 68-98) take 32, its heavy tile
    (K = 3451) the widest, 256."""
    assert spmv_kernel.route(K) == ("spmv_ell_seg_f32", tpr)
    assert tpr in spmv_kernel.TPRS and spmv_kernel.THREADS % tpr == 0


@pytest.mark.parametrize("R,K,blocks", [(512, 3451, 512), (512, 98, 64),
                                        (512, 68, 64), (1, 3451, 1),
                                        (33, 98, 5), (512, 1024, 128)])
def test_spmv_blocks_at_the_main_path_tiles(R, K, blocks):
    """The heavy tile fills the card (512 blocks, ~3.9 an SM of 132);
    the light tiles take 8 rows a block."""
    assert spmv_kernel.blocks(R, spmv_kernel.route(K)[1]) == blocks


@pytest.mark.parametrize("vals_ptr,idx_ptr,vector", [
    (0, 0, True), (4096, 512, True), (4, 20, True), (12, 8188, True),
    (4, 0, False), (0, 8, False), (4100, 4096, False),
    # a row of K = 3451 from storage offsets 1 (vals) and 0 (idx)
    (4 + 4 * 3451, 4 * 3451, False)])
def test_spmv_vector_loads_needs_one_16_byte_phase(vals_ptr, idx_ptr,
                                                   vector):
    """16-byte loads of both streams need vals and idx in the same
    16-byte phase (each row then has one head); otherwise the scalar
    instantiation runs, decided from the two addresses alone."""
    assert spmv_kernel.vector_loads(vals_ptr, idx_ptr) is vector


def test_spmv_vector_loads_on_views():
    """Views one row into both tensors keep a common phase; vals one
    float off idx's does not."""
    vals = torch.zeros(1 + 65 * 98)
    idx = torch.zeros((65, 98), dtype=torch.int32)
    v = vals[:65 * 98].view(65, 98)
    assert spmv_kernel.vector_loads(v[1:].data_ptr(), idx[1:].data_ptr())
    off = vals[1:].view(65, 98)
    assert not spmv_kernel.vector_loads(off.data_ptr(), idx.data_ptr())


def test_new_k3_k4_entries_are_bound():
    """The entry tally names both K3 entries, both K4 entries and the
    launch floor's empty kernel; the segmented-row entry also takes
    threads a row and the vector flag, and the probe launches its
    one-block entry."""
    entries = common.entry_counts()
    for name in ("spmv_ell_seg_f32", "spmv_ell_f32", "probe_add_one_f32",
                 "probe_add_one_vec_f32", "launch_floor_noop"):
        assert name in entries and name in common._SIGNATURES
    assert common._SIGNATURES["spmv_ell_seg_f32"][7:9] == [ctypes.c_int,
                                                           ctypes.c_int]
    assert common._SIGNATURES["launch_floor_noop"] == [ctypes.c_void_p]
    assert cost_model.PROBE_ENTRY == "probe_add_one_vec_f32"
    assert (spmv_kernel.SEG_ENTRY, spmv_kernel.WARP_ENTRY) == (
        "spmv_ell_seg_f32", "spmv_ell_f32")
    assert spmv_ops.DEFAULT_CONFIG == {"impl": "cuda", "layout": "seg_rows"}


# ------------------------------------------------ the K1 and K2 routes
@pytest.mark.parametrize("K,entry", [
    (1, "conv2d_reg_f32"), (3, "conv2d_reg_f32"), (5, "conv2d_reg_f32"),
    (7, "conv2d_reg_f32"), (9, "conv2d_reg_f32"), (11, "conv2d_reg_f32"),
    (13, "conv2d_reg_f32"), (15, "conv2d_reg_f32"), (17, "conv2d_f32"),
    (19, "conv2d_f32"), (31, "conv2d_f32")])
def test_conv2d_route(K, entry):
    """Odd K up to 15 (one template instantiation each) take the
    register-blocked kernel; larger K keep the first version."""
    assert conv_kernel.route(K) == entry
    assert entry in common.ENTRY_LAUNCHES


@pytest.mark.parametrize("K", [1, 3, 5, 7, 9, 11, 13, 15])
def test_conv2d_register_route_fits_shared_memory(K):
    """The register route's block (a (32+K-1) x 144 halo window and the
    filter, rows padded to 4) stays within 227 KB, and within the 48 KB
    a launch gets without an opt-in, which its C entry never asks for."""
    smem = conv_kernel.smem_bytes(conv_kernel.REG_ENTRY, K)
    kp = (K + 3) // 4 * 4
    assert smem == 4 * ((32 + K - 1) * 144 + K * kp)
    assert smem <= 48 * 1024 <= 227 * 1024


@pytest.mark.parametrize("bins,entry", [
    (1, "hist_priv_i32"), (64, "hist_priv_i32"), (256, "hist_priv_i32"),
    (384, "hist_priv_i32"), (385, "hist_priv_i32"),
    (1816, "hist_priv_i32"), (1817, "hist_i32"), (4096, "hist_i32"),
    (12288, "hist_i32")])
def test_hist_route(bins, entry):
    """Both main-path shapes (256 bins, 64 in sort's binning) and every
    count whose 32 replicas fit a block take the bank-private kernel;
    more bins keep the first version."""
    assert hist_kernel.route(bins) == entry
    assert entry in common.ENTRY_LAUNCHES


def test_hist_private_route_fits_shared_memory_to_its_boundary():
    """1816 bins x 32 int replicas is exactly the 227 KB (232,448 B) a
    block may opt in to; one bin more would not fit, and the first
    version holds 12288 bins in 48 KB."""
    assert hist_kernel.PRIV_MAX_BINS == 1816
    smem = hist_kernel.smem_bytes(hist_kernel.PRIV_ENTRY, 1816)
    assert smem == 232448 == 227 * 1024
    assert hist_kernel.smem_bytes(hist_kernel.PRIV_ENTRY, 1817) > 227 * 1024
    assert hist_kernel.smem_bytes(hist_kernel.PRIV_ENTRY, 256) == 32 * 1024
    assert hist_kernel.smem_bytes(hist_kernel.SHARED_ENTRY, 12288) \
        == 48 * 1024


@pytest.mark.parametrize("H,W,K,tiles,window", [
    # the main chunk on the register route: 8 x 29 tiles of 32 x 128,
    # each reading a (32+14) x 144 window and the 225 filter taps
    (239, 3600, 15, 8 * 29, 46 * 144),
    # K = 17 on the first version: 30 x 113 tiles of 8 x 32, windows of
    # (8+16) x (32+16)
    (239, 3600, 17, 30 * 113, 24 * 48)])
def test_conv2d_cost_terms_by_hand(H, W, K, tiles, window):
    ct = conv_ops.cost_terms(conv_ops.DEFAULT_CONFIG, H, W, K)
    assert ct.flops == 2.0 * H * W * K * K
    assert ct.bytes == 4.0 * (tiles * (window + K * K) + H * W)
    assert ct.steps == 1
    assert conv_ops.DEFAULT_CONFIG == {"impl": "cuda", "tile_h": 32,
                                       "tile_w": 128}


def test_new_k1_k2_entries_are_bound():
    """The entry tally names both routes of K1 and of K2."""
    entries = common.entry_counts()
    for name in (conv_kernel.REG_ENTRY, conv_kernel.TILED_ENTRY,
                 hist_kernel.PRIV_ENTRY, hist_kernel.SHARED_ENTRY):
        assert name in entries and name in common._SIGNATURES
    # hist_priv_i32 also takes its stream's launch-number buffer and this
    # launch's number (an unsigned 64-bit value)
    assert common._SIGNATURES["hist_priv_i32"][5:7] == [ctypes.c_void_p,
                                                        ctypes.c_ulonglong]


def test_launch_counts_reset_with_entry_counts():
    """Nothing launches on the CPU; a reset zeroes both tallies and the
    entry tally names every C entry point the library binds."""
    common.reset_launches()
    assert set(common.entry_counts()) == set(common._SIGNATURES)
    assert not any(common.entry_counts().values())
    assert not any(common.launch_counts().values())


def test_build_digest_covers_shared_headers(monkeypatch, tmp_path):
    """An edited csrc/*.cuh (the tensor-core kernels' shared helpers)
    changes the build key, so the library is rebuilt."""
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(common, "CSRC_DIR", str(tmp_path))
    srcs = common._sources()
    assert [os.path.basename(s) for s in srcs] == ["a.cu", "b.cu"]
    before = common._digest(srcs)
    assert common._digest(srcs) == before
    header.write_text("// v2\n")
    assert common._digest(srcs) != before
    (tmp_path / "b.cu").write_text("// b, edited\n")
    assert common._digest(srcs) != before


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
