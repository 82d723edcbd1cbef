"""The hand-written CUDA kernels on the card, against their plain
PyTorch versions (``ref.py`` or the CPU peer run on the GPU).

Every test here is marked ``needs_cuda`` and skips, with its reason,
where there is no CUDA GPU.  The file imports no JAX, so it runs on a
GPU host that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances as in the kernel tests: hist, sort and the probe exact,
spmv 2e-5, conv 2e-4 (f32 sums in another order), bilateral 1e-3,
attention and gmm 2e-5 and 2e-4 in f32 and 1e-2 in bf16 (one rounding
of the output, a few ulp at |out| <= 1).

The plain versions the kernels are held against: ``conv2d_shift_add``
(K1), ``hist_ref`` (K2), ``spmv_ell_ref`` (K3), ``t + 1`` (K4),
``bitonic_rows_torch`` (K5), ``bilateral_lut_torch`` (K6),
``flash_attention.ref.attention_ref`` (K7, the unblocked f32 softmax)
and ``gmm.gmm.gmm_torch`` (K8, f32 products of the upcast operands).
The LM's greedy tokens are held against the same model run with K7 and
K8 swapped for those two (``serve.plain_check``).
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import probe_add_one
from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels import autotune as at
from repro_torch.kernels import common
from repro_torch.kernels.bilateral import bilateral as bilateral_kernel
from repro_torch.kernels.bilateral import ops as bilateral_ops
from repro_torch.kernels.bilateral.bilateral import (bilateral_cuda,
                                                     bilateral_lut_torch)
from repro_torch.kernels.conv2d import conv2d as conv_kernel
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.conv2d import conv2d_cuda, conv2d_shift_add
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.flash_attention import (
    route as flash_route)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm.gmm import gmm_cuda, gmm_torch
from repro_torch.kernels.gmm.gmm import route as gmm_route
from repro_torch.kernels.hist import hist as hist_kernel
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.kernels.hist.hist import hist_cuda
from repro_torch.kernels.hist.ref import hist_ref
from repro_torch.kernels.sort_bitonic import ops as sort_ops
from repro_torch.kernels.sort_bitonic.sort_bitonic import (
    bitonic_rows_torch, sort_rows_cuda)
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import spmv as spmv_kernel
from repro_torch.kernels.spmv.ref import spmv_ell_ref
from repro_torch.kernels.spmv.spmv import spmv_ell_cuda
from repro_torch.serve.plain_check import (check_tokens, greedy_with_gaps,
                                           plain_kernels)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run chip_smoke.py on one")
    common.kernel_lib()
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("H,W,K", [(64, 48, 3), (130, 96, 5), (50, 64, 15)])
def test_conv2d_kernel_on_gpu(gpu, H, W, K):
    rng = np.random.default_rng(H * W + K)
    img = _t(rng.standard_normal((H, W)).astype(np.float32)).to(gpu)
    w = _t(rng.standard_normal((K, K)).astype(np.float32)).to(gpu)
    torch.testing.assert_close(conv2d_cuda(img, w),
                               conv2d_shift_add(img, w),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n,bins", [(1000, 16), (4099, 7), (257, 4096)])
def test_hist_kernel_on_gpu(gpu, n, bins):
    x = _t(np.random.default_rng(n).integers(-2, bins + 2, n,
                                             dtype=np.int32)).to(gpu)
    assert torch.equal(hist_cuda(x, bins), hist_ref(x, bins))
    assert torch.equal(hist_cuda(x[1:], bins), hist_ref(x[1:], bins))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("R,C,K", [(100, 80, 8), (1000, 777, 37)])
def test_spmv_ell_kernel_on_gpu(gpu, R, C, K):
    rng = np.random.default_rng(R + C + K)
    vals = _t(rng.standard_normal((R, K)).astype(np.float32)).to(gpu)
    idx = _t(rng.integers(0, C, (R, K), dtype=np.int32)).to(gpu)
    x = _t(rng.standard_normal(C).astype(np.float32)).to(gpu)
    torch.testing.assert_close(spmv_ell_cuda(vals, idx, x),
                               spmv_ell_ref(vals, idx, x),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("G,L", [(10, 16), (70, 64), (33, 256), (1, 2),
                                 (5, 8192), (300, 1024)])
def test_sort_bitonic_kernel_on_gpu(gpu, G, L):
    x = np.random.default_rng(G * L).standard_normal((G, L)).astype(
        np.float32)
    x[0, :L // 2] = np.inf
    if G > 2:
        x[1, ::2], x[1, 1::2] = -0.0, 0.0
        x[2] = np.round(x[2])
    x = _t(x).to(gpu)
    out = sort_rows_cuda(x)
    assert torch.equal(out, bitonic_rows_torch(x))
    assert torch.equal(out, torch.sort(x, dim=1).values)


@pytest.mark.needs_cuda
def test_sort_bitonic_kernel_refuses_what_it_cannot_sort(gpu):
    with pytest.raises(ValueError, match="power of two"):
        sort_rows_cuda(torch.zeros((4, 12), device=gpu))
    with pytest.raises(ValueError, match="exceeds"):
        sort_rows_cuda(torch.zeros((1, 16384), device=gpu))
    with pytest.raises(ValueError, match="contiguous"):
        sort_rows_cuda(torch.zeros((16, 8), device=gpu).t())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("H,W,radius", [(64, 48, 2), (37, 53, 3),
                                        (1, 101, 7), (50, 33, 1)])
def test_bilateral_kernel_on_gpu(gpu, H, W, radius):
    img = _t((np.random.default_rng(H * W).random((H, W)) * 255).astype(
        np.float32)).to(gpu)
    sp, rl = (_t(a).to(gpu) for a in bilateral_luts(2.0, 25.0, radius))
    torch.testing.assert_close(bilateral_cuda(img, sp, rl),
                               bilateral_lut_torch(img, sp, rl),
                               rtol=1e-3, atol=1e-3)


def _sort_rows_of_every_kind(G, L, seed):
    """(G, L) rows: random, already sorted, reversed, all equal, +-inf
    with duplicates, -0.0 beside 0.0, and +inf padding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, L)).astype(np.float32)
    x[1] = np.sort(x[1])
    x[2] = np.sort(x[2])[::-1]
    x[3] = 0.75
    x[4] = np.round(x[4])
    x[4, ::3] = np.inf
    x[4, 1::5] = -np.inf
    x[5, ::2], x[5, 1::2] = -0.0, 0.0
    x[6, L // 2:] = np.inf
    x[7] = np.where(rng.random(L) < 0.5, -0.0, 0.0)
    return x


@pytest.mark.needs_cuda
@pytest.mark.parametrize("L", [1 << p for p in range(1, 14)])
def test_sort_bitonic_register_kernel_on_gpu(gpu, L):
    """Every power-of-two row length on the register/shuffle kernel, G
    not a multiple of the rows a block takes (1024 // L, or 1): bitwise
    the plain network (signed zeros in its order) and == torch.sort."""
    G = max(1024 // L, 1) * 3 + 5
    x = _t(_sort_rows_of_every_kind(G, L, L)).to(gpu)
    common.reset_launches()
    out = sort_rows_cuda(x)
    counts = common.entry_counts()
    assert counts["sort_rows_reg_f32"] == 1 and sum(counts.values()) == 1
    assert torch.equal(out.view(torch.int32),
                       bitonic_rows_torch(x).view(torch.int32))
    assert torch.equal(out, torch.sort(x, dim=1).values)


@pytest.mark.needs_cuda
def test_sort_bitonic_register_kernel_off_16_byte_alignment(gpu):
    """A view that starts one float into its storage takes the kernel's
    scalar loads and stores."""
    x = _t(_sort_rows_of_every_kind(9, 256, 3).reshape(-1)).to(gpu)
    flat = torch.cat([torch.zeros(1, device=gpu), x])
    rows = flat[1:].view(9, 256)
    assert rows.data_ptr() % 16
    out = sort_rows_cuda(rows)
    assert torch.equal(out.view(torch.int32),
                       bitonic_rows_torch(rows).view(torch.int32))


def _conv_first_version(img, w):
    """PR 11's kernel (``conv2d_f32``) on any K, launched directly."""
    out = torch.empty_like(img)
    common.launch("conv2d", "conv2d_f32", img.device, img.data_ptr(),
                  w.data_ptr(), out.data_ptr(), img.shape[0], img.shape[1],
                  w.shape[0])
    return out


def _conv_route_case(img, w):
    """One call of the wrapper: the route's C entry launched once, and
    the output bitwise the first version's and the plain shift-add's."""
    entry = conv_kernel.route(w.shape[0])
    common.reset_launches()
    out = conv2d_cuda(img, w)
    counts = common.entry_counts()
    assert counts[entry] == 1 and sum(counts.values()) == 1
    assert torch.equal(out, conv2d_shift_add(img, w))
    assert torch.equal(out, _conv_first_version(img, w))
    return entry


# (H, W): W % 4 != 0, H under a block's 32 rows, 1x5, a tile edge
CONV_ROUTE_SHAPES = [(37, 101), (20, 130), (1, 5), (70, 256)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("K", [1, 3, 5, 7, 9, 11, 13, 15, 17])
@pytest.mark.parametrize("H,W", CONV_ROUTE_SHAPES)
def test_conv2d_routes_on_gpu(gpu, H, W, K):
    """Every odd K up to 15 on the register route, 17 on the first
    version: bitwise the first version and the plain shift-add."""
    rng = np.random.default_rng(H * W + K)
    img = _t(rng.standard_normal((H, W)).astype(np.float32)).to(gpu)
    w = _t(rng.standard_normal((K, K)).astype(np.float32)).to(gpu)
    entry = _conv_route_case(img, w)
    assert entry == ("conv2d_reg_f32" if K <= 15 else "conv2d_f32")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("K", [3, 15])
def test_conv2d_register_route_off_16_byte_alignment(gpu, K):
    """A row slice of a W % 4 != 0 image (what ``conv_rows`` passes) and
    a W % 4 == 0 view one float into its storage take the scalar
    staging path, with no copy."""
    rng = np.random.default_rng(K)
    big = _t(rng.standard_normal((43, 101)).astype(np.float32)).to(gpu)
    w = _t(rng.standard_normal((K, K)).astype(np.float32)).to(gpu)
    rows = big[3:40]
    assert rows.data_ptr() % 16
    assert _conv_route_case(rows, w) == "conv2d_reg_f32"
    flat = _t(rng.standard_normal(1 + 30 * 128).astype(np.float32)).to(gpu)
    view = flat[1:].view(30, 128)
    assert view.data_ptr() % 16
    assert _conv_route_case(view, w) == "conv2d_reg_f32"


@pytest.mark.needs_cuda
def test_conv2d_register_route_at_the_main_chunk(gpu):
    """239 x 3600, K = 15 (one of conv's 16 chunks with its halo)."""
    rng = np.random.default_rng(239)
    img = _t(rng.standard_normal((239, 3600)).astype(np.float32)).to(gpu)
    w = _t(rng.standard_normal((15, 15)).astype(np.float32)).to(gpu)
    assert _conv_route_case(img, w) == "conv2d_reg_f32"


def _hist_route_case(x, bins):
    entry = hist_kernel.route(bins)
    common.reset_launches()
    out = hist_cuda(x, bins)
    counts = common.entry_counts()
    assert counts[entry] == 1 and sum(counts.values()) == 1
    assert torch.equal(out, hist_ref(x, bins))
    return entry


@pytest.mark.needs_cuda
@pytest.mark.parametrize("bins", [1, 7, 64, 256, 1816, 1817])
@pytest.mark.parametrize("n", [1000, (1 << 20) + 7])
def test_hist_routes_on_gpu(gpu, n, bins):
    """Up to 1816 bins on the bank-private route (1817 on the first
    version): keys out of range on both sides, an offset slice, and all
    keys in one bin, exact against hist_ref."""
    x = _t(np.random.default_rng(n + bins).integers(
        -3, bins + 3, n, dtype=np.int32)).to(gpu)
    entry = _hist_route_case(x, bins)
    assert entry == ("hist_priv_i32" if bins <= 1816 else "hist_i32")
    assert _hist_route_case(x[1:], bins) == entry
    same = torch.full((n,), bins - 1, dtype=torch.int32, device=gpu)
    assert _hist_route_case(same, bins) == entry
    assert _hist_route_case(same[3:], bins) == entry


@pytest.mark.needs_cuda
def test_hist_private_route_on_two_streams(gpu):
    """Launches in flight on two streams keep apart (each stream has its
    own launch numbers), and back-to-back launches on one stream, one
    block or a full grid, each zero their own output."""
    rng = np.random.default_rng(21)
    xs = [_t(rng.integers(0, 256, n + i, dtype=np.int32)).to(gpu)
          for i, n in enumerate([1 << 22, 1000, 1 << 22, 1 << 16, 77,
                                 1 << 21, 5000, 1 << 22])]
    streams = [torch.cuda.Stream(gpu) for _ in range(2)]
    torch.cuda.synchronize(gpu)
    outs = []
    for i, x in enumerate(xs):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(hist_cuda(x, 256))
    torch.cuda.synchronize(gpu)
    for x, out in zip(xs, outs):
        assert torch.equal(out, hist_ref(x, 256))


# (H, W, radius): ragged H and W, a 1-row image, odd W; radius 1-7 on the
# register route, 9 (K = 19) on the first version
BILAT_ROUTE_CASES = [(37, 101, 1), (50, 33, 2), (129, 77, 3), (1, 301, 4),
                     (65, 31, 5), (9, 15, 6), (239, 97, 7), (70, 45, 9)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("H,W,radius", BILAT_ROUTE_CASES)
def test_bilateral_routes_on_gpu(gpu, H, W, radius):
    """Max error 0 against the plain LUT filter on either route."""
    img = _t((np.random.default_rng(H * W + radius).random((H, W)) * 255)
             .astype(np.float32)).to(gpu)
    sp, rl = (_t(a).to(gpu) for a in bilateral_luts(3.0, 30.0, radius))
    entry = bilateral_kernel.route(2 * radius + 1, rl.numel())
    assert entry == ("bilateral_reg_f32" if radius <= 7 else "bilateral_f32")
    common.reset_launches()
    out = bilateral_cuda(img, sp, rl)
    counts = common.entry_counts()
    assert counts[entry] == 1 and sum(counts.values()) == 1
    assert torch.equal(out, bilateral_lut_torch(img, sp, rl))


@pytest.mark.needs_cuda
def test_bilateral_first_version_past_256_levels(gpu):
    """A 300-level range LUT keeps the first version."""
    rng = np.random.default_rng(11)
    img = _t((rng.random((40, 70)) * 299).astype(np.float32)).to(gpu)
    sp, _ = bilateral_luts(2.0, 25.0, 2)
    sp = _t(sp).to(gpu)
    rl = _t(np.exp(-np.arange(300) / 90.0).astype(np.float32)).to(gpu)
    common.reset_launches()
    out = bilateral_cuda(img, sp, rl)
    assert common.entry_counts()["bilateral_f32"] == 1
    assert torch.equal(out, bilateral_lut_torch(img, sp, rl))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n_levels", [256, 1, 100])
def test_bilateral_level_index_matches_int_truncation(gpu, n_levels):
    """The register route's level index (an add rounded toward zero and
    one min, no F2I) equals (int)|t| clamped to [0, n_levels - 1] for
    every f32 bit pattern but the NaNs: [0, 256) and everything above,
    both signs."""
    assert bilateral_kernel.level_index_mismatches(
        0, 1 << 32, n_levels, gpu) == 0


# (BH, BHkv, T, S, d, causal): d 32/80/112/128, GQA groups of 1, 2 and
# 8, ragged T, T != S both ways, one query tile and many
ATTN_CASES = [(8, 8, 128, 128, 32, True), (8, 4, 100, 100, 80, True),
              (16, 2, 77, 77, 112, False), (4, 1, 200, 130, 128, True),
              (6, 3, 50, 190, 112, False), (64, 8, 256, 256, 112, True),
              (2, 2, 1, 9, 32, True), (3, 3, 65, 65, 128, False)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("BH,BHkv,T,S,d,causal", ATTN_CASES)
def test_flash_attention_kernel_on_gpu(gpu, BH, BHkv, T, S, d, causal,
                                       dtype):
    rng = np.random.default_rng(BH * T + S * d)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (_t(rng.standard_normal(shape).astype(np.float32)).to(
        gpu, td) for shape in ((BH, T, d), (BHkv, S, d), (BHkv, S, d)))
    out = flash_attention_cuda(q, k, v, causal)
    assert out.dtype == td and out.shape == (BH, T, d)
    rep = BH // BHkv
    ref = attention_ref(q, k.repeat_interleave(rep, 0),
                        v.repeat_interleave(rep, 0), causal)
    tol = 1e-2 if dtype == "bf16" else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", [(4, 64, 32, 48), (2, 100, 96, 80),
                                     (3, 1, 40, 24), (5, 7, 33, 130),
                                     (2, 200, 64, 72), (384, 4, 256, 128),
                                     (6, 13, 100, 11)])
def test_gmm_kernel_on_gpu(gpu, E, C, D, F, dtype):
    rng = np.random.default_rng(E * C + D * F)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = _t(rng.standard_normal((E, C, D)).astype(np.float32)).to(gpu, td)
    w = _t((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
        np.float32)).to(gpu, td)
    out = gmm_cuda(x, w)
    assert out.dtype == td and out.shape == (E, C, F)
    tol = 1e-2 if dtype == "bf16" else 2e-4
    torch.testing.assert_close(out.float(), gmm_torch(x, w).float(),
                               rtol=tol, atol=tol)


# bf16 cases by route: (BH, BHkv, T, S, d, causal, entry).  The
# tensor-core kernel takes d % 8 == 0 up to 128: d 32/64/80/112/128,
# GQA groups of 1, 2 and 8, T and S off the 64-row tiles, T != S both
# ways, T = 1, causal and not, one query tile and many; d 36 (rows not
# 16-byte multiples) and 256 (past its accumulator) go to the CUDA cores
WGMMA_ATTN = "flash_attention_wgmma_bf16"
ATTN_ROUTE_CASES = [
    (4, 4, 64, 64, 64, True, WGMMA_ATTN), (8, 4, 100, 100, 80, True, WGMMA_ATTN),
    (16, 2, 77, 130, 112, False, WGMMA_ATTN), (8, 1, 200, 130, 128, True, WGMMA_ATTN),
    (6, 3, 50, 190, 32, True, WGMMA_ATTN), (16, 2, 1, 70, 112, True, WGMMA_ATTN),
    (2, 2, 1, 1, 64, False, WGMMA_ATTN), (64, 8, 333, 333, 112, True, WGMMA_ATTN),
    (4, 2, 130, 63, 128, False, WGMMA_ATTN), (3, 3, 65, 200, 80, True, WGMMA_ATTN),
    (4, 2, 70, 70, 36, True, "flash_attention_fma_bf16"),
    (2, 1, 65, 65, 256, False, "flash_attention_fma_bf16")]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("BH,BHkv,T,S,d,causal,entry", ATTN_ROUTE_CASES)
def test_flash_attention_bf16_routes_on_gpu(gpu, BH, BHkv, T, S, d, causal,
                                            entry):
    rng = np.random.default_rng(BH * T + S * d + 1)
    q, k, v = (_t(rng.standard_normal(shape).astype(np.float32)).to(
        gpu, torch.bfloat16)
        for shape in ((BH, T, d), (BHkv, S, d), (BHkv, S, d)))
    common.reset_launches()
    out = flash_attention_cuda(q, k, v, causal)
    counts = common.entry_counts()
    assert counts[entry] == 1 and sum(counts.values()) == 1
    assert out.dtype == torch.bfloat16 and out.shape == (BH, T, d)
    rep = BH // BHkv
    ref = attention_ref(q, k.repeat_interleave(rep, 0),
                        v.repeat_interleave(rep, 0), causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


# (E, C, D, F, entry): C 1/4/7/13/24/104/200 (token tiles N of 8, 16,
# 32, 64 and 128, and a second tile of C), D and F multiples of 8 off
# the 64-row contraction step and the 128-column tile, E up to 384;
# D 33 or F 130 (not multiples of 8) go to the CUDA cores
WGMMA_GMM = "gmm_wgmma_bf16"
GMM_ROUTE_CASES = [
    (3, 1, 40, 24, WGMMA_GMM), (384, 4, 136, 72, WGMMA_GMM),
    (5, 7, 200, 136, WGMMA_GMM), (6, 13, 88, 264, WGMMA_GMM),
    (4, 24, 520, 136, WGMMA_GMM), (3, 104, 328, 200, WGMMA_GMM),
    (2, 200, 72, 392, WGMMA_GMM), (2, 40, 64, 128, WGMMA_GMM),
    (2, 70, 8, 8, WGMMA_GMM),
    (5, 7, 33, 136, "gmm_fma_bf16"), (5, 7, 32, 130, "gmm_fma_bf16")]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("E,C,D,F,entry", GMM_ROUTE_CASES)
def test_gmm_bf16_routes_on_gpu(gpu, E, C, D, F, entry):
    rng = np.random.default_rng(E * C + D * F + 1)
    x = _t(rng.standard_normal((E, C, D)).astype(np.float32)).to(
        gpu, torch.bfloat16)
    w = _t((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
        np.float32)).to(gpu, torch.bfloat16)
    common.reset_launches()
    out = gmm_cuda(x, w)
    counts = common.entry_counts()
    assert counts[entry] == 1 and sum(counts.values()) == 1
    assert out.dtype == torch.bfloat16 and out.shape == (E, C, F)
    torch.testing.assert_close(out.float(), gmm_torch(x, w).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.needs_cuda
def test_lm_kernels_refuse_inputs_that_require_grad(gpu):
    """No backward yet: nothing quietly differentiates through them."""
    q = torch.randn((2, 8, 16), device=gpu, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention_cuda(q, q.detach(), q.detach())
    x = torch.randn((2, 4, 8), device=gpu)
    w = torch.randn((2, 8, 4), device=gpu, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        gmm_cuda(x, w)


@pytest.mark.needs_cuda
def test_lm_greedy_tokens_kernel_path_against_plain_path(gpu):
    """kimi-k2 at reduced width and depth 2 (the dense layer and one MoE
    layer): ``generate`` through K7 and K8 gives the plain path's
    tokens, except where the plain path's top-1/top-2 gap is under the
    bf16 model tolerance 0.25 (the row is compared no further)."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import generate

    cfg = registry.get("kimi-k2-1t-a32b").reduced().replace(n_layers=2)
    params = model_zoo.init(cfg, 0, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=gpu,
                           generator=gen)
    common.reset_launches()
    out = generate(cfg, params, prompt, 8)
    counts = common.launch_counts()
    # K7: 2 attention layers at prefill; K8: 3 matmuls x (capacity pass
    # + one tail pass) in the MoE layer, at prefill and each of 8 steps
    assert counts["flash_attention"] == 2
    assert counts["gmm"] == 6 * 9
    entries = common.entry_counts()
    assert entries["flash_attention_wgmma_bf16"] == 2
    assert entries["gmm_wgmma_bf16"] == 6 * 9
    common.reset_launches()
    with plain_kernels():
        plain, gaps, _ = greedy_with_gaps(cfg, params, prompt, 8)
    assert common.launch_counts()["gmm"] == 0
    assert common.launch_counts()["flash_attention"] == 0
    check_tokens(out, plain, gaps)


@pytest.mark.needs_cuda
def test_probe_kernel_on_gpu(gpu):
    t = torch.randn((128, 128), device=gpu)
    assert torch.equal(probe_add_one(t), t + 1.0)


@pytest.mark.needs_cuda
def test_launch_counts_move_only_on_launch(gpu):
    img = torch.randn((40, 30), device=gpu)
    w = torch.randn((3, 3), device=gpu)
    before = common.launch_counts()
    conv2d_cuda(img, w)
    conv2d_shift_add(img, w)                  # the plain version: no count
    after = common.launch_counts()
    assert after["conv2d"] == before["conv2d"] + 1
    assert {k: v for k, v in after.items() if k != "conv2d"} == \
        {k: v for k, v in before.items() if k != "conv2d"}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["conv", "hist", "spmv", "sort",
                                  "bilateral"])
def test_run_hybrid_on_gpu_and_cpu(gpu, name):
    """The real pair: accel on the GPU, host on the CPU, in threads
    mode, with a forced split so both lanes execute; the value matches
    the CPU reference."""
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.workloads import bilateral, conv, hist, sort, spmv

    ex = HybridExecutor()
    if name == "conv":
        out = conv.run_hybrid(ex, size=128, ksize=5,
                              plan_override=[96, 32])
        img, w = conv.make_inputs(128, 5)
        ref = conv2d_ref(_t(img), _t(w))
        tol = 2e-4
    elif name == "hist":
        out = hist.run_hybrid(ex, n=1 << 16, n_bins=64,
                              plan_override=[48, 16])
        ref = torch.from_numpy(np.bincount(
            hist.make_inputs(1 << 16, 64), minlength=64).astype(np.int32))
        tol = 0
    elif name == "sort":
        out = sort.run_hybrid(ex, n=1 << 16, n_bins=16,
                              plan_override=[12, 4])
        ref = torch.from_numpy(np.sort(sort.make_inputs(1 << 16)))
        tol = 0
    elif name == "bilateral":
        out = bilateral.run_hybrid(ex, size=128, sigma_s=2.0, sigma_r=25.0,
                                   radius=2, plan_override=[96, 32])
        sp, rl = (_t(a) for a in bilateral_luts(2.0, 25.0, 2))
        ref = bilateral_lut_torch(_t(bilateral.make_inputs(128)), sp, rl)
        tol = 1e-3
    else:
        total = sum(spmv.run_hybrid(ex, n=512, density=0.02).plan.units)
        out = spmv.run_hybrid(ex, n=512, density=0.02,
                              plan_override=[total - 64, 64])
        A = spmv.make_matrix(512, 0.02).astype(np.float64)
        ref = torch.from_numpy((A @ spmv.make_vector(512)).astype(
            np.float32))
        tol = 1e-4
    assert out.result.mode == "threads" and not out.simulated
    assert out.trace.group_units["host"] > 0
    assert out.trace.group_units["accel"] > 0
    assert out.value.device == gpu
    torch.testing.assert_close(out.value.cpu(), ref, rtol=tol, atol=tol)


# ------------------------------------------------ the K3 and K4 routes
def _masked_ell_ref(vals, idx, x):
    """spmv_ell_ref with the products of indices outside [0, C) taken
    as 0 (what the kernel adds for them); spmv_ell_ref itself when all
    are in range."""
    C = x.shape[0]
    inside = (idx >= 0) & (idx < C)
    if bool(inside.all()):
        return spmv_ell_ref(vals, idx, x)
    prod = vals * x[idx.clamp(0, C - 1).long()]
    return torch.where(inside, prod, torch.zeros_like(prod)).sum(1)


def _spmv_route_case(vals, idx, x):
    """One call on the entry ``route`` names, within 2e-5 of the plain
    version, and a second call bitwise equal to the first."""
    entry, _ = spmv_kernel.route(vals.shape[1])
    common.reset_launches()
    out = spmv_ell_cuda(vals, idx, x)
    counts = common.entry_counts()
    assert counts[entry] == 1 and sum(counts.values()) == 1
    torch.testing.assert_close(out, _masked_ell_ref(vals, idx, x),
                               rtol=2e-5, atol=2e-5)
    again = spmv_ell_cuda(vals, idx, x)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    return entry


def _power_law_tile(R, K, C, seed):
    """A (R, K) ELL tile like the main path's heavy one: row lengths
    from K down to a few dozen, zero-padded (vals 0, index 0)."""
    rng = np.random.default_rng(seed)
    nnz = np.maximum((K / (1 + np.arange(R)) ** 0.7).astype(int), 30)
    nnz[0] = K
    vals = np.zeros((R, K), np.float32)
    idx = np.zeros((R, K), np.int32)
    for r, n in enumerate(nnz):
        vals[r, :n] = rng.standard_normal(n)
        idx[r, :n] = np.sort(rng.choice(C, n, replace=False))
    return vals, idx


@pytest.mark.needs_cuda
@pytest.mark.parametrize("R,K", [
    (512, 98), (512, 68), (33, 98), (33, 3451), (1, 3451), (1, 5),
    (64, 512), (64, 513), (64, 1024), (64, 1025), (64, 2048), (64, 2049),
    (9, 1), (5, 0)])
def test_spmv_ell_segmented_route_on_gpu(gpu, R, K):
    """The light tiles' shapes, R = 1 and 33, and K on both sides of
    every threads-a-row threshold, on the segmented-row entry."""
    rng = np.random.default_rng(R * 7 + K)
    vals = _t(rng.standard_normal((R, K)).astype(np.float32)).to(gpu)
    idx = _t(rng.integers(0, 8192, (R, K), dtype=np.int32)).to(gpu)
    x = _t(rng.standard_normal(8192).astype(np.float32)).to(gpu)
    assert _spmv_route_case(vals, idx, x) == "spmv_ell_seg_f32"


@pytest.mark.needs_cuda
def test_spmv_ell_segmented_route_at_a_power_law_tile(gpu):
    """512 x 3451, rows from 3451 slots down to 30, the rest padding."""
    vals, idx = _power_law_tile(512, 3451, 8192, 3451)
    x = _t(np.random.default_rng(1).standard_normal(8192).astype(
        np.float32)).to(gpu)
    assert _spmv_route_case(_t(vals).to(gpu), _t(idx).to(gpu), x) \
        == "spmv_ell_seg_f32"


@pytest.mark.needs_cuda
@pytest.mark.parametrize("K", [98, 3451])
def test_spmv_ell_segmented_route_on_offset_views(gpu, K):
    """Views one row into both tensors (16-byte loads after each row's
    head) and vals one float off idx's phase (the scalar
    instantiation), with no copy."""
    rng = np.random.default_rng(K)
    vals = _t(rng.standard_normal((65, K)).astype(np.float32)).to(gpu)
    idx = _t(rng.integers(0, 8192, (65, K), dtype=np.int32)).to(gpu)
    x = _t(rng.standard_normal(8192).astype(np.float32)).to(gpu)
    assert spmv_kernel.vector_loads(vals[1:].data_ptr(), idx[1:].data_ptr())
    _spmv_route_case(vals[1:], idx[1:], x)
    flat = _t(rng.standard_normal(1 + 64 * K).astype(np.float32)).to(gpu)
    off = flat[1:].view(64, K)
    assert not spmv_kernel.vector_loads(off.data_ptr(), idx[1:].data_ptr())
    _spmv_route_case(off, idx[1:], x)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("K", [98, 3451])
def test_spmv_ell_segmented_route_out_of_range_and_padding(gpu, K):
    """Indices -1 and C add nothing; all-zero padding rows give 0, and
    NaN once x[0] is inf (0 * inf, as vals * x[idx] gives)."""
    rng = np.random.default_rng(K + 1)
    vals = _t(rng.standard_normal((100, K)).astype(np.float32)).to(gpu)
    idx = _t(rng.integers(0, 500, (100, K), dtype=np.int32)).to(gpu)
    x = _t(rng.standard_normal(500).astype(np.float32)).to(gpu)
    idx[::3, ::7] = -1
    idx[1::3, 3::5] = 500
    _spmv_route_case(vals, idx, x)
    vals[50:], idx[50:] = 0.0, 0
    _spmv_route_case(vals, idx, x)
    assert not bool(spmv_ell_cuda(vals, idx, x)[50:].any())
    x[0] = float("inf")
    assert bool(torch.isnan(spmv_ell_cuda(vals, idx, x)[50:]).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape,offset", [((128, 128), 0), ((127, 129), 0),
                                          ((3,), 0), ((4096,), 1)])
def test_probe_one_block_entry_on_gpu(gpu, shape, offset):
    """The probe's one-block entry: exact, at the probe tile, a numel
    off a multiple of 4 and a view off 16-byte alignment."""
    n = int(np.prod(shape))
    t = torch.randn(offset + n, device=gpu)[offset:].view(shape)
    common.reset_launches()
    out = probe_add_one(t)
    counts = common.entry_counts()
    assert counts["probe_add_one_vec_f32"] == 1 and sum(counts.values()) == 1
    assert torch.equal(out, t + 1.0)


@pytest.mark.needs_cuda
def test_launch_floor_kernel_runs_uncounted(gpu):
    common.reset_launches()
    cost_model.launch_floor(gpu)
    torch.cuda.synchronize()
    assert not any(common.entry_counts().values())


# ---------------------------------------------------------------------------
# force_simulated and the other eight Table-1 workloads on the card
# ---------------------------------------------------------------------------
@pytest.mark.needs_cuda
def test_force_simulated_pair_on_gpu(gpu):
    """Both groups on the GPU, the host group at the ratio, mode
    virtual; the value is the CPU reference's."""
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.workloads import conv

    ex = HybridExecutor(simulated_ratio=3.9, force_simulated=True)
    assert ex.simulated and ex.backend == "torch:cuda:simulated"
    assert [(str(g.devices[0]), g.slowdown) for g in ex.groups] == \
        [("cuda:0", 1.0), ("cuda:0", 3.9)]
    out = conv.run_hybrid(ex, size=128, ksize=5)
    assert out.simulated and out.result.mode == "virtual"
    img, w = conv.make_inputs(128, 5)
    torch.testing.assert_close(out.value.cpu(), conv2d_ref(_t(img), _t(w)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.needs_cuda
def test_simulated_and_real_pairs_keep_apart_calibration_on_gpu(gpu):
    """At a ratio of 1.0 the simulated pair's host group (the GPU) and
    the real pair's (the CPU) share every key; neither reads the
    other's entry."""
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.workloads import conv

    sim = HybridExecutor(simulated_ratio=1.0, force_simulated=True)
    conv.run_hybrid(sim, size=112, ksize=3)
    key = ("Conv/112x3", "host", 1.0)
    seen = sim.cache.get(*key)
    real = HybridExecutor()
    assert seen is not None and real.cache.get(*key) is None
    out = conv.run_hybrid(real, size=112, ksize=3,
                          plan_override=[80, 32])
    assert out.result.mode == "threads"
    assert real.cache.get(*key) is not None
    assert sim.cache.get(*key) == seen


TABLE1_CASES = {"spgemm": dict(n=256, density=0.03),
                "raycast": dict(n_rays=1 << 12, d=32),
                "montecarlo": dict(n_photons=1 << 16, unit=1 << 10),
                "listrank": dict(n=1 << 14), "concomp": dict(n=1 << 12),
                "lbm": dict(d=16, n_steps=3), "dither": dict(h=64, w=48),
                "bundle": dict(n_cams=4, n_pts=256)}


def _least_vertex(labels):
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", sorted(TABLE1_CASES))
def test_table1_workload_on_gpu_matches_cpu(gpu, name):
    """The real pair's value against the CPU pair's at the CPU tests'
    tolerances (concomp: the same partition; lbm also conserves mass)."""
    import importlib

    from repro_torch.core.hybrid_executor import HybridExecutor

    mod = importlib.import_module(f"repro_torch.workloads.{name}")
    kw = TABLE1_CASES[name]
    out = mod.run_hybrid(HybridExecutor(), **kw)
    ref = mod.run_hybrid(HybridExecutor(device="cpu"), **kw).value
    assert not out.simulated
    if out.trace is not None:
        assert out.trace.mode == "threads"
    value = out.value
    if name in ("spgemm", "raycast", "lbm"):
        assert value.is_cuda
        tol = 1e-5 if name == "lbm" else 1e-4
        torch.testing.assert_close(value.cpu(), ref, rtol=tol, atol=tol)
    elif name in ("listrank", "dither"):
        assert value.is_cuda and torch.equal(value.cpu(), ref)
    elif name == "concomp":
        np.testing.assert_array_equal(_least_vertex(value),
                                      _least_vertex(ref))
    else:
        rel = 1e-5 if name == "montecarlo" else 1e-3
        assert value == pytest.approx(ref, rel=rel)
    if name == "spgemm":
        A, B = mod.make_matrices(**kw)
        np.testing.assert_allclose(value.cpu().numpy(), A @ B, rtol=2e-3,
                                   atol=2e-3)
    if name == "lbm":
        mass0 = float(mod.init_state(kw["d"]).astype(np.float64).sum())
        assert float(value.double().sum()) == pytest.approx(mass0, rel=1e-4)


@pytest.mark.needs_cuda
def test_table2_runs_all_thirteen_on_the_simulated_pair_on_gpu(gpu,
                                                              monkeypatch):
    """Every workload on the simulated pair on the card (both groups on
    cuda:0): sort's host lane must take its keys to the host for
    np.sort, as the reference's does."""
    from repro_torch.benchmarks import table2_hybrid
    monkeypatch.setattr(table2_hybrid, "SIZES", dict(
        sort=dict(n=1 << 12, n_bins=16), hist=dict(n=1 << 14, n_bins=64),
        spmv=dict(n=256, density=0.02), bilateral=dict(size=48, radius=2),
        conv=dict(size=64, ksize=5), **TABLE1_CASES))
    results = table2_hybrid.run(csv=False)
    for rs in results.values():
        assert len(rs) == 13
        assert all(r.hybrid_time > 0 for r in rs)
        assert {r.mode for r in rs if r.mode} == {"virtual"}


# ----------------------------------------------- autotune on the card
def _tune_cases(dev):
    """kernel -> (ops module, shape args of candidates(), call(cfg),
    plain value, tolerance, launch-count name, the route's entry)."""
    rng = np.random.default_rng(19)

    def randn(*shape, dtype=torch.float32):
        return _t(rng.standard_normal(shape).astype(np.float32)).to(
            dev, dtype)

    cases = {}
    for K in (15, 17):
        img, w = randn(50, 64), randn(K, K)
        cases[f"conv2d K={K}"] = (
            conv_ops, (50, 64, K),
            lambda c, img=img, w=w: conv_ops.conv2d(img, w, config=c),
            conv2d_shift_add(img, w), 2e-4, "conv2d",
            conv_kernel.route(K))
    for bins in (256, 1817):
        x = _t(rng.integers(-2, bins + 2, 100_003, dtype=np.int32)).to(dev)
        cases[f"hist bins={bins}"] = (
            hist_ops, (x.numel(), bins),
            lambda c, x=x, bins=bins: hist_ops.histogram(x, bins, config=c),
            hist_ref(x, bins), 0, "hist", hist_kernel.route(bins))
    vals, xv = randn(100, 201), randn(500)
    idx = _t(rng.integers(0, 500, (100, 201), dtype=np.int32)).to(dev)
    cases["spmv"] = (
        spmv_ops, (100, 201),
        lambda c: spmv_ops.spmv_ell(vals, idx, xv, config=c),
        spmv_ell_ref(vals, idx, xv), 2e-5, "spmv_ell",
        spmv_kernel.route(201)[0])
    pix = (randn(64, 48).abs() * 60).clamp(0, 255)
    for radius in (2, 9):
        sp, rl = (_t(a).to(dev) for a in bilateral_luts(2.0, 25.0, radius))
        K = 2 * radius + 1
        cases[f"bilateral r={radius}"] = (
            bilateral_ops, (64, 48, K),
            lambda c, sp=sp, rl=rl: bilateral_ops.bilateral_filter(
                pix, sp, rl, config=c),
            bilateral_lut_torch(pix, sp, rl), 1e-3, "bilateral",
            bilateral_kernel.route(K, 256))
    rows = randn(33, 256)
    cases["sort"] = (sort_ops, (33, 256),
                     lambda c: sort_ops.sort_rows(rows, config=c),
                     bitonic_rows_torch(rows), 0, "sort_bitonic",
                     "sort_rows_reg_f32")
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        q = randn(2, 100, 4, 64, dtype=dtype)
        k, v = randn(2, 100, 2, 64, dtype=dtype), randn(2, 100, 2, 64,
                                                        dtype=dtype)
        plain = flash_ops.flash_attention(q, k, v, use_kernel=False)
        cases[f"flash_attention {dtype}"] = (
            flash_ops, (100, 100, 64, True),
            lambda c, q=q, k=k, v=v: flash_ops.flash_attention(
                q, k, v, config=c),
            plain, tol, "flash_attention", flash_route(dtype, 64))
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-4)):
        xe = randn(4, 24, 64, dtype=dtype)
        we = (randn(4, 64, 80) * 0.125).to(dtype)
        cases[f"gmm {dtype}"] = (
            gmm_ops, (4, 24, 64, 80),
            lambda c, xe=xe, we=we: gmm_ops.gmm(xe, we, config=c),
            gmm_torch(xe, we), tol, "gmm", gmm_route(dtype, 64, 80))
    return cases


TUNE_CASES = ["conv2d K=15", "conv2d K=17", "hist bins=256",
              "hist bins=1817", "spmv", "bilateral r=2", "bilateral r=9",
              "sort", "flash_attention torch.bfloat16",
              "flash_attention torch.float32", "gmm torch.bfloat16",
              "gmm torch.float32"]


def _candidates(ops, args, plain):
    if ops.__name__.endswith(("flash_attention.ops", "gmm.ops")):
        return ops.candidates(*args, device=plain.device, dtype=plain.dtype)
    return ops.candidates(*args, device=plain.device)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", TUNE_CASES)
def test_every_autotune_candidate_on_gpu(gpu, case):
    """Each candidate of the space on a CUDA tensor against the plain
    version; a CUDA candidate launches exactly its C entry, a native
    one launches nothing."""
    ops, args, call, plain, tol, name, _ = _tune_cases(gpu)[case]
    cands = _candidates(ops, args, plain)
    assert any(c["impl"] == "cuda" for c in cands)
    for cfg in cands:
        common.reset_launches()
        out = call(cfg)
        counts, entries = common.launch_counts(), common.entry_counts()
        if cfg["impl"] == "cuda":
            entry = cfg.get("entry") or "sort_rows_reg_f32"
            assert counts[name] == entries[entry] == 1, cfg
        else:
            assert counts[name] == 0, cfg
        if tol == 0:
            assert torch.equal(out, plain), cfg
        else:
            torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                                       atol=tol, msg=lambda m: f"{cfg}: {m}")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", TUNE_CASES)
def test_tuned_call_launches_its_config_on_gpu(gpu, case, tmp_path,
                                               monkeypatch):
    """With the search on, the call after the search is a cache hit
    that launches what the winning config names (nothing of the kernel
    for a native winner); with it off, the route's entry."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    at.reset_tune_cache()
    try:
        ops, args, call, plain, tol, name, route_entry = \
            _tune_cases(gpu)[case]
        call(None)                                  # the search
        # flash attention's bucket counts the query heads: B * H = 8
        bkt = ops.shape_bucket(*((8, 100, 100, 64, True)
                                 if "flash" in case else args))
        entry = at.tuned_entry(ops.__name__.split(".")[-2], bkt,
                               device=gpu)
        assert entry is not None, case
        common.reset_launches()
        timed = []
        prev = at.set_timer(lambda fn: timed.append(1) or 1.0)
        try:
            call(None)
        finally:
            at.set_timer(prev)
        assert timed == []                          # a hit: no measure
        counts, entries = common.launch_counts(), common.entry_counts()
        cfg = entry["config"]
        if cfg["impl"] == "cuda":
            assert entries[cfg.get("entry") or route_entry] == 1
        else:
            assert counts[name] == 0
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        common.reset_launches()
        call(None)
        assert common.entry_counts()[route_entry] == 1
    finally:
        at.reset_tune_cache()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", TUNE_CASES)
def test_search_raises_when_the_kernel_fails_on_gpu(gpu, case, tmp_path,
                                                    monkeypatch):
    """A kernel whose launch fails stops the search with its error: the
    search never settles on a native candidate in its place, and
    nothing is written to the tune file."""
    import importlib
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    _, _, call, *_ = _tune_cases(gpu)[case]

    def failing_launch(kernel, entry, *args):
        raise RuntimeError(f"{entry}: injected launch failure")
    for mod in ("conv2d.conv2d", "hist.hist", "spmv.spmv",
                "bilateral.bilateral", "sort_bitonic.sort_bitonic",
                "flash_attention.flash_attention", "gmm.gmm"):
        monkeypatch.setattr(importlib.import_module(
            "repro_torch.kernels." + mod), "launch", failing_launch)
    at.reset_tune_cache()
    try:
        with pytest.raises(RuntimeError, match="injected launch failure"):
            call(None)
        assert not (tmp_path / "tune.json").exists()
    finally:
        at.reset_tune_cache()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("kernel,pin,call", [
    ("conv2d", '{"impl": "cuda", "entry": "conv2d_reg_f32"}',
     lambda d: conv_ops.conv2d(torch.zeros(20, 20, device=d),
                               torch.zeros(17, 17, device=d))),
    ("hist", '{"impl": "cuda", "entry": "hist_priv_i32"}',
     lambda d: hist_ops.histogram(
         torch.zeros(64, dtype=torch.int32, device=d), 1817)),
    ("flash_attention",
     '{"impl": "cuda", "entry": "flash_attention_wgmma_bf16"}',
     lambda d: flash_ops.flash_attention(
         torch.zeros(1, 64, 2, 64, device=d),
         torch.zeros(1, 64, 1, 64, device=d),
         torch.zeros(1, 64, 1, 64, device=d))),
    ("gmm", '{"impl": "cuda", "entry": "gmm_wgmma_bf16"}',
     lambda d: gmm_ops.gmm(torch.zeros(2, 8, 64, device=d),
                           torch.zeros(2, 64, 64, device=d))),
])
def test_pinned_forbidden_entry_raises_on_gpu(gpu, kernel, pin, call,
                                              monkeypatch):
    """A pinned config naming an entry the route rules out for the
    shape raises (f32 never reaches the tensor cores): it is never
    re-routed silently."""
    monkeypatch.setenv("REPRO_TUNE_PIN_" + kernel.upper(), pin)
    common.reset_launches()
    with pytest.raises(ValueError):
        call(gpu)
    assert sum(common.launch_counts().values()) == 0


@pytest.mark.needs_cuda
def test_model_layers_launch_a_hit_and_not_a_pin_on_gpu(gpu, tmp_path,
                                                        monkeypatch):
    """The model layers' lookup on the card: with the search on and no
    hit, a no-grad attention and MoE layer launch K7 and K8 on their
    routes; a ``torch:cuda`` hit naming the CUDA-core entries moves
    every launch there with nothing timed; ``torch_*`` pins launch
    neither kernel."""
    from repro_torch.configs import registry
    from repro_torch.models import attention, model_zoo, moe

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    at.reset_tune_cache()
    cfg = registry.get("kimi-k2-1t-a32b").reduced()
    layer = model_zoo.init(cfg, 0, device=gpu)["stack"]["groups"][0]["l0"]
    B, T, H, d = 2, 64, cfg.n_heads, cfg.head_dim_()
    x = torch.randn(B, T, cfg.d_model, device=gpu).to(torch.bfloat16)
    shapes, real = set(), gmm_ops._gmm_cfg

    def gmm_cfg(x_, w_, cfg_):
        shapes.add((*x_.shape, w_.shape[2]))
        return real(x_, w_, cfg_)
    monkeypatch.setattr(gmm_ops, "_gmm_cfg", gmm_cfg)

    def run():
        common.reset_launches()
        with torch.no_grad():
            attention.attention(layer["mix"], x, cfg)
            moe.moe_ffn(layer["ffn"], x, cfg)
        torch.cuda.synchronize()
        return common.launch_counts(), common.entry_counts()

    try:
        counts, entries = run()
        assert entries[flash_route(torch.bfloat16, d)] == 1
        assert counts["gmm"] > 0
        cache = at.get_tune_cache()
        cache.put("torch:cuda", "flash_attention",
                  flash_ops.shape_bucket(B * H, T, T, d, True),
                  {"impl": "cuda", "entry": "flash_attention_fma_bf16"}, 1.0)
        for E, C, D, F in shapes:
            cache.put("torch:cuda", "gmm", gmm_ops.shape_bucket(E, C, D, F),
                      {"impl": "cuda", "entry": "gmm_fma_bf16"}, 1.0)
        timed = []
        prev = at.set_timer(lambda fn: timed.append(1) or 1.0)
        try:
            hit_counts, entries = run()
        finally:
            at.set_timer(prev)
        assert timed == [] and hit_counts == counts
        assert entries["flash_attention_fma_bf16"] == 1
        assert entries["gmm_fma_bf16"] == counts["gmm"]
        monkeypatch.setenv("REPRO_TUNE_PIN_FLASH_ATTENTION",
                           '{"impl": "torch_blocked"}')
        monkeypatch.setenv("REPRO_TUNE_PIN_GMM", '{"impl": "torch_einsum"}')
        counts, _ = run()
        assert counts["flash_attention"] == 0 and counts["gmm"] == 0
    finally:
        at.reset_tune_cache()


@pytest.mark.needs_cuda
def test_tp16_prefill_runs_k7_over_the_repeated_heads_on_gpu(gpu):
    """kimi-k2 ``reduced()`` at tp = 16 (kv_repeat 2): the prefill
    launches K7 once a layer, and its tokens equal tp = 1's under the
    margin rule."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import generate

    cfg = registry.get("kimi-k2-1t-a32b").reduced()
    params = model_zoo.init(cfg, 0, device=gpu)
    prompt = torch.randint(0, cfg.vocab_size, (2, 64), device=gpu)
    plain, gaps, _ = greedy_with_gaps(cfg, params, prompt, 4)
    common.reset_launches()
    toks = generate(cfg, params, prompt, 4, tp=16)
    assert common.launch_counts()["flash_attention"] == cfg.n_layers
    check_tokens(toks, plain, gaps)


@pytest.mark.needs_cuda
def test_torch_conv_candidate_keeps_tf32_off_on_gpu(gpu):
    """``F.conv2d`` as a candidate holds conv's 2e-4 even where the
    caller left cuDNN's TF32 on, and leaves the flag as it found it."""
    img = torch.randn(130, 96, device=gpu)
    w = torch.randn(15, 15, device=gpu)
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = conv_ops.conv2d(img, w, config={"impl": "torch_conv"})
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(out, conv2d_shift_add(img, w), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_ops_at_batch_one_on_gpu(gpu, dtype):
    """B = 1 (a single prompt, cold_start's shape): every CUDA entry of
    the space runs through ``ops.flash_attention`` and matches the plain
    version."""
    q = torch.randn(1, 96, 8, 64, device=gpu).to(dtype)
    k = torch.randn(1, 96, 2, 64, device=gpu).to(dtype)
    v = torch.randn(1, 96, 2, 64, device=gpu).to(dtype)
    plain = flash_ops.flash_attention(q, k, v, use_kernel=False)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    cands = [c for c in flash_ops.candidates(96, 96, 64, True, gpu, dtype)
             if c["impl"] == "cuda"]
    assert cands
    for cfg in cands:
        common.reset_launches()
        out = flash_ops.flash_attention(q, k, v, config=cfg)
        assert common.entry_counts()[cfg["entry"]] == 1
        torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# the serving scheduler on the real pair (the GPU and the CPU)
# ---------------------------------------------------------------------------
SERVE_PAYLOADS = {
    "conv": {"size": 96, "ksize": 5},
    "hist": {"n": 1 << 14, "n_bins": 64},
    "spmv": {"n": 256, "density": 0.02},
    "bilateral": {"size": 64, "radius": 3},
    "sort": {"n": 1 << 12},
    "attention": {"batch": 4, "seq": 64, "heads": 4, "kv_heads": 2,
                  "dim": 32},
}
SERVE_TOL = {"conv": 2e-4, "hist": 0, "spmv": 2e-5, "bilateral": 1e-3,
             "sort": 0, "attention": 2e-5}


def _serve_value(v):
    return v.cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))


@pytest.fixture
def fresh_serving():
    from repro_torch.core.calibration import clear_calibration_cache
    from repro_torch.serve import scheduler as sched_mod
    clear_calibration_cache("torch:cuda")
    yield
    sched_mod.shutdown_all(timeout=10.0)
    clear_calibration_cache("torch:cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wl", sorted(SERVE_PAYLOADS))
def test_scheduler_serves_workload_on_each_group_and_shared_on_gpu(
        gpu, fresh_serving, wl):
    """Each kernel-backed workload served dedicated on the accel group
    (cuda:0), dedicated on the host group (the CPU) and work-shared
    across both: every value equals the solo run on the CPU lane at the
    kernel tests' tolerance, and lies on the device that ran it."""
    from repro_torch.core.calibration import clear_calibration_cache
    from repro_torch.kernels.common import lane_device
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.workloads import requests as adapters

    payload = SERVE_PAYLOADS[wl]
    with lane_device("cpu"):
        want = _serve_value(adapters.make_request(wl, payload).run_one())
    spec = adapters.make_request(wl, payload)
    tol = SERVE_TOL[wl]
    for lane in ("accel", "host", "shared"):
        if lane == "shared":
            s = Scheduler(max_batch=1, batch_window_s=0.0,
                          split_overhead_s=0.0, shared_span_factor=1.0)
            # equal unit times (and no measurement of the runs before):
            # an idle pair splits the request
            clear_calibration_cache("torch:cuda")
            for g in ("accel", "host"):
                s._ex.cache.put(spec.workload, g, 1e-3)
        else:
            s = Scheduler(policy="fifo", fifo_group=lane, max_batch=1,
                          batch_window_s=0.0, shared_span_factor=1.0)
        with s:
            f = s.submit(wl, payload)
            value = f.result(timeout=120)
        assert f.meta["lane"] == lane
        if isinstance(value, torch.Tensor):
            assert str(value.device) == ("cpu" if lane == "host"
                                         else "cuda:0")
        got = _serve_value(value)
        if tol == 0:
            assert torch.equal(got, want), lane
        else:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        assert s.stats.completed == 1 and s.stats.in_flight == 0


@pytest.mark.needs_cuda
def test_dedicated_lanes_run_on_their_devices_on_gpu(gpu, fresh_serving):
    """The accel lane runs under cuda:0 on a stream of its own, the host
    lane under the CPU."""
    from dataclasses import dataclass

    from repro_torch.kernels.common import current_device
    from repro_torch.serve.scheduler import Scheduler

    @dataclass(frozen=True)
    class Spec:
        workload: str
        total_units: int
        run_one: object
        run_share: object
        combine: object
        bucket: str = "b"

    def factory(workload, payload):
        def run_one():
            dev = current_device()
            stream = (torch.cuda.current_stream(dev)
                      if dev.type == "cuda" else None)
            return str(dev), stream
        return Spec(workload, 1, run_one, lambda g, s, k: run_one(),
                    lambda o: o[0])

    for lane, want in (("accel", "cuda:0"), ("host", "cpu")):
        with Scheduler(policy="fifo", fifo_group=lane, spec_factory=factory,
                       batch_window_s=0.0, shared_span_factor=1.0) as s:
            dev, stream = s.submit("wl", None).result(timeout=30)
        assert dev == want
        if lane == "accel":
            assert stream != torch.cuda.default_stream(gpu)


MERGE_CASES = {
    "hist": lambda s: {"n": 1 << 14, "n_bins": 64, "seed": s},
    "sort": lambda s: {"n": 1 << 12, "seed": s},
    "attention": lambda s: {"batch": 2, "seq": 64, "heads": 4,
                            "kv_heads": 2, "dim": 32, "seed": s},
    "raycast": lambda s: {"n_rays": 512, "d": 16, "seed": 0},
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wl", sorted(MERGE_CASES))
@pytest.mark.parametrize("n", [3, 8])
def test_merged_rows_bitwise_solo_on_gpu(gpu, wl, n):
    """On the card a merged batch (pow2-padded) demuxes every member
    bitwise equal to its solo run_one on the card."""
    from repro_torch.kernels.common import lane_device
    from repro_torch.workloads import requests as adapters

    specs = [adapters.make_request(wl, MERGE_CASES[wl](s))
             for s in range(n)]
    with lane_device(gpu):
        merged = specs[0].merge(specs)
        assert merged is not None
        batched = merged.spec.run_one()
        for i, s in enumerate(specs):
            assert torch.equal(_serve_value(merged.demux(batched, i)),
                               _serve_value(s.run_one())), i


@pytest.mark.needs_cuda
@pytest.mark.parametrize("R,H,K", [(2, 64, 5), (8, 512, 15), (8, 96, 3),
                                   (3, 33, 7), (5, 100, 9), (16, 64, 1)])
def test_conv2d_batched_bitwise_solo_torch_conv_on_gpu(gpu, R, H, K):
    """The conv merge's batched call is bitwise the solo ``torch_conv``
    per row on the card (``CONV_MERGE_DEVICES``)."""
    from repro_torch.kernels.conv2d.ref import conv2d_ref

    g = torch.Generator(device=gpu).manual_seed(R * H + K)
    imgs = torch.randn(R, H, H, device=gpu, generator=g)
    ws = torch.randn(R, K, K, device=gpu, generator=g)
    out = conv_ops.conv2d_batched(imgs, ws)
    for i in range(R):
        assert torch.equal(out[i], conv2d_ref(imgs[i], ws[i])), i


@pytest.mark.needs_cuda
def test_conv_merge_engages_only_on_torch_conv_on_gpu(gpu, monkeypatch):
    """With the search off the solo conv is K1, so the merge declines;
    with ``torch_conv`` pinned it engages and every row is bitwise the
    member's solo run."""
    from repro_torch.kernels.common import lane_device
    from repro_torch.workloads import requests as adapters

    def specs(seeds):
        # fresh seeds a case: each request's inputs keep their resolved
        # config per device
        return [adapters.make_request("conv", {"size": 96, "ksize": 5,
                                               "seed": s}) for s in seeds]

    with lane_device(gpu):
        first = specs(range(5))
        assert first[0].merge(first) is None
    monkeypatch.setenv("REPRO_TUNE_PIN_CONV2D", '{"impl": "torch_conv"}')
    pinned = specs(range(5, 10))
    with lane_device(gpu):
        merged = pinned[0].merge(pinned)
        assert merged is not None
        batched = merged.spec.run_one()
        for i, s in enumerate(pinned):
            assert torch.equal(merged.demux(batched, i), s.run_one())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n_bins", [1, 64, 256, 4096])
def test_histogram_rows_exact_on_gpu(gpu, n_bins):
    x = torch.randint(-3, n_bins + 3, (6, 5000), dtype=torch.int32,
                      device=gpu)
    out = hist_ops.histogram_rows(x, n_bins)
    for i in range(6):
        assert torch.equal(out[i], hist_ref(x[i], n_bins))


# ---------------------------------------------------------------------------
# the continuous-batching engine on the card
# ---------------------------------------------------------------------------
def _accel_group(gpu):
    from repro_torch.core.hybrid_executor import DeviceGroup
    return [DeviceGroup("accel", [gpu], "accel")]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "minicpm3-4b"])
def test_continuous_lm_engine_on_gpu(gpu, fresh_serving, arch):
    """kimi-k2 (attention + MoE) and minicpm3-4b (MLA) reduced() on the
    card through the engine: a burst of batch-1 requests stacks into
    slot-batched steps, each request's tokens bitwise a solo
    ``generate`` of its prompt at B = 1, every K8 launch (kimi-k2's) on
    its tensor-core entry."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve.serve_step import generate
    from repro_torch.workloads import requests as adapters

    cfg = registry.get(arch).reduced()
    params = model_zoo.init(cfg, 0, device=gpu)
    wl = adapters.make_continuous_lm_adapter(
        cfg, params, prompt_len=16, new_tokens=4, n_slots=4,
        warm_background=False, name="serve-lm-cb/gpu-test")
    try:
        sched = sched_mod.Scheduler(groups=_accel_group(gpu))
        common.reset_launches()
        futs = [sched.submit(wl, {"batch": 1, "seed": s}) for s in range(6)]
        outs = [f.result(timeout=300) for f in futs]
        snap = sched.stats.snapshot()
        entries = common.entry_counts()
        sched.shutdown()
        for s, out in enumerate(outs):
            prompt = adapters.make_request(wl, {"batch": 1, "seed": s}) \
                .arrays[0].on(gpu)[0]
            want = generate(cfg, params, prompt, 4, cache_len=21).cpu()
            assert torch.equal(out, want), s
        assert 0 < snap["engine_steps"] < 6 * 4
        assert not entries["gmm_fma_bf16"]
        assert (entries["gmm_wgmma_bf16"] > 0) == (cfg.moe is not None)
    finally:
        adapters.unregister(wl)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wl,payload", [
    ("listrank", {"n": 1 << 12}), ("lbm", {"d": 16, "n_steps": 3}),
    ("dither", {"h": 48, "w": 40})])
def test_iteration_steppers_on_gpu(gpu, fresh_serving, wl, payload):
    """The iteration steppers decoding on the card: three stacked
    requests, each bitwise its solo ``run_one`` on the card."""
    from repro_torch.kernels.common import lane_device
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.workloads import requests as adapters

    sched = sched_mod.Scheduler(groups=_accel_group(gpu))
    futs = [sched.submit(wl, dict(payload, seed=s, continuous=True))
            for s in range(3)]
    outs = [f.result(timeout=300) for f in futs]
    sched.shutdown()
    for s, out in enumerate(outs):
        with lane_device(gpu):
            solo = adapters.make_request(wl, dict(payload, seed=s)).run_one()
        if isinstance(solo, torch.Tensor):
            assert out.device == solo.device and torch.equal(out, solo), s
        else:
            np.testing.assert_array_equal(out, solo)


# ---------------------------------------------------------------------------
# the model families of the MLA and encoder-decoder slice
# ---------------------------------------------------------------------------
# K8 at deepseek-v2-lite-16b's shapes: 64 experts, expert width 1408,
# d_model 2048; C = 4 x 120 at a 4 x 1024 prefill, 4 x 30 in its tail
# pass, 4 at a B = 4 decode step
DEEPSEEK_GMM = [("prefill up", 480, 2048, 1408),
                ("prefill down", 480, 1408, 2048),
                ("prefill tail up", 120, 2048, 1408),
                ("prefill tail down", 120, 1408, 2048),
                ("decode up", 4, 2048, 1408), ("decode down", 4, 1408, 2048)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("label,C,D,F", DEEPSEEK_GMM)
def test_gmm_at_deepseek_shapes_on_gpu(gpu, label, C, D, F):
    gen = torch.Generator(device=gpu).manual_seed(C + D)
    x = torch.randn((64, C, D), generator=gen, device=gpu).bfloat16()
    w = (torch.randn((64, D, F), generator=gen, device=gpu)
         * D ** -0.5).bfloat16()
    common.reset_launches()
    out = gmm_cuda(x, w)
    assert common.entry_counts()["gmm_wgmma_bf16"] == 1
    torch.testing.assert_close(out.float(), gmm_torch(x, w).float(),
                               rtol=1e-2, atol=1e-2, msg=lambda m:
                               f"{label}: {m}")


# K7's full (causal=False) route at whisper-tiny's shapes: 4 rows x 6
# heads, d = 64, 1500 encoder frames: the encoder (T = S = 1500), the
# teacher-forced cross-attention (T = 448) and a decode step's (T = 1)
WHISPER_ATTN = [("encoder", 1500, 1500), ("cross-attention", 448, 1500),
                ("decode cross-attention", 1, 1500)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("label,T,S", WHISPER_ATTN)
def test_flash_attention_full_route_at_whisper_shapes_on_gpu(gpu, label, T,
                                                             S):
    gen = torch.Generator(device=gpu).manual_seed(T + S)
    q = torch.randn((24, T, 64), generator=gen, device=gpu).bfloat16()
    k, v = (torch.randn((24, S, 64), generator=gen, device=gpu).bfloat16()
            for _ in range(2))
    common.reset_launches()
    out = flash_attention_cuda(q, k, v, False)
    assert common.entry_counts()["flash_attention_wgmma_bf16"] == 1
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, False).float(),
                               rtol=1e-2, atol=1e-2, msg=lambda m:
                               f"{label}: {m}")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("d", [256, 384, 512, 768, 2048, 2560, 7168])
def test_norm_rows_bitwise_on_gpu(gpu, d):
    """On the card a row's norm is the same bits in a 4- or 8-row batch
    as alone (every norm width of the ported configs): the mean is
    summed in two fixed stages, where a one-stage reduction kernel
    splits a 2560-wide row across warps by the number of rows
    (minicpm3-4b's slot step missed bit-identity by that)."""
    from repro_torch.configs import registry
    from repro_torch.models import layers

    cfg = registry.get("minicpm3-4b")
    gen = torch.Generator(device=gpu).manual_seed(d)
    for rows in (4, 8) * 10:
        x = torch.randn((rows, 1, d), generator=gen, device=gpu).bfloat16()
        scale = torch.rand(d, generator=gen, device=gpu)
        for c in (cfg, cfg.replace(norm_type="layernorm")):
            p = {"scale": scale, "bias": scale} \
                if c.norm_type == "layernorm" else {"scale": scale}
            batch = layers.norm(p, x, c)
            for b in range(rows):
                assert torch.equal(batch[b:b + 1],
                                   layers.norm(p, x[b:b + 1], c))
        qk = layers.rms_norm_simple(x, scale)
        for b in range(rows):
            assert torch.equal(qk[b:b + 1],
                               layers.rms_norm_simple(x[b:b + 1], scale))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_slot_step_bitwise_b1_steps_on_gpu(gpu, arch):
    """The MLA model's 4-slot decode step (one ``decode_step`` at a (4,)
    position tensor) against four B = 1 steps at each row's ``int``
    position, teacher-forced from B = 1 prefills: logits and latent
    caches bitwise, on the card."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    from repro_torch.models.param import leaves
    from repro_torch.serve.continuous import _tree_map

    cfg = registry.get(arch).reduced()
    params = model_zoo.init(cfg, 0, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(7)
    P, L, n = 12, 24, 6
    prompts = torch.randint(0, cfg.vocab_size, (4, P), generator=gen,
                            device=gpu)
    toks = torch.randint(0, cfg.vocab_size, (4, n), generator=gen,
                         device=gpu)
    with torch.inference_mode():
        rows = [model_zoo.prefill(cfg, params, {"tokens": prompts[b:b + 1]},
                                  cache_len=L)[1] for b in range(4)]
        slots = _tree_map(lambda *a: torch.cat(a, 0).clone(), *rows)
        pos = torch.full((4,), P, dtype=torch.long, device=gpu)
        for t in range(n):
            lg, _ = model_zoo.decode_step(cfg, params, toks[:, t:t + 1],
                                          slots, pos)
            for b in range(4):
                one, _ = model_zoo.decode_step(cfg, params,
                                               toks[b:b + 1, t:t + 1],
                                               rows[b], P + t)
                assert torch.equal(lg[b:b + 1], one), (t, b)
            pos += 1
        for b in range(4):
            got = _tree_map(lambda a: a[b:b + 1], slots)
            assert all(torch.equal(x, y) for x, y in zip(leaves(got),
                                                         leaves(rows[b])))


@pytest.mark.needs_cuda
def test_deepseek_greedy_tokens_kernel_path_against_plain_path(gpu):
    """deepseek-v2-lite reduced(): ``generate`` through K8 gives the
    plain path's tokens under the margin rule; K8 launches 3 matmuls x
    2 passes in each of its 3 MoE layers, at prefill and each step."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    from repro_torch.serve.serve_step import generate

    cfg = registry.get("deepseek-v2-lite-16b").reduced()
    params = model_zoo.init(cfg, 0, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=gpu,
                           generator=gen)
    common.reset_launches()
    out = generate(cfg, params, prompt, 8)
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    assert common.launch_counts()["gmm"] == 6 * n_moe * 9
    assert common.launch_counts()["flash_attention"] == 0
    assert common.entry_counts()["gmm_wgmma_bf16"] == 6 * n_moe * 9
    with plain_kernels():
        plain, gaps, _ = greedy_with_gaps(cfg, params, prompt, 8)
    check_tokens(out, plain, gaps)


@pytest.mark.needs_cuda
def test_whisper_on_gpu_launches_the_full_route(gpu):
    """whisper-tiny reduced() on the card: ``encode`` and
    ``decode_train`` launch K7 (full route in the encoder and the
    cross-attention, causal in the decoder's self-attention) on its
    tensor-core entry; decode steps (K7 at T = 1 against the frames)
    give ``decode_train``'s logits at the bf16 model tolerance; the
    same run with K7's plain version agrees at that tolerance."""
    from repro_torch.configs import registry
    from repro_torch.models import encdec, model_zoo

    cfg = registry.get("whisper-tiny").reduced()
    params = model_zoo.init(cfg, 0, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(2)
    frames = torch.randn((2, 100, cfg.d_model), generator=gen,
                         device=gpu).bfloat16()
    dec = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                        device=gpu)
    with torch.inference_mode():
        common.reset_launches()
        enc = encdec.encode(params, frames, cfg)
        full, _ = encdec.decode_train(params, enc, dec, cfg)
        assert common.launch_counts()["flash_attention"] == \
            cfg.n_enc_layers + 2 * cfg.n_layers
        c = model_zoo.init_caches(cfg, 2, 12, params=params, enc_out=enc)
        common.reset_launches()
        for t in range(12):
            lg, c = model_zoo.decode_step(cfg, params, dec[:, t:t + 1], c, t)
            torch.testing.assert_close(lg[:, 0].float(), full[:, t].float(),
                                       atol=0.25, rtol=0.1)
        assert common.launch_counts()["flash_attention"] == 12 * cfg.n_layers
        assert common.entry_counts()["flash_attention_wgmma_bf16"] \
            == 12 * cfg.n_layers
        with plain_kernels():
            plain, _ = model_zoo.forward(cfg, params, {"frames": frames,
                                                       "dec_tokens": dec})
    torch.testing.assert_close(full.float(), plain.float(), atol=0.25,
                               rtol=0.1)


# ---------------------------------------------------------------------------
# the recurrent families: xlstm-350m and jamba-1.5-large
# ---------------------------------------------------------------------------
def _slot_step_bitwise(gpu, cfg):
    """A 4-slot decode step (one ``decode_step`` at a (4,) position
    tensor) against four B = 1 steps at each row's ``int`` position,
    teacher-forced from B = 1 prefills: logits and every cache bitwise,
    on the card."""
    from repro_torch.models import model_zoo
    from repro_torch.models.param import leaves
    from repro_torch.serve.continuous import _tree_map

    params = model_zoo.init(cfg, 0, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(7)
    P, L, n = 16, 24, 6
    prompts = torch.randint(0, cfg.vocab_size, (4, P), generator=gen,
                            device=gpu)
    toks = torch.randint(0, cfg.vocab_size, (4, n), generator=gen,
                         device=gpu)
    with torch.inference_mode():
        rows = [model_zoo.prefill(cfg, params, {"tokens": prompts[b:b + 1]},
                                  cache_len=L)[1] for b in range(4)]
        slots = _tree_map(lambda *a: torch.cat(a, 0).clone(), *rows)
        pos = torch.full((4,), P, dtype=torch.long, device=gpu)
        for t in range(n):
            lg, _ = model_zoo.decode_step(cfg, params, toks[:, t:t + 1],
                                          slots, pos)
            for b in range(4):
                one, _ = model_zoo.decode_step(cfg, params,
                                               toks[b:b + 1, t:t + 1],
                                               rows[b], P + t)
                assert torch.equal(lg[b:b + 1], one), (t, b)
            pos += 1
        for b in range(4):
            got = _tree_map(lambda a: a[b:b + 1], slots)
            assert all(torch.equal(x, y) for x, y in zip(leaves(got),
                                                         leaves(rows[b])))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("which", ["reduced", "one group"])
def test_xlstm_slot_step_bitwise_b1_steps_on_gpu(gpu, which):
    """xlstm-350m's 4-slot step bitwise four B = 1 steps: ``reduced()``,
    and the full width cut to one 8-layer group (7 mLSTM, 1 sLSTM)."""
    from repro_torch.configs import registry
    cfg = registry.get("xlstm-350m")
    _slot_step_bitwise(gpu, cfg.reduced() if which == "reduced"
                       else cfg.replace(n_layers=8))


@pytest.mark.needs_cuda
def test_jamba_slot_step_bitwise_b1_steps_on_gpu(gpu):
    """jamba-1.5-large ``reduced()``'s 4-slot step (mamba, MoE on K8,
    attention) bitwise four B = 1 steps."""
    from repro_torch.configs import registry
    _slot_step_bitwise(gpu, registry.get("jamba-1.5-large-398b").reduced())


def _row_ops(cfg, gen, gpu):
    """(label, fn, inputs) of every op of an xLSTM / mamba decode step
    whose batch axis carries the slots: the linears at their widths,
    the per-row recurrent products, the decode conv, the group norm.
    Every input has the 4 rows on its axis 0."""
    from repro_torch.configs import registry
    from repro_torch.models import layers, ssm, xlstm

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=gpu).to(dtype)

    f32 = torch.float32
    d = cfg.d_model
    di, nh, dh = xlstm._mdims(cfg)
    sdh = d // nh
    ops = []
    for d_in, d_out in ((d, 2 * di), (di, di), (di, d), (d, 4 * d), (d, d),
                        (d, cfg.vocab_size)):
        w = {"w": rnd(d_in, d_out) * d_in ** -0.5, "b": rnd(d_out)}
        ops.append((f"linear {d_in}->{d_out}",
                    lambda x, w=w: layers.linear(w, x), (rnd(4, 1, d_in),)))
    # the mLSTM gates' projections to nh outputs: one-row calls
    w = {"w": rnd(d, nh) * d ** -0.5, "b": rnd(nh)}
    ops.append((f"gate linear {d}->{nh} (per row)",
                lambda x, w=w: layers.rowwise(
                    lambda r: layers.linear(w, r), x), (rnd(4, 1, d),)))
    ops.append(("mLSTM num (per row)", lambda q, C: layers.rowwise(
        lambda a, b: torch.einsum("bhd,bhde->bhe", a, b), q, C),
        (rnd(4, nh, dh, dtype=f32), rnd(4, nh, dh, dh, dtype=f32))))
    ops.append(("mLSTM den (per row)", lambda q, n: layers.rowwise(
        lambda a, b: torch.einsum("bhd,bhd->bh", a, b), q, n),
        (rnd(4, nh, dh, dtype=f32), rnd(4, nh, dh, dtype=f32))))
    r = rnd(nh, sdh, 4 * sdh, dtype=f32)
    ops.append(("sLSTM rec (per row)", lambda h, r=r: layers.rowwise(
        lambda a: torch.einsum("bhd,hde->bhe", a, r), h),
        (rnd(4, nh, sdh, dtype=f32),)))
    w, b = rnd(cfg.xlstm.conv_width, di), rnd(di)
    ops.append(("decode conv", lambda x, w=w, b=b: layers.conv_step(x, w, b),
                (rnd(4, cfg.xlstm.conv_width, di),)))
    for n_, dh_ in ((nh, dh), (nh, sdh)):
        s = rnd(n_ * dh_, dtype=f32)
        ops.append((f"group norm dh={dh_}",
                    lambda h, s=s, n_=n_: xlstm._group_norm(h, s, n_),
                    (rnd(4, 1, n_, dh_),)))
    jdi, ds, _, _ = ssm._dims(registry.get("jamba-1.5-large-398b"))
    ops.append(("mamba readout (per row)",
                lambda h, C: ssm._readout(h, C, True),
                (rnd(4, jdi, ds, dtype=f32), rnd(4, ds, dtype=f32))))
    return ops


@pytest.mark.needs_cuda
def test_recurrent_decode_ops_bitwise_rows_on_gpu(gpu):
    """Op by op, on the card, at xlstm-350m's widths (and mamba's
    read-out at jamba's): each op of the slot-batched decode step gives
    a row of a 4-row batch the bits it gives the row alone.  A miss
    names the op that breaks the engine's bit-identity."""
    from repro_torch.configs import registry
    cfg = registry.get("xlstm-350m")
    gen = torch.Generator(device=gpu).manual_seed(11)
    missed = set()
    with torch.inference_mode():
        # a kernel that sums in another order for 4 rows rounds to other
        # bf16 bits only now and then: many draws (the mLSTM gates'
        # batched projection missed once in 64 row-steps of the model)
        for _ in range(50):
            for label, fn, xs in _row_ops(cfg, gen, gpu):
                batch = fn(*xs)
                if not all(torch.equal(batch[b:b + 1],
                                       fn(*(x[b:b + 1] for x in xs)))
                           for b in range(4)):
                    missed.add(label)
    assert not missed, f"row-count dependent on the card: {missed}"


@pytest.mark.needs_cuda
def test_flash_attention_at_jamba_shape_on_gpu(gpu):
    """K7 at jamba's attention layer: 64 query heads over 8 K/V heads,
    d = 128 (the tensor-core route's widest rows), causal, bf16, on
    its tensor-core entry against its plain version."""
    gen = torch.Generator(device=gpu).manual_seed(128)
    T = 512
    q = torch.randn((64, T, 128), generator=gen, device=gpu).bfloat16()
    k, v = (torch.randn((8, T, 128), generator=gen, device=gpu).bfloat16()
            for _ in range(2))
    common.reset_launches()
    out = flash_attention_cuda(q, k, v, True)
    assert common.entry_counts()["flash_attention_wgmma_bf16"] == 1
    ref = attention_ref(q, k.repeat_interleave(8, 0),
                        v.repeat_interleave(8, 0), True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("label,C,D,F", [("up", 640, 8192, 24576),
                                         ("down", 640, 24576, 8192),
                                         ("decode up", 4, 8192, 24576)])
def test_gmm_at_jamba_width_on_gpu(gpu, label, C, D, F):
    """K8 at jamba's expert width (d_model 8192, d_ff 24576) with two
    experts, at the prefill's C = 640 (4 rows x 160) and a step's C = 4,
    on its tensor-core entry against its plain version."""
    gen = torch.Generator(device=gpu).manual_seed(C + D)
    x = torch.randn((2, C, D), generator=gen, device=gpu).bfloat16()
    w = (torch.randn((2, D, F), generator=gen, device=gpu)
         * D ** -0.5).bfloat16()
    common.reset_launches()
    out = gmm_cuda(x, w)
    assert common.entry_counts()["gmm_wgmma_bf16"] == 1
    torch.testing.assert_close(out.float(), gmm_torch(x, w).float(),
                               rtol=1e-2, atol=1e-2, msg=lambda m:
                               f"{label}: {m}")


@pytest.mark.needs_cuda
def test_jamba_greedy_tokens_kernel_path_against_plain_path(gpu):
    """jamba-1.5-large reduced(): ``generate`` launches K7 once (the
    attention layer's prefill) and K8 on its MoE layers at prefill and
    each step, all on the tensor-core entries, and gives the plain
    path's tokens under the margin rule."""
    from repro_torch.configs import registry
    from repro_torch.models import blocks, model_zoo
    from repro_torch.serve.serve_step import generate

    cfg = registry.get("jamba-1.5-large-398b").reduced()
    params = model_zoo.init(cfg, 0, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=gpu,
                           generator=gen)
    kinds, moe_flags, n_groups = blocks.group_layout(cfg)
    n_attn, n_moe = kinds.count("attn") * n_groups, sum(moe_flags) * n_groups
    common.reset_launches()
    out = generate(cfg, params, prompt, 8)
    passes = 1 + cfg.moe.overflow_passes
    assert common.launch_counts()["flash_attention"] == n_attn
    assert common.entry_counts()["flash_attention_wgmma_bf16"] == n_attn
    assert common.launch_counts()["gmm"] == 3 * passes * n_moe * 9
    assert common.entry_counts()["gmm_wgmma_bf16"] == 3 * passes * n_moe * 9
    with plain_kernels():
        plain, gaps, _ = greedy_with_gaps(cfg, params, prompt, 8)
    check_tokens(out, plain, gaps)


# ---------------------------------------------------------------------------
# the fleet (router, transport) on the card
# ---------------------------------------------------------------------------
@pytest.mark.needs_cuda
@pytest.mark.parametrize("wl,payload,entry", [
    ("hist", {"n": 1 << 20, "n_bins": 256}, "hist_priv_i32"),
    ("conv", {"size": 512, "ksize": 15}, "conv2d_reg_f32")])
def test_proc_worker_on_gpu_returns_what_a_local_scheduler_returns(
        gpu, fresh_serving, monkeypatch, tmp_path, wl, payload, entry):
    """A ``ProcWorker`` child on the real pair (its own CUDA context on
    cuda:0) returns, as a CPU tensor, bitwise the value a local
    ``Scheduler()`` returns from the card.  Both start from one store
    in which the card is far faster than the host for this request, so
    each places it dedicated on the card without a probe; the local
    future names its lane, and the child's heartbeat shows one dedicated
    execution, no probe and the request's C entry launched."""
    from repro_torch.core.calibration import get_calibration_cache
    from repro_torch.serve.router import Router
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.transport import ProcWorker
    from repro_torch.workloads import requests as adapters

    stores = {"REPRO_CALIB_CACHE": str(tmp_path / "calibration.json"),
              "REPRO_TUNE_CACHE": str(tmp_path / "autotune.json")}
    for k, v in stores.items():
        monkeypatch.setenv(k, v)
    cache = get_calibration_cache("torch:cuda")
    key = adapters.make_request(wl, payload).workload
    cache.put(key, "accel", 1e-9)
    cache.put(key, "host", 1.0)
    cache.flush()
    with Scheduler() as s:
        f = s.submit(wl, payload)
        local = _serve_value(f.result(timeout=300))
    assert f.meta["lane"] == "accel"
    w = ProcWorker("gpu-w", env=stores, hb_interval_s=0.2)
    r = Router([w], hb_timeout_s=30.0)
    try:
        r.start()
        got = r.submit(wl, payload).result(timeout=300)
        # the child counts the execution (dedicated or shared) just
        # after it sends the result
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            beat = r.refresh_stats(timeout=5.0)["gpu-w"]
            if beat.get("dedicated", 0) + beat.get("shared", 0) >= 1:
                break
            time.sleep(0.05)
    finally:
        r.shutdown(timeout=60.0)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert (beat["completed"], beat["dedicated"], beat["shared"],
            beat["probe_runs"]) == (1, 1, 0, 0)
    assert beat[f"entry_launches.{entry}"] > 0
    assert torch.equal(got, local)


@pytest.mark.needs_cuda
def test_kernel_lib_built_by_two_processes_at_once(gpu, tmp_path):
    """Two processes that call ``kernel_lib()`` at once into an empty
    build directory both load the library (the build runs under a
    file lock: one builds, the other waits and loads it) and launch a
    kernel from it."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, time\n"
        "import torch\n"
        "from repro_torch.kernels import common\n"
        "from repro_torch.core.cost_model import probe_add_one\n"
        "common.BUILD_DIR = sys.argv[1]\n"
        "t0 = time.time()\n"
        "common.kernel_lib()\n"
        "x = torch.zeros(128, 128, device='cuda')\n"
        "assert torch.equal(probe_add_one(x), x + 1)\n"
        "print('LOADED', time.time() - t0, len(common.build_log()))\n")
    src = os.path.dirname(os.path.dirname(common.__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(src))
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "LOADED" in out, out
    digests = [d for d in os.listdir(build) if os.path.isdir(build / d)]
    assert len(digests) == 1
    assert (build / digests[0] / "libkernels.so").is_file()
    assert (build / f"{digests[0]}.lock").is_file()
    print(outs)


# ---------------------------------------------------------------------------
# training (the route under autograd, the trainer on the card)
# ---------------------------------------------------------------------------
# the CPU parity tests' tolerances (tests/torch_train_parity.py): the
# loss; a gradient leaf's relative L2 error and cosine, or, for a leaf
# below NOISE of the whole gradient's norm, its error absolutely
TRAIN_LOSS_ATOL, TRAIN_GRAD_REL, TRAIN_GRAD_COS, TRAIN_NOISE = (
    0.01, 0.1, 0.99, 1e-4)
TRAIN_ROUTER_TIE = 0.01


def _pinned_top_k(monkeypatch, orig, forced=None):
    """The MoE's top-k ``orig`` recorded (or, with ``forced``, replaced
    call by call by ``forced``'s); returns (own choices,
    probabilities)."""
    from repro_torch.models import moe

    own, probs_seen = [], []

    def top_k(probs, k):
        vals, idx = orig(probs, k)
        own.append(idx.cpu())
        probs_seen.append(probs.detach().float().cpu())
        if forced is None:
            return vals, idx
        idx = forced[len(own) - 1].to(probs.device)
        return torch.gather(probs, -1, idx), idx

    monkeypatch.setattr(moe, "_top_k", top_k)
    return own, probs_seen


@pytest.mark.needs_cuda
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "h2o-danube-1.8b"])
def test_train_grads_on_gpu_match_the_cpus(gpu, arch, monkeypatch):
    """``loss_fn``'s value and gradients on the card against the CPU's
    from the same f32 weights, the card's MoE layers on the CPU's
    experts (its own choices differing only at near-ties); K7 and K8
    never launch under autograd."""
    from repro_torch.configs import registry
    from repro_torch.core.tree import flatten_with_path, leaves, unflatten
    from repro_torch.models import model_zoo, moe
    from repro_torch.train.train_step import to_batch, value_and_grad

    cfg = registry.get(arch).reduced()
    cpu = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    card = unflatten(cpu, [p.to(gpu) for p in leaves(cpu)])
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 64),
                                             dtype=np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    top_k = moe._top_k
    ref_idx, probs = _pinned_top_k(monkeypatch, top_k)
    loss_c, _, g_c = value_and_grad(cpu, to_batch(b, "cpu"), cfg)
    own, _ = _pinned_top_k(monkeypatch, top_k, forced=ref_idx)
    common.reset_launches()
    loss_g, _, g_g = value_and_grad(card, to_batch(b, gpu), cfg)
    torch.cuda.synchronize()
    assert common.launch_counts()["flash_attention"] == 0
    assert common.launch_counts()["gmm"] == 0
    assert len(own) == len(ref_idx)
    for r, o, p in zip(ref_idx, own, probs):
        k = r.shape[-1]
        for at in np.argwhere((np.sort(r.numpy(), -1)
                               != np.sort(o.numpy(), -1)).any(-1)):
            srt = np.sort(p[tuple(at)].numpy())[::-1]
            assert srt[k - 1] - srt[k] < TRAIN_ROUTER_TIE
    assert abs(float(loss_g) - float(loss_c)) <= TRAIN_LOSS_ATOL
    total = float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                 for x in leaves(g_c))))
    for (path, a), c in zip(flatten_with_path(g_g), leaves(g_c)):
        a, c = a.double().cpu().flatten(), c.double().flatten()
        nc, err = float(c.norm()), float((a - c).norm())
        if nc < TRAIN_NOISE * total:
            assert err <= TRAIN_NOISE * total, path
            continue
        cos = float(a @ c) / max(float(a.norm()) * nc, 1e-30)
        assert err / nc <= TRAIN_GRAD_REL and cos >= TRAIN_GRAD_COS, path


@pytest.mark.needs_cuda
def test_no_grad_forward_launches_k7_and_k8_on_gpu(gpu):
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo

    cfg = registry.get("kimi-k2-1t-a32b").reduced()
    params = model_zoo.init(cfg, 0, device=gpu, dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=gpu)
    common.reset_launches()
    with torch.no_grad():
        logits, _ = model_zoo.forward(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    counts = common.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["gmm"] > 0
    assert torch.isfinite(logits.float()).all()


@pytest.mark.needs_cuda
def test_kernels_raise_on_inputs_that_require_grad(gpu):
    q = torch.randn((4, 64, 64), device=gpu, dtype=torch.bfloat16)
    x = torch.randn((2, 64, 64), device=gpu, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="differentiable"):
        flash_attention_cuda(q.clone().requires_grad_(), q, q)
    with pytest.raises(NotImplementedError, match="differentiable"):
        gmm_cuda(x, x.clone().requires_grad_())


@pytest.mark.needs_cuda
def test_trainer_on_gpu_matches_the_cpu_then_serves_with_k7(gpu):
    """The trainer on the GPU + CPU pair (every micro-batch on the card)
    against the simulated pair on the CPU from the same weights: the
    same plans, losses within 0.02; then ``generate`` on the trained
    f32 weights launches K7 on its tensor-core route."""
    from repro_torch.configs.base import ArchConfig, ParallelConfig
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.ft.failure import FailureInjector
    from repro_torch.models import model_zoo
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.serve.serve_step import generate
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                     n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
                     head_dim=64, parallel=ParallelConfig(remat="dots"))
    init = model_zoo.init(cfg, 0, device="cpu", dtype=torch.float32)
    hist, trained = {}, {}
    for where in ("cuda", "cpu"):
        params = unflatten(init, [p.clone().to(where) for p in leaves(init)])
        tr = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=50),
                     DataConfig(vocab_size=512, seq_len=32, micro_batch=2),
                     TrainerConfig(accum_units=4, steps=4,
                                   time_model=lambda g, k: k * (
                                       0.001 if g == "accel" else 0.004)),
                     injector=FailureInjector(kill={1: "host"},
                                              revive={2: "host"}),
                     device="cpu" if where == "cpu" else None)
        assert tr.device.type == where
        out = tr.run({"params": params,
                      "opt": init_opt_state(tr.opt_cfg, params)})
        hist[where], trained[where] = out["history"], out["params"]
    for a, b in zip(hist["cuda"], hist["cpu"]):
        assert (a.units, a.executed_units) == (b.units, b.executed_units)
        assert abs(a.loss - b.loss) <= 0.02
    common.reset_launches()
    toks = generate(cfg, trained["cuda"],
                    torch.ones((2, 64), dtype=torch.int64, device=gpu), 4)
    counts, entries = common.launch_counts(), common.entry_counts()
    assert counts["flash_attention"] > 0
    assert entries["flash_attention_wgmma_bf16"] == counts["flash_attention"]
    assert bool((toks >= 0).all()) and bool((toks < 512).all())
