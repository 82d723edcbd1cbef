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
import numpy as np
import pytest
import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import probe_add_one
from repro_torch.core.host_offload import bilateral_luts
from repro_torch.kernels import common
from repro_torch.kernels.bilateral import bilateral as bilateral_kernel
from repro_torch.kernels.bilateral.bilateral import (bilateral_cuda,
                                                     bilateral_lut_torch)
from repro_torch.kernels.conv2d import conv2d as conv_kernel
from repro_torch.kernels.conv2d.conv2d import conv2d_cuda, conv2d_shift_add
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gmm.gmm import gmm_cuda, gmm_torch
from repro_torch.kernels.hist import hist as hist_kernel
from repro_torch.kernels.hist.hist import hist_cuda
from repro_torch.kernels.hist.ref import hist_ref
from repro_torch.kernels.sort_bitonic.sort_bitonic import (
    bitonic_rows_torch, sort_rows_cuda)
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
