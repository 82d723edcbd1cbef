"""The hand-written CUDA kernels on the card, against their plain
PyTorch versions (``ref.py`` or the CPU peer run on the GPU).

Every test here is marked ``needs_cuda`` and skips, with its reason,
where there is no CUDA GPU.  The file imports no JAX, so it runs on a
GPU host that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances as in the kernel tests: hist and the probe exact, spmv 2e-5,
conv 2e-4 (f32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import probe_add_one
from repro_torch.kernels import common
from repro_torch.kernels.conv2d.conv2d import conv2d_cuda, conv2d_shift_add
from repro_torch.kernels.hist.hist import hist_cuda
from repro_torch.kernels.hist.ref import hist_ref
from repro_torch.kernels.spmv.ref import spmv_ell_ref
from repro_torch.kernels.spmv.spmv import spmv_ell_cuda


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
@pytest.mark.parametrize("name", ["conv", "hist", "spmv"])
def test_run_hybrid_on_gpu_and_cpu(gpu, name):
    """The real pair: accel on the GPU, host on the CPU, in threads
    mode, with a forced split so both lanes execute; the value matches
    the CPU reference."""
    from repro_torch.core.hybrid_executor import HybridExecutor
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.workloads import conv, hist, spmv

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
