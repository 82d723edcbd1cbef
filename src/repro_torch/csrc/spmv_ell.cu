// K3: ELL sparse matrix-vector product, f32:
//   y[r] = sum_k vals[r, k] * x[idx[r, k]]   over a zero-padded (R, K) block.
//
// Replaces the TPU kernel spmv_ell_pallas (src/repro/kernels/spmv/
// spmv.py, body _spmv_kernel), which streams (row_tile, K) tiles through
// VMEM with x resident there (so x had to fit VMEM).
//
// Bound on an H100: it must read 8*R*K bytes of vals and idx, write 4*R
// bytes of y and read x (4*C) once, at 3.35 TB/s; 2*R*K FLOP is far
// below the f32 rate, so it is memory-bound.
//
// Design: one warp per row.  The 32 lanes walk the row's K slots with a
// stride of 32, so vals and idx are read coalesced in their row-major
// layout; x is gathered through L1/L2 (no residency limit on C); the
// lane partial sums meet in a shuffle reduction.  A power-law ELL head
// has rows of a few thousand slots beside rows of a few dozen, and a warp
// per row keeps long rows parallel.  An index outside [0, C) contributes
// nothing.  Ragged R is masked.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void spmv_ell_kernel(const float* __restrict__ vals,
                                const int* __restrict__ idx,
                                const float* __restrict__ x,
                                float* __restrict__ y, int R, int K, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const float* v = vals + static_cast<long long>(row) * K;
  const int* c = idx + static_cast<long long>(row) * K;
  float acc = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const int col = c[k];
    if (static_cast<unsigned>(col) < static_cast<unsigned>(C))
      acc = fmaf(v[k], __ldg(x + col), acc);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" int spmv_ell_f32(const float* vals, const int* idx,
                            const float* x, float* y, int R, int K, int C,
                            void* stream) {
  const int blocks = (R + WARPS - 1) / WARPS;
  if (blocks > 0)
    spmv_ell_kernel<<<blocks, 32 * WARPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(vals, idx, x, y,
                                                           R, K, C);
  return static_cast<int>(cudaGetLastError());
}
