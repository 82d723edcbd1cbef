// K2: histogram of int32 keys into n_bins int32 counts.
//
// Replaces the TPU kernel hist_pallas (src/repro/kernels/hist/hist.py,
// body _hist_kernel).  The TPU has no atomics, so there each grid tile
// sums a one-hot (tile, bin_block) compare and partials accumulate
// across the sequential grid.  Hopper has fast shared-memory atomics:
// this is the paper's own CUDA method (per-block privatised histograms
// merged into the global bins).
//
// Bound on an H100: it must read 4*N bytes of keys (and write 4*n_bins),
// at 3.35 TB/s; one add per key is far below the ALU rate, so it is
// memory-bound.
//
// Design: a grid-stride loop over at most a few blocks per SM, each
// block counting into its own __shared__ histogram with atomicAdd (int
// counters, exact in any order), then merging its nonzero bins into the
// global output with one atomicAdd per bin.  Keys are read coalesced, 16
// bytes per thread where the tail allows.  Keys outside [0, n_bins)
// count nowhere, as in the one-hot kernel.  The wrapper zeroes `out`.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void count(int* h, int v, int n_bins) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(n_bins))
    atomicAdd(&h[v], 1);
}

__global__ void hist_kernel(const int* __restrict__ x, long long n,
                            int n_bins, int* __restrict__ out) {
  extern __shared__ int h[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) h[i] = 0;
  __syncthreads();

  // a slice may start off a 16-byte boundary: < 4 head keys, then the
  // aligned int4 body, then < 4 tail keys
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x);
  long long head = static_cast<long long>(((16 - (addr & 15)) & 15) >> 2);
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  const long long tail0 = head + n4 * 4;
  const int4* x4 = reinterpret_cast<const int4*>(x + head);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += stride) {
    const int4 v = x4[i];
    count(h, v.x, n_bins);
    count(h, v.y, n_bins);
    count(h, v.z, n_bins);
    count(h, v.w, n_bins);
  }
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) count(h, x[t], n_bins);
    if (t >= 4 && t - 4 < n - tail0) count(h, x[tail0 + t - 4], n_bins);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = h[i];
    if (c) atomicAdd(&out[i], c);
  }
}

}  // namespace

// max_blocks: the wrapper passes a few blocks per SM, from the device's
// properties that it reads once, so a launch makes no attribute query
extern "C" int hist_i32(const int* x, long long n, int n_bins,
                        int max_blocks, int* out, void* stream) {
  const long long need = (n / 4 + THREADS - 1) / THREADS;  // int4 per thread
  long long blocks = need < 1 ? 1 : need;
  if (blocks > max_blocks) blocks = max_blocks;
  hist_kernel<<<static_cast<int>(blocks), THREADS, sizeof(int) * n_bins,
                static_cast<cudaStream_t>(stream)>>>(x, n, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}
