// K2: histogram of int32 keys into n_bins int32 counts.
//
// Replaces the TPU kernel hist_pallas (src/repro/kernels/hist/hist.py:51,
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
// Two routes, picked by the wrapper (hist.route):
//
// hist_priv_i32, n_bins <= 1816 (32 replicas of every counter fit the
// 227 KB a block may hold; both main-path shapes, 256 and 64 bins): one
// 1024-thread block an SM.  Counter (bin, l) of the block lives at
// h[bin * 32 + l] and lane l of every warp counts only into replica l,
// so whatever the keys (all in one bin included) no two lanes of a warp
// share a bank or an address: each warp atomic is one wavefront, where
// 256 bins on 32 banks put 3-4 lanes of a warp on the busiest bank.  A
// thread keeps 4 independent 16-byte loads (64 B, 64 KB an SM) in flight
// and issues the next trip's before it counts the current one, the first
// trip's before the block zeroes its counters.  Then a thread folds a
// bin's 32 replicas, reading them in a skewed order ((j + lane) & 31: a
// straight walk would put the 32 lanes of a warp on one bank), and adds
// the sum to `out` with one atomicAdd per nonzero bin: ~132 adds per
// global counter, not 528.  `out` needs no memset launch: the first
// block of a launch to start (the one whose atomicMax raises the
// stream's launch number to this launch's) zeroes it and publishes the
// number (warp 0 alone: the other warps go on counting), and every block
// waits for that before its adds, the mark's first read issued before
// the fold.  That block waits for no other, so the waits end however the
// blocks are scheduled, and at the main shape they come ~5 us after the
// zeroing.
// The launch numbers live in a buffer the wrapper keeps per (device,
// stream) and increments under a lock around the launch: launches on one
// stream run in order, and two streams never share a buffer.  A first
// version that had the last block to finish (a ticket) move a
// per-stream accumulator into `out` put a serial tail (fence, ticket,
// exchange) at the end of every launch and was slower (PERF.md).  Above 384
// bins the block needs more than 48 KB of shared memory: the entry opts
// in once per device.
//
// hist_i32, more bins (PR 11's kernel): a grid-stride loop over at most a
// few blocks per SM, each block counting into one shared-memory counter a
// bin, merged into the global output with one atomicAdd per bin; the
// wrapper zeroes `out`.
//
// Both read the keys coalesced, 16 bytes a load where the slice allows
// (a slice may start off a 16-byte boundary: < 4 head keys, the aligned
// int4 body, < 4 tail keys).  Keys outside [0, n_bins) count nowhere, as
// in the one-hot kernel.  Integer counts are exact in any order.
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


constexpr int PRIV_THREADS = 1024;
constexpr int PRIV_UNROLL = 4;                  // int4 loads in flight
constexpr int PRIV_SMEM_MAX = 232448;           // 227 KB: 1816 bins
static_assert(PRIV_SMEM_MAX / 128 <= 2 * PRIV_THREADS, "two bins a thread");

__device__ __forceinline__ void count_priv(int* hl, int v, unsigned nb) {
  if (static_cast<unsigned>(v) < nb) atomicAdd(&hl[v << 5], 1);
}

__device__ __forceinline__ void count_priv4(int* hl, int4 v, unsigned nb) {
  count_priv(hl, v.x, nb);
  count_priv(hl, v.y, nb);
  count_priv(hl, v.z, nb);
  count_priv(hl, v.w, nb);
}

// this thread's int4 of trip i, or keys that count nowhere past the end
__device__ __forceinline__ void load_trip(const int4* __restrict__ x4,
                                          long long i, long long n4,
                                          int4 (&v)[PRIV_UNROLL]) {
#pragma unroll
  for (int k = 0; k < PRIV_UNROLL; ++k)
    v[k] = i + k * PRIV_THREADS < n4 ? __ldg(x4 + i + k * PRIV_THREADS)
                                     : make_int4(-1, -1, -1, -1);
}

// state[0]: the highest launch number started on this stream; state[1]:
// the highest whose `out` is zeroed.  seq: this launch's number (the
// wrapper's, strictly increasing on one stream).
__global__ void __launch_bounds__(PRIV_THREADS, 1)
hist_priv_kernel(const int* __restrict__ x, long long n, int n_bins,
                 int* __restrict__ out, unsigned long long* state,
                 unsigned long long seq) {
  extern __shared__ int4 hs4[];               // no static shared memory
  int* h = reinterpret_cast<int*>(hs4);       // (n_bins, 32) replicas
  const int lane = threadIdx.x & 31;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x);
  long long head = static_cast<long long>(((16 - (addr & 15)) & 15) >> 2);
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  const long long tail0 = head + n4 * 4;
  const int4* x4 = reinterpret_cast<const int4*>(x + head);
  const long long stride =
      static_cast<long long>(gridDim.x) * PRIV_UNROLL * PRIV_THREADS;
  long long i = blockIdx.x * static_cast<long long>(PRIV_UNROLL) *
                    PRIV_THREADS + threadIdx.x;
  // the first trip's loads are in flight while the block sets up
  int4 cur[PRIV_UNROLL];
  load_trip(x4, i, n4, cur);
  unsigned long long started = 0;
  if (threadIdx.x == 0) started = atomicMax(state, seq);
  for (int j = threadIdx.x; j < n_bins * 8; j += PRIV_THREADS)
    hs4[j] = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (threadIdx.x < 32 && __shfl_sync(0xffffffffu, started, 0) < seq) {
    // warp 0 of the first block of this launch to start zeroes `out` and
    // says so; it waits for no other block, so every wait below ends
    for (int b = threadIdx.x; b < n_bins; b += 32) out[b] = 0;
    __threadfence();
    __syncwarp();
    if (threadIdx.x == 0) atomicExch(state + 1, seq);
  }

  int* hl = h + lane;
  const unsigned nb = static_cast<unsigned>(n_bins);
  while (i < n4) {
    const long long next = i + stride;
    int4 nxt[PRIV_UNROLL];
    load_trip(x4, next, n4, nxt);
#pragma unroll
    for (int k = 0; k < PRIV_UNROLL; ++k) count_priv4(hl, cur[k], nb);
#pragma unroll
    for (int k = 0; k < PRIV_UNROLL; ++k) cur[k] = nxt[k];
    i = next;
  }
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) count_priv(hl, x[t], nb);
    if (t >= 4 && t < 8 && t - 4 < n - tail0)
      count_priv(hl, x[tail0 + t - 4], nb);
  }
  // the first read of the zeroed mark overlaps the barrier and the fold
  volatile unsigned long long* zeroed = state + 1;
  unsigned long long seen = threadIdx.x == 0 ? *zeroed : seq;
  __syncthreads();

  // bins tid and tid + 1024 (n_bins <= 1816)
  int sum[2] = {0, 0};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int b = threadIdx.x + m * PRIV_THREADS;
    if (b < n_bins) {
      const int* row = h + b * 32;              // b & 31 == lane
#pragma unroll
      for (int j = 0; j < 32; ++j) sum[m] += row[(j + lane) & 31];
    }
  }
  if (threadIdx.x == 0) {
    while (seen < seq) seen = *zeroed;
    __threadfence();
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
    if (sum[m]) atomicAdd(&out[threadIdx.x + m * PRIV_THREADS], sum[m]);
}

}  // namespace

// n_bins <= 1816: the wrapper's route checks it.  max_blocks: the SM
// count, which the wrapper reads once per device (the blocks need not
// all be resident at once); state: the (device, stream)'s two launch
// numbers, zeroed once; seq: this launch's number, larger than any
// before it on the stream.
extern "C" int hist_priv_i32(const int* x, long long n, int n_bins,
                             int max_blocks, int* out,
                             unsigned long long* state,
                             unsigned long long seq, void* stream) {
  static bool opted_in[64] = {};
  const size_t smem = sizeof(int) * 32 * static_cast<size_t>(n_bins);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev < 64 && !opted_in[dev]) {
      err = cudaFuncSetAttribute(hist_priv_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 PRIV_SMEM_MAX);
      if (err == cudaSuccess) opted_in[dev] = true;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block =
      static_cast<long long>(PRIV_UNROLL) * PRIV_THREADS;
  const long long need = (n / 4 + per_block - 1) / per_block;
  long long blocks = need < 1 ? 1 : need;
  if (blocks > max_blocks) blocks = max_blocks;
  hist_priv_kernel<<<static_cast<int>(blocks), PRIV_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(x, n, n_bins, out,
                                                          state, seq);
  return static_cast<int>(cudaGetLastError());
}

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
