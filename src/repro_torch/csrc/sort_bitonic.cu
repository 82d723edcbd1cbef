// K5: ascending sort of every row of a contiguous (G, L) f32 array, L a
// power of two (at most 8192: one row must fit one block's shared memory).
//
// Replaces the TPU kernel sort_rows_pallas (src/repro/kernels/
// sort_bitonic/sort_bitonic.py:58, body _bitonic_rows): each grid step
// there sorted a 256-row tile in VMEM with log2(L)*(log2(L)+1)/2
// vectorised compare-exchange sweeps, partners found by reshape + flip.
//
// Bound on an H100: it must read and write 4*G*L bytes each, at 3.35
// TB/s, against G*L/2 compare-exchanges per stage on the CUDA cores; at
// L = 1024 (55 stages) the bytes bound it, by ~3x.
//
// Design: one block sorts whole rows in shared memory, so device memory
// is read once and written once (coalesced) and every stage runs out of
// shared memory.  A row of L <= 1024 floats is 4 KB; short rows are
// packed several to a block (at least 1024 elements a block) so a block
// has enough threads.  Each thread takes one or more compare-exchange
// pairs per stage, with a __syncthreads() between stages.  The pair of
// lane i is i ^ j, its direction ascending where (i & k) == 0.  A pair
// swaps only when one value is strictly less than the other (no fminf /
// fmaxf): the plain version makes the same exchanges, and the result
// equals torch.sort's under == (+inf padding included).  -0.0 and 0.0
// compare equal, so they stay where the network leaves them, which need
// not be torch.sort's order.  Inputs hold no NaN.  Simple first: no
// register or warp-shuffle stages.
#include <cuda_runtime.h>

namespace {

constexpr int MIN_BLOCK_ELEMS = 1024;
constexpr int MAX_THREADS = 512;

__global__ void sort_rows_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, long long G,
                                 int L, int rows_per_block) {
  extern __shared__ float s[];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long left = G - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const int n = rows * L;
  const long long base = row0 * L;
  for (int e = threadIdx.x; e < n; e += blockDim.x) s[e] = x[base + e];

  const int half = L >> 1;               // pairs per row
  const int half_shift = __ffs(half) - 1;
  const int pairs = rows * half;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int row = p >> half_shift;
        const int q = p & (half - 1);
        // lower lane of the pair: bit j of q's position left clear
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        float* v = s + row * L;
        const float a = v[i];
        const float b = v[i + j];
        const bool ascending = (i & k) == 0;
        if (ascending ? (b < a) : (a < b)) {
          v[i] = b;
          v[i + j] = a;
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[base + e] = s[e];
}

}  // namespace

// L >= 2 and a power of two, G >= 1: the wrapper checks both
extern "C" int sort_rows_f32(const float* x, float* out, long long G, int L,
                             void* stream) {
  const int rows_per_block = L >= MIN_BLOCK_ELEMS ? 1 : MIN_BLOCK_ELEMS / L;
  const long long blocks = (G + rows_per_block - 1) / rows_per_block;
  int threads = rows_per_block * (L / 2);
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = sizeof(float) * rows_per_block * L;
  sort_rows_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, out, G, L, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
