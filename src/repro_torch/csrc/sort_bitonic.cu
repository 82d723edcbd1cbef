// K5: ascending sort of every row of a contiguous (G, L) f32 array, L a
// power of two from 2 to 8192.
//
// Replaces the TPU kernel sort_rows_pallas (src/repro/kernels/
// sort_bitonic/sort_bitonic.py:58, body _bitonic_rows): each grid step
// there sorted a 256-row tile in VMEM with log2(L)*(log2(L)+1)/2
// vectorised compare-exchange sweeps, partners found by reshape + flip.
//
// Bound on an H100: it must read and write 4*G*L bytes each, at 3.35
// TB/s, against G*L/2 compare-exchanges per stage on the CUDA cores; at
// L = 1024 (55 stages) the bytes bound it, by ~3x.  What held the first
// version back was not the bytes but its 55 shared-memory sweeps a row,
// each behind a block barrier.
//
// Design: the network lives in registers.  Thread t of a block holds the
// E = 8 consecutive elements t*E .. t*E+7 of the block's slice of the
// flat array (a block takes max(L, 1024) elements: one row, or several
// short ones), read and written once as two float4 a thread.  A stage
// (k, j) pairs element i with i ^ j, i the index within the row, and
// keeps the minimum where (i & j == 0) == (i & k == 0), so:
//   * j < E: both elements are the thread's own; a register exchange;
//   * E <= j < 32*E: the partner is slot e of lane (lane ^ j/E) of the
//     same warp, taken with __shfl_xor_sync; no barrier;
//   * j >= 32*E (only L > 256): through shared memory, stored striped
//     (slot e of thread t at e*T + t, so a warp's stores and loads hit
//     32 banks), one barrier after the stores and one before the next
//     stage's.  For L = 1024 that is 3 of the 55 stages.
// L is a template argument (one kernel per row length), so every stage
// unrolls: register indices, shuffle distances and the kind of each
// stage are constants, and nothing branches.  For k >= E the direction
// is one bit of the thread's own index, shared by every partner it
// meets at that k; a thread whose elements sort descending at k flips
// their sign bits instead (a < b exactly when -b < -a), so each of its
// register exchanges is one compare and two selects, and flips them
// back at the next k.  A partner never leaves its row (j < L), so packed
// short rows and the padding past the last row (whole rows, never
// stored) do not mix, and every lane of a warp takes part in every
// shuffle.  The exchange is the plain version's strict-< select (never
// fminf / fmaxf): the result is bitwise the plain network's, the order
// of -0.0 and 0.0 included, and equals torch.sort's under == (+inf
// padding included).  Inputs hold no NaN.  A per-row transpose through
// shared memory that makes the large-j stages thread-local was the
// alternative; it needs the same barriers and two more full passes
// through shared memory a row, so the exchange-in-place design was
// kept.  A first version of this design with L a runtime value left
// the compiler branching around the register swaps and moving registers
// between loop iterations; it was ~1.4x slower (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int E = 8;                      // elements a thread holds
constexpr int WARP_ELEMS = 32 * E;        // stages with j below stay in a warp
constexpr int MIN_BLOCK_ELEMS = 1024;     // short rows pack several to a block
constexpr unsigned FULL = 0xffffffffu;

// the value element x keeps after meeting partner p: the plain version's
// lo = (p < x) ? p : x and hi = (x < p) ? p : x
__device__ __forceinline__ float keep(float x, float p, bool keep_min) {
  const float lo = (p < x) ? p : x;
  const float hi = (x < p) ? p : x;
  return keep_min ? lo : hi;
}

__device__ __forceinline__ float flip_sign(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

template <int L>
__global__ void __launch_bounds__((L > MIN_BLOCK_ELEMS ? L : MIN_BLOCK_ELEMS)
                                  / E)
sort_rows_reg_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long total, int vec) {
  constexpr int BLOCK_ELEMS = L > MIN_BLOCK_ELEMS ? L : MIN_BLOCK_ELEMS;
  constexpr int T = BLOCK_ELEMS / E;
  extern __shared__ float s[];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * BLOCK_ELEMS;
  const long long left = total - base;
  const int n = left < BLOCK_ELEMS ? static_cast<int>(left)
                                   : BLOCK_ELEMS;   // whole rows
  const int f0 = t * E;             // block-local index of v[0]
  float v[E];
  if (vec && f0 + E <= n) {
    const float4* src = reinterpret_cast<const float4*>(x + base + f0);
    const float4 a = src[0], b = src[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = f0 + e < n ? x[base + f0 + e] : 0.0f;
  }

  // The block's slice starts on a row boundary and f0 is a multiple of
  // E, so slot e's in-row index is in_row | e (e & (L - 1) when L < E).
  const int in_row = f0 & (L - 1);
  unsigned sign = 0;                // the sign bit the values carry
  bool shared_used = false;
#pragma unroll
  for (int k = 2; k <= L; k <<= 1) {
    // k >= E below the last stage: one direction for the thread, bit k
    // of in_row; descending threads sort their negated values ascending
    const bool flipped = k >= E && k < L;
    const unsigned want = flipped && (in_row & k) ? 0x80000000u : 0u;
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = flip_sign(v[e], want ^ sign);
    sign = want;
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1) {
      if (j >= WARP_ELEMS) {
        const bool keep_min = (in_row & j) == 0;
        const int pt = t ^ (j / E);
        if (shared_used) __syncthreads();   // the last stage's loads are done
#pragma unroll
        for (int e = 0; e < E; ++e) s[e * T + t] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[e] = keep(v[e], s[e * T + pt], keep_min);
        shared_used = true;
      } else if (j >= E) {
        const bool keep_min = (in_row & j) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[e] = keep(v[e], __shfl_xor_sync(FULL, v[e], j / E), keep_min);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          // k < E: the direction is slot e's own (bit k of e), ascending
          // at a row's last stage
          const bool ascending = k >= E || k == L || !(e & k);
          const float a = v[e], b = v[e + j];
          v[e] = keep(a, b, ascending);
          v[e + j] = keep(b, a, !ascending);
        }
      }
    }
  }

  if (vec && f0 + E <= n) {
    float4* dst = reinterpret_cast<float4*>(out + base + f0);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (f0 + e < n) out[base + f0 + e] = v[e];
  }
}

template <int L>
int launch(const float* x, float* out, long long G, cudaStream_t stream) {
  constexpr int BLOCK_ELEMS = L > MIN_BLOCK_ELEMS ? L : MIN_BLOCK_ELEMS;
  const long long total = G * L;
  const long long blocks = (total + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
  const size_t smem = L > WARP_ELEMS ? sizeof(float) * BLOCK_ELEMS : 0;
  const int vec = ((reinterpret_cast<std::uintptr_t>(x) |
                    reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  sort_rows_reg_kernel<L><<<static_cast<unsigned>(blocks), BLOCK_ELEMS / E,
                            smem, stream>>>(x, out, total, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L >= 2, a power of two, at most 8192; G >= 1: the wrapper checks them
extern "C" int sort_rows_reg_f32(const float* x, float* out, long long G,
                                 int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2: return launch<2>(x, out, G, s);
    case 4: return launch<4>(x, out, G, s);
    case 8: return launch<8>(x, out, G, s);
    case 16: return launch<16>(x, out, G, s);
    case 32: return launch<32>(x, out, G, s);
    case 64: return launch<64>(x, out, G, s);
    case 128: return launch<128>(x, out, G, s);
    case 256: return launch<256>(x, out, G, s);
    case 512: return launch<512>(x, out, G, s);
    case 1024: return launch<1024>(x, out, G, s);
    case 2048: return launch<2048>(x, out, G, s);
    case 4096: return launch<4096>(x, out, G, s);
    case 8192: return launch<8192>(x, out, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
