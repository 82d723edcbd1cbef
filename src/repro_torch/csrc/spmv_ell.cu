// K3: ELL sparse matrix-vector product, f32:
//   y[r] = sum_k vals[r, k] * x[idx[r, k]]   over a zero-padded (R, K) block.
//
// Replaces the TPU kernel spmv_ell_pallas (src/repro/kernels/spmv/
// spmv.py, body _spmv_kernel), which streams (row_tile, K) tiles through
// VMEM with x resident there (so x had to fit VMEM).
//
// Bound on an H100: it must read 8*R*K bytes of vals and idx, write 4*R
// bytes of y and read x (4*C) once, at 3.35 TB/s; 2*R*K FLOP is far
// below the f32 rate, so it is memory-bound.  The main path's heavy tile
// (R = 512, K = 3451, C = 8192) moves 8*512*3451 + 4*512 + 4*8192 =
// 14.2 MB: 0.00423 ms.
//
// spmv_ell_seg_f32 (the route for every K): TPR threads a row, TPR in
// {32, 64, 128, 256} a template argument chosen by spmv.route(K), 256/TPR
// rows a 256-thread block.  In ELL every row of a tile has K slots (the
// light rows are padded like the heavy ones), so rows need no balancing;
// what the card needs is enough blocks and bytes in flight.  At the heavy
// tile TPR = 256 gives 512 blocks, ~3.9 an SM (all resident in one wave),
// and every thread issues its whole row share at once: up to 4 float4 of
// vals and 4 int4 of idx (3.4 of each on average at K = 3451, ~108 bytes
// a thread), ~27.6 KB a block, ~107 KB an SM in flight, before any gather
// or FMA.  The light tiles (K = 68-98) take TPR = 32: one 16-byte load of
// each stream a lane, 64 blocks.  The thresholds (32 threads a row up to
// K = 512, 64 up to 1024, 128 up to 2048, 256 beyond) come from
// chip_smoke.py's sweep of all four at 512 rows (H100 80GB HBM3, 700 W):
// at K = 3451 256 / 128 / 64 / 32 took 0.0121 / 0.0126 / 0.0156 / 0.0229
// ms, at K = 2048 128 and 256 0.0107, at 1024 64 0.0094 (the others
// 0.0095-0.0108), at 512 and below all four within 0.0003 ms (K = 98:
// 0.0075).
//   Row r starts at element r*K, so at K = 3451 every 16-byte phase
// occurs: each row has a scalar head up to the first 16-byte boundary of
// its vals row (computed from the pointer, so offset views work), a
// float4/int4 body and a scalar tail.  When vals and idx lie in different
// 16-byte phases no row has a common boundary, and the route launches the
// scalar instantiation (VEC = false, 16 scalar loads of each stream a
// thread a trip).  vals and idx are streamed with evict-first loads
// (__ldcs), x is gathered through the read-only path (__ldg): at C = 8192
// it is 32 KB and stays in L1/L2.  x is not staged in shared memory: 512
// blocks x 32 KB would move more from L2 than the heavy tile's whole
// stream.
//   The sum is fixed: each thread adds its slots in order (head, body,
// tail) with fmaf, then a warp shuffle tree, then the warps of a row in
// warp order through shared memory; no atomics, so two calls on the same
// inputs are bitwise equal.  An in-range slot is FMA'd even when its
// value is 0, as the reference's vals * x[idx] multiplies it (a NaN or
// inf in x[0] shows through the zero padding there too); an index
// outside [0, C) contributes nothing and issues no gather.
//
// spmv_ell_f32 (the first version, kept for the same-run comparison;
// no route takes it): one warp a row, 8 rows a block, one 4-byte load of
// each stream a lane per step of 32 slots.  The 512-row tile is 64 blocks
// on 132 SMs.
#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int SEG_THREADS = 256;
constexpr int SEG_TRIP = 4;      // 16-byte loads of each stream a trip

__device__ __forceinline__ float add_slot(float acc, float v, int col,
                                          const float* __restrict__ x,
                                          int C) {
  if (static_cast<unsigned>(col) < static_cast<unsigned>(C))
    acc = fmaf(v, __ldg(x + col), acc);
  return acc;
}

template <int TPR, bool VEC>
__global__ void __launch_bounds__(SEG_THREADS)
    spmv_ell_seg_kernel(const float* __restrict__ vals,
                        const int* __restrict__ idx,
                        const float* __restrict__ x, float* __restrict__ y,
                        int R, int K, int C) {
  constexpr int RPB = SEG_THREADS / TPR;   // rows a block
  constexpr int WPR = TPR / 32;            // warps a row
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  float acc = 0.0f;
  if (row < R) {
    const float* v = vals + static_cast<long long>(row) * K;
    const int* c = idx + static_cast<long long>(row) * K;
    if constexpr (VEC) {
      // slots before the row's first 16-byte boundary (0-3)
      const int head = min(static_cast<int>(
          ((16u - (static_cast<unsigned>(reinterpret_cast<uintptr_t>(v)) &
                   15u)) & 15u) >> 2), K);
      if (t < head) acc = add_slot(acc, __ldcs(v + t), __ldcs(c + t), x, C);
      const int n4 = (K - head) >> 2;
      const float4* v4 = reinterpret_cast<const float4*>(v + head);
      const int4* c4 = reinterpret_cast<const int4*>(c + head);
      for (int b = t; b < n4; b += SEG_TRIP * TPR) {
        float4 a[SEG_TRIP];
        int4 j[SEG_TRIP];
#pragma unroll
        for (int u = 0; u < SEG_TRIP; ++u) {
          const int q = b + u * TPR;
          if (q < n4) {
            a[u] = __ldcs(v4 + q);
            j[u] = __ldcs(c4 + q);
          } else {
            a[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            j[u] = make_int4(-1, -1, -1, -1);
          }
        }
#pragma unroll
        for (int u = 0; u < SEG_TRIP; ++u) {
          acc = add_slot(acc, a[u].x, j[u].x, x, C);
          acc = add_slot(acc, a[u].y, j[u].y, x, C);
          acc = add_slot(acc, a[u].z, j[u].z, x, C);
          acc = add_slot(acc, a[u].w, j[u].w, x, C);
        }
      }
      const int s = head + 4 * n4;         // the tail: 0-3 slots
      if (t < K - s)
        acc = add_slot(acc, __ldcs(v + s + t), __ldcs(c + s + t), x, C);
    } else {
      constexpr int N = 4 * SEG_TRIP;
      for (int b = t; b < K; b += N * TPR) {
        float a[N];
        int j[N];
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const int k = b + u * TPR;
          a[u] = k < K ? __ldcs(v + k) : 0.0f;
          j[u] = k < K ? __ldcs(c + k) : -1;
        }
#pragma unroll
        for (int u = 0; u < N; ++u) acc = add_slot(acc, a[u], j[u], x, C);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if constexpr (WPR == 1) {
    if ((threadIdx.x & 31) == 0 && row < R) y[row] = acc;
  } else {
    __shared__ float part[SEG_THREADS / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (t == 0 && row < R) {
      const float* p = part + (threadIdx.x >> 5);
      float sum = p[0];
#pragma unroll
      for (int w = 1; w < WPR; ++w) sum += p[w];
      y[row] = sum;
    }
  }
}

template <int TPR>
int launch_seg(const float* vals, const int* idx, const float* x, float* y,
               int R, int K, int C, bool vec, cudaStream_t s) {
  constexpr int RPB = SEG_THREADS / TPR;
  const int blocks = (R + RPB - 1) / RPB;
  if (blocks > 0) {
    if (vec)
      spmv_ell_seg_kernel<TPR, true><<<blocks, SEG_THREADS, 0, s>>>(
          vals, idx, x, y, R, K, C);
    else
      spmv_ell_seg_kernel<TPR, false><<<blocks, SEG_THREADS, 0, s>>>(
          vals, idx, x, y, R, K, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tpr: threads a row (32, 64, 128 or 256); vec: 1 when vals and idx lie in
// the same 16-byte phase (spmv.route and spmv.vector_loads choose both)
extern "C" int spmv_ell_seg_f32(const float* vals, const int* idx,
                                const float* x, float* y, int R, int K,
                                int C, int tpr, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tpr) {
    case 32: return launch_seg<32>(vals, idx, x, y, R, K, C, vec, s);
    case 64: return launch_seg<64>(vals, idx, x, y, R, K, C, vec, s);
    case 128: return launch_seg<128>(vals, idx, x, y, R, K, C, vec, s);
    case 256: return launch_seg<256>(vals, idx, x, y, R, K, C, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
