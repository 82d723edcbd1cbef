// K8, CUDA-core route, for f32 and the shapes the tensor-core route
// (gmm_wgmma.cu: bf16, D % 8 == 0, F % 8 == 0) does not take:
// grouped (per-expert) matmul, out[e] = x[e] @ w[e] for x (E, C, D)
// and w (E, D, F); out (E, C, F) in x's type; f32 or bf16 in and out,
// f32 accumulation.
//
// Replaces the TPU kernel gmm_pallas (src/repro/kernels/gmm/gmm.py:40,
// body _gmm_kernel): a grid of (E, C/Tc, F/Tf, D/Td) with the
// contraction innermost and sequential, operands upcast to f32 and
// summed into an f32 VMEM accumulator, stored in x's type at the last
// contraction step.
//
// Bound on an H100: bytes.  In an MoE layer C is small (decode: the
// batch, B = 4; prefill: B * int(T * k / E * 1.25) = 104 at T = 1024;
// the overflow pass a quarter of that), so the expert weights dominate:
// kimi-k2's 384 x 7168 x 2048 bf16 are 11.3 GB, 3.4 ms at 3.35 TB/s,
// against 2 C D F flops per expert, under 1 flop a byte at decode.
//
// Design (simple first: f32 FMAs on the CUDA cores, no tensor cores,
// no TMA, no pipelining).  blockIdx.z is the expert, blockIdx.x a
// 128-wide column tile of F, blockIdx.y a tile of C rows; the C tile
// is the smallest of 8, 16, 32, 64 or 128 rows that covers C (up to
// 128), so each weight tile is read from HBM once per 128 rows of C,
// i.e. once at these shapes.  256 threads walk D in steps of 32: the
// block stages the 32 x 128 weight tile (16-byte loads where F allows)
// and the C x 32 slice of x in shared memory as f32, then each thread
// accumulates 4 adjacent columns for C/8 rows (one row per warp at a
// time, so x reads are broadcasts and weight reads are float4s).  The
// store rounds with __float2bfloat16 (round to nearest even).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 128;          // columns of F per block
constexpr int BKD = 32;          // contraction step
constexpr int NT = 256;          // 8 warps

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T (at ws, 16-byte aligned) -> f32 in shared memory
__device__ __forceinline__ void unpack16(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst) = a;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// RM rows per thread: a C tile of BM = 8 * RM rows
template <typename T, int RM, bool VEC>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int D, int F) {
  constexpr int BM = 8 * RM;
  constexpr int V = 16 / sizeof(T);        // elements per 16-byte load
  __shared__ __align__(16) float xs[BM][BKD];
  __shared__ __align__(16) float ws[BKD][BN];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tc = tid & 31, tr = tid >> 5;
  const T* xe = x + static_cast<long long>(e) * C * D;
  const T* we = w + static_cast<long long>(e) * D * F;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += BKD) {
    for (int i = tid; i < BM * BKD; i += NT) {
      const int r = i / BKD, kk = i % BKD;
      const int c = c0 + r, dd = d0 + kk;
      xs[r][kk] = (c < C && dd < D)
          ? to_f32(xe[static_cast<long long>(c) * D + dd]) : 0.0f;
    }
    if (VEC) {
      // F % V == 0: a 16-byte vector lies wholly inside or outside F
      for (int i = tid; i < BKD * (BN / V); i += NT) {
        const int kk = i / (BN / V), n = (i % (BN / V)) * V;
        const int dd = d0 + kk, f = f0 + n;
        if (dd < D && f < F) {
          unpack16(we + static_cast<long long>(dd) * F + f, &ws[kk][n]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) ws[kk][n + j] = 0.0f;
        }
      }
    } else {
      for (int i = tid; i < BKD * BN; i += NT) {
        const int kk = i / BN, n = i % BN;
        const int dd = d0 + kk, f = f0 + n;
        ws[kk][n] = (dd < D && f < F)
            ? to_f32(we[static_cast<long long>(dd) * F + f]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKD; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tc * 4]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = xs[tr + 8 * i][kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int c = c0 + tr + 8 * i;
    if (c >= C) continue;
    T* orow = out + (static_cast<long long>(e) * C + c) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tc * 4 + j;
      if (f < F) store(orow + f, acc[i][j]);
    }
  }
}

template <typename T, int RM>
int launch(const T* x, const T* w, T* out, int E, int C, int D, int F,
           cudaStream_t stream) {
  constexpr int BM = 8 * RM;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  constexpr int V = 16 / sizeof(T);
  const bool vec = F % V == 0 &&
                   reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  if (vec)
    gmm_kernel<T, RM, true><<<grid, NT, 0, stream>>>(x, w, out, C, D, F);
  else
    gmm_kernel<T, RM, false><<<grid, NT, 0, stream>>>(x, w, out, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int E, int C, int D,
             int F, void* stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 8) return launch<T, 1>(xp, wp, op, E, C, D, F, st);
  if (C <= 16) return launch<T, 2>(xp, wp, op, E, C, D, F, st);
  if (C <= 32) return launch<T, 4>(xp, wp, op, E, C, D, F, st);
  if (C <= 64) return launch<T, 8>(xp, wp, op, E, C, D, F, st);
  return launch<T, 16>(xp, wp, op, E, C, D, F, st);
}

}  // namespace

extern "C" int gmm_fma_f32(const void* x, const void* w, void* out,
                           int E, int C, int D, int F, void* stream) {
  return dispatch<float>(x, w, out, E, C, D, F, stream);
}

extern "C" int gmm_fma_bf16(const void* x, const void* w, void* out,
                            int E, int C, int D, int F, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, out, E, C, D, F, stream);
}
