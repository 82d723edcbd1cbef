// K1: "same" zero-padded 2-D correlation, f32.
//
// Replaces the TPU kernel conv2d_pallas (src/repro/kernels/conv2d/
// conv2d.py:41, body _conv_kernel): each grid step there receives its own
// (row_tile+K-1) x (col_tile+K-1) halo window in VMEM and accumulates K^2
// shifted multiply-adds.
//
// Bound on an H100: 2*H*W*K^2 FLOP on the f32 CUDA cores (67 TFLOP/s);
// it reads H*W + K*K floats and writes H*W, so at K=15 it is compute-
// bound by two orders of magnitude.
//
// Two routes, picked by the wrapper (conv2d.route):
//
// conv2d_reg_f32, odd K <= 15 (every filter the workloads use): one
// 256-thread block per 128 x 32 output tile; thread (lane, wy) owns the
// 4 x 4 outputs of columns 4*lane .. 4*lane + 3 and rows 4*wy .. 4*wy + 3
// in registers.  K is a template argument (K = 1 .. 15, 8 kernels), so
// every loop over taps and over the micro-tile unrolls and no register
// index is dynamic.  The block stages its zero-padded halo window once,
// (32+K-1) rows x 144 columns starting at col0 - 8 (an aligned column, so
// shared rows stay 16-byte aligned), with 16-byte global loads where the
// image's rows are 16-byte aligned (W % 4 == 0 and an aligned base; a row
// slice img[lo:hi] of a W % 4 != 0 image takes the scalar path: no
// copy), every load issued before any store so that a block waits out
// one memory latency, and the filter with rows padded to a multiple of
// 4.  The thread
// then walks di = 0 .. K-1 with a rolling window of 4 input-row segments
// in registers (4 + K - 1 floats each, read as 16-byte shared loads):
// step di loads one new segment and one filter row (16-byte broadcast
// loads) and does the 4 x 4 x K FMAs of tap row di.  Per warp and tap row
// that is ~24 shared-memory wavefronts (20 for the segment, 4 for the
// filter row) against 240 FMAs (60 issue cycles on an SM's 4 schedulers):
// a ratio of ~2.1 over the whole walk (the first 3 segments included),
// against the first version's 2 shared loads per FMA.  At 239 x 3600,
// K = 15: 29 x 8 = 232 blocks (1,856 warps, ~14 an SM; 27 KB of shared
// memory and 95 registers a thread, so all 232 are resident at once, two
// an SM on 100 SMs).  Variants with 4 or 2 warps a block, 2 or 8 rows a
// thread, or segments read straight from global memory (no window, no
// barrier) were no faster on the card.
//
// conv2d_f32, any larger odd K (PR 11's kernel): one 256-thread block per
// 32 x 8 output tile, one output a thread, K a runtime value, both FMA
// operands read from shared memory.
//
// Both accumulate each output with fmaf from 0.0f in the order di outer,
// dj inner (a micro-tile changes which thread does an output, not that
// order), so the routes agree bitwise with each other and with the plain
// version's shifted multiply-adds.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;

__global__ void conv2d_kernel(const float* __restrict__ img,
                              const float* __restrict__ w,
                              float* __restrict__ out, int H, int W, int K) {
  extern __shared__ float smem[];
  const int r = K / 2;
  const int sw = TILE_W + K - 1;
  const int sh = TILE_H + K - 1;
  float* win = smem;             // (sh, sw) halo window
  float* wf = smem + sw * sh;    // (K, K) filter
  const int row0 = blockIdx.y * TILE_H;
  const int col0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nt = TILE_W * TILE_H;

  for (int i = tid; i < K * K; i += nt) wf[i] = w[i];
  for (int i = tid; i < sw * sh; i += nt) {
    const int y = i / sw, x = i - (i / sw) * sw;
    const int gy = row0 - r + y, gx = col0 - r + x;
    win[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? img[(long long)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  const int oy = row0 + threadIdx.y, ox = col0 + threadIdx.x;
  if (oy >= H || ox >= W) return;
  float acc = 0.0f;
  for (int di = 0; di < K; ++di) {
    const float* wrow = wf + di * K;
    const float* irow = win + (threadIdx.y + di) * sw + threadIdx.x;
    for (int dj = 0; dj < K; ++dj) acc = fmaf(wrow[dj], irow[dj], acc);
  }
  out[(long long)oy * W + ox] = acc;
}

constexpr int REG_C = 4;                        // columns a thread
constexpr int REG_R = 4;                        // rows a thread
constexpr int REG_WARPS = 8;
constexpr int REG_THREADS = 32 * REG_WARPS;     // 256
constexpr int REG_TILE_W = 32 * REG_C;          // 128
constexpr int REG_TILE_H = REG_WARPS * REG_R;   // 32
constexpr int REG_SW = REG_TILE_W + 16;         // col0 - 8 .. col0 + 135
constexpr int REG_SW4 = REG_SW / 4;             // float4 a window row

template <int K>
__global__ void __launch_bounds__(REG_THREADS, 2)
conv2d_reg_kernel(const float* __restrict__ img, const float* __restrict__ w,
                  float* __restrict__ out, int H, int W) {
  constexpr int R = K / 2;
  constexpr int SH = REG_TILE_H + K - 1;
  constexpr int KP = (K + 3) & ~3;              // filter row, padded
  // a thread's outputs read window columns 4*lane + OFF ..
  // 4*lane + OFF + REG_C + K - 2: float4 F0 .. F0 + NF - 1 past 4*lane,
  // the first used element S into them
  constexpr int OFF = 8 - R;
  constexpr int F0 = OFF / 4;
  constexpr int NF = (OFF + REG_C + K - 2) / 4 - F0 + 1;
  constexpr int S = OFF - 4 * F0;
  extern __shared__ float4 smem4[];
  float4* win4 = smem4;                         // (SH, REG_SW4) window
  float4* wf4 = smem4 + SH * REG_SW4;           // (K, KP / 4) filter
  float* wf = reinterpret_cast<float*>(wf4);
  const int row0 = blockIdx.y * REG_TILE_H;
  const int col0 = blockIdx.x * REG_TILE_W;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int tid = wy * 32 + lane;

  // every load of the staging is issued before any store, so a block
  // waits out one global-memory latency, not one per element
  constexpr int NV = SH * REG_SW4;
  constexpr int PER = (NV + REG_THREADS - 1) / REG_THREADS;
  static_assert(K * KP <= REG_THREADS, "one filter value a thread");
  const int fdi = tid / KP, fdj = tid - fdi * KP;
  const float fv = tid < K * KP && fdj < K ? w[fdi * K + fdj] : 0.0f;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(img) & 15) | (W & 3)) == 0;
  const int gx0 = col0 - 8;
  float4 st[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * REG_THREADS;
    const int y = i / REG_SW4, q = i - y * REG_SW4;
    const int gy = row0 - R + y, gx = gx0 + 4 * q;
    st[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < NV && gy >= 0 && gy < H) {
      const float* src = img + static_cast<long long>(gy) * W;
      if (vec) {
        // gx is a multiple of 4 and so is W: all four in or all out
        if (gx >= 0 && gx < W)
          st[k] = *reinterpret_cast<const float4*>(src + gx);
      } else {
        if (gx >= 0 && gx < W) st[k].x = src[gx];
        if (gx + 1 >= 0 && gx + 1 < W) st[k].y = src[gx + 1];
        if (gx + 2 >= 0 && gx + 2 < W) st[k].z = src[gx + 2];
        if (gx + 3 >= 0 && gx + 3 < W) st[k].w = src[gx + 3];
      }
    }
  }
  if (tid < K * KP) wf[tid] = fv;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (tid + k * REG_THREADS < NV) win4[tid + k * REG_THREADS] = st[k];
  __syncthreads();

  const int oy0 = row0 + wy * REG_R;
  if (oy0 >= H) return;
  // window row y of this thread's walk: rows wy*REG_R + y
  const float4* seg0 = win4 + wy * REG_R * REG_SW4 + lane + F0;
  float seg[REG_R][4 * NF];
  float acc[REG_R][REG_C];
#pragma unroll
  for (int r = 0; r < REG_R; ++r)
#pragma unroll
    for (int c = 0; c < REG_C; ++c) acc[r][c] = 0.0f;

  // input row y lives in slot y % REG_R: row di + REG_R - 1 takes the
  // slot of row di - 1, which no output needs from step di on
#pragma unroll
  for (int y = 0; y < REG_R - 1; ++y)
#pragma unroll
    for (int m = 0; m < NF; ++m) {
      const float4 v = seg0[y * REG_SW4 + m];
      seg[y][4 * m] = v.x;
      seg[y][4 * m + 1] = v.y;
      seg[y][4 * m + 2] = v.z;
      seg[y][4 * m + 3] = v.w;
    }
#pragma unroll
  for (int di = 0; di < K; ++di) {
    const int y = di + REG_R - 1;
#pragma unroll
    for (int m = 0; m < NF; ++m) {
      const float4 v = seg0[y * REG_SW4 + m];
      seg[y % REG_R][4 * m] = v.x;
      seg[y % REG_R][4 * m + 1] = v.y;
      seg[y % REG_R][4 * m + 2] = v.z;
      seg[y % REG_R][4 * m + 3] = v.w;
    }
    float f[KP];
#pragma unroll
    for (int m = 0; m < KP / 4; ++m) {
      const float4 v = wf4[di * (KP / 4) + m];
      f[4 * m] = v.x;
      f[4 * m + 1] = v.y;
      f[4 * m + 2] = v.z;
      f[4 * m + 3] = v.w;
    }
#pragma unroll
    for (int dj = 0; dj < K; ++dj)
#pragma unroll
      for (int r = 0; r < REG_R; ++r)
#pragma unroll
        for (int c = 0; c < REG_C; ++c)
          acc[r][c] = fmaf(f[dj], seg[(di + r) % REG_R][S + c + dj],
                           acc[r][c]);
  }

  const int ox = col0 + REG_C * lane;
  const bool ovec =
      ((reinterpret_cast<uintptr_t>(out) & 15) | (W & 3)) == 0;
#pragma unroll
  for (int r = 0; r < REG_R; ++r) {
    const int oy = oy0 + r;
    if (oy >= H) break;
    float* o = out + static_cast<long long>(oy) * W + ox;
    if (ovec && ox < W) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < REG_C; ++c)
        if (ox + c < W) o[c] = acc[r][c];
    }
  }
}

template <int K>
int launch_reg(const float* img, const float* w, float* out, int H, int W,
               cudaStream_t stream) {
  const dim3 block(32, REG_WARPS);
  const dim3 grid((W + REG_TILE_W - 1) / REG_TILE_W,
                  (H + REG_TILE_H - 1) / REG_TILE_H);
  const size_t smem = sizeof(float) *
      ((REG_TILE_H + K - 1) * REG_SW + K * ((K + 3) & ~3));
  conv2d_reg_kernel<K><<<grid, block, smem, stream>>>(img, w, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// odd K <= 15: the wrapper's route checks it (at most 27 KB of shared
// memory a block, under the 48 KB a launch gets without an opt-in)
extern "C" int conv2d_reg_f32(const float* img, const float* w, float* out,
                              int H, int W, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_reg<1>(img, w, out, H, W, s);
    case 3: return launch_reg<3>(img, w, out, H, W, s);
    case 5: return launch_reg<5>(img, w, out, H, W, s);
    case 7: return launch_reg<7>(img, w, out, H, W, s);
    case 9: return launch_reg<9>(img, w, out, H, W, s);
    case 11: return launch_reg<11>(img, w, out, H, W, s);
    case 13: return launch_reg<13>(img, w, out, H, W, s);
    case 15: return launch_reg<15>(img, w, out, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int conv2d_f32(const float* img, const float* w, float* out,
                          int H, int W, int K, void* stream) {
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  const size_t smem =
      sizeof(float) * ((TILE_W + K - 1) * (TILE_H + K - 1) + K * K);
  conv2d_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      img, w, out, H, W, K);
  return static_cast<int>(cudaGetLastError());
}
