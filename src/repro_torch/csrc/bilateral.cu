// K6: LUT bilateral filter of an (H, W) f32 image with intensities in
// [0, 255], edge-padded, from a (K, K) spatial LUT and an (n_levels,)
// range LUT built on the host.
//
// Replaces the TPU kernel bilateral_pallas (src/repro/kernels/bilateral/
// bilateral.py:66, body _bilat_kernel): every grid step there kept the
// whole edge-padded image resident in VMEM and swept its row tile's K x K
// neighbourhood, the range weight a LUT lookup on the truncated intensity
// difference: no exp() on the device.
//
// Bound on an H100: ~6 operations per tap (the reference's own count),
// 6*H*W*K^2 on the f32 CUDA cores (67 TFLOP/s), against reading H*W
// floats and writing H*W: at K = 15 it is bound by operations, ~8x.  The
// data sheet counts an FMA as two operations; the kernel keeps the plain
// version's separate roundings, so its issue floor is higher: ~10
// instructions a tap (below), ~0.06 ms at 239 x 3600, K = 15.
//
// Two routes, picked by the wrapper (bilateral.route):
//
// bilateral_reg_f32, odd K <= 15 and n_levels <= 256 (every radius the
// workloads use): one 256-thread block per 64 x 16 output tile; thread
// (lane, ty) filters the 2 x 2 pixels of columns 2*lane and 2*lane + 1,
// rows 2*ty and 2*ty + 1.  The block stages its edge-clamped
// (16+K-1) x (64+K-1) halo window, the spatial LUT and the range LUT in
// shared memory, the range LUT replicated across the 32 banks (level q
// of lane l at q*32 + l, 32 KB at 256 levels), so the data-dependent
// gather is one wavefront a warp instead of the 3-4 that lanes landing
// in the same bank cost.  K is a template argument (K = 1 .. 15), so the
// dj and row loops unroll.  A window row is read as (K+1)/2 float2 into
// registers and serves both columns' K taps; the K spatial weights of a
// row di sit in registers for the thread's 4 pixels.  The level index
// trunc(|nb - c|), clamped to n_levels - 1, is taken without an F2I (a
// quarter-rate conversion on sm_90): for 0 <= d < 2^23, d + 2^23
// rounded toward zero is 2^23 + trunc(d), whose bits are 0x4B000000 +
// trunc(d); from 2^23 up (inf included) the sum's bits pass the clamp,
// as (int) then clamp does.  The clamped bits times 128 plus a base that
// has 0x4B000000 * 128 taken off (mod 2^32) are the table entry's 32-bit
// shared address, so a tap is FADD, FADD.RZ, IMNMX, LEA, LDS (table) and
// four FMUL / FADD, and a quarter of a float2 load.  Shared memory per
// tap: one wavefront for the table, ~0.5 for the window, against ~5 for
// the first version.  At 239 x 3600 that is 57 x 15 = 855 blocks; 43 KB
// of shared memory a block at K = 15 leaves 5 blocks (40 warps) an SM,
// 660 at once on 132 SMs: 1.3 waves, 6.5 blocks an SM.  A first
// version with one column and 4 rows a thread and the table index
// computed apart from its address was ~1.2x slower (PERF.md).
//
// bilateral_f32, any other odd K or level count (PR 12's kernel): one
// 256-thread block per 32 x 8 output tile, one pixel a thread, both LUTs
// unreplicated in shared memory, K a runtime value.
//
// Both sum each pixel's K^2 taps in the reference's order (di outer, dj
// inner) with the plain version's rounding: products and sums are
// __fmul_rn / __fadd_rn so no FMA contracts them, and the final
// division is IEEE (the build uses no --use_fast_math): error 0 against
// bilateral_lut_torch.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;

__global__ void bilateral_kernel(const float* __restrict__ img,
                                 const float* __restrict__ sp,
                                 const float* __restrict__ rl,
                                 float* __restrict__ out, int H, int W,
                                 int K, int n_levels) {
  extern __shared__ float smem[];
  const int r = K / 2;
  const int sw = TILE_W + K - 1;
  const int sh = TILE_H + K - 1;
  float* win = smem;              // (sh, sw) halo window, edge-clamped
  float* wsp = win + sw * sh;     // (K, K) spatial LUT
  float* wrl = wsp + K * K;       // (n_levels,) range LUT
  const int row0 = blockIdx.y * TILE_H;
  const int col0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nt = TILE_W * TILE_H;

  for (int i = tid; i < K * K; i += nt) wsp[i] = sp[i];
  for (int i = tid; i < n_levels; i += nt) wrl[i] = rl[i];
  for (int i = tid; i < sw * sh; i += nt) {
    const int y = i / sw, x = i - (i / sw) * sw;
    const int gy = min(max(row0 - r + y, 0), H - 1);
    const int gx = min(max(col0 - r + x, 0), W - 1);
    win[i] = img[static_cast<long long>(gy) * W + gx];
  }
  __syncthreads();

  const int oy = row0 + threadIdx.y, ox = col0 + threadIdx.x;
  if (oy >= H || ox >= W) return;
  const float c = win[(threadIdx.y + r) * sw + threadIdx.x + r];
  float num = 0.0f, den = 0.0f;
  for (int di = 0; di < K; ++di) {
    const float* srow = wsp + di * K;
    const float* irow = win + (threadIdx.y + di) * sw + threadIdx.x;
    for (int dj = 0; dj < K; ++dj) {
      const float nb = irow[dj];
      int q = static_cast<int>(fabsf(nb - c));
      q = min(max(q, 0), n_levels - 1);
      const float w = __fmul_rn(srow[dj], wrl[q]);
      num = __fadd_rn(num, __fmul_rn(w, nb));
      den = __fadd_rn(den, w);
    }
  }
  out[static_cast<long long>(oy) * W + ox] = num / fmaxf(den, 1e-12f);
}

// 0x4B000000 + trunc(|t|), clamped to lim = 0x4B000000 + n_levels - 1,
// without F2I: see the note at the top
__device__ __forceinline__ unsigned level_bits(float t, unsigned lim) {
  const unsigned u = __float_as_uint(__fadd_rz(fabsf(t), 0x1p23f));
  return min(u, lim);
}

constexpr int REG_TILE_W = 64;                    // 2 columns a lane
constexpr int REG_ROWS = 2;                       // rows a thread
constexpr int REG_TY = 8;                         // thread rows a block
constexpr int REG_TILE_H = REG_ROWS * REG_TY;     // 16
constexpr int REG_THREADS = 32 * REG_TY;          // 256

// one tap of a pixel with centre c: the range weight from the
// replicated table at shared address level_bits * 128 + lut (lut: this
// lane's copy of level 0, less 0x4B000000 * 128)
__device__ __forceinline__ void tap(float nb, float c, float s, unsigned lim,
                                    unsigned lut, float& num, float& den) {
  float rw;
  const unsigned a = level_bits(nb - c, lim) * 128u + lut;
  asm("ld.shared.f32 %0, [%1];" : "=f"(rw) : "r"(a));
  const float w = __fmul_rn(s, rw);
  num = __fadd_rn(num, __fmul_rn(w, nb));
  den = __fadd_rn(den, w);
}

template <int K>
__global__ void __launch_bounds__(REG_THREADS)
bilateral_reg_kernel(const float* __restrict__ img,
                     const float* __restrict__ sp,
                     const float* __restrict__ rl, float* __restrict__ out,
                     int H, int W, int n_levels) {
  constexpr int R = K / 2;
  constexpr int SW = REG_TILE_W + K - 1;     // even: float2 rows
  constexpr int SH = REG_TILE_H + K - 1;
  constexpr int PAIRS = (K + 1) / 2;         // float2 a window row
  extern __shared__ float smem[];
  float* rep = smem;                  // (n_levels, 32): level q in every bank
  float* win = rep + 32 * n_levels;   // (SH, SW) halo window, edge-clamped
  float* wsp = win + SH * SW;         // (K, K) spatial LUT
  const int row0 = blockIdx.y * REG_TILE_H;
  const int col0 = blockIdx.x * REG_TILE_W;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + lane;

  for (int i = tid; i < 32 * n_levels; i += REG_THREADS) rep[i] = rl[i >> 5];
  for (int i = tid; i < K * K; i += REG_THREADS) wsp[i] = sp[i];
  for (int i = tid; i < SW * SH; i += REG_THREADS) {
    const int y = i / SW, x = i - y * SW;
    const int gy = min(max(row0 - R + y, 0), H - 1);
    const int gx = min(max(col0 - R + x, 0), W - 1);
    win[i] = img[static_cast<long long>(gy) * W + gx];
  }
  __syncthreads();

  const float* wrow = win + ty * REG_ROWS * SW + 2 * lane;  // (di, dj) = 0
  const unsigned lim = 0x4B000000u + static_cast<unsigned>(n_levels - 1);
  const unsigned lut =
      static_cast<unsigned>(__cvta_generic_to_shared(rep + lane)) -
      0x4B000000u * 128u;
  float c0[REG_ROWS], c1[REG_ROWS], num0[REG_ROWS], num1[REG_ROWS],
      den0[REG_ROWS], den1[REG_ROWS];
#pragma unroll
  for (int r = 0; r < REG_ROWS; ++r) {
    c0[r] = wrow[(r + R) * SW + R];
    c1[r] = wrow[(r + R) * SW + R + 1];
    num0[r] = num1[r] = den0[r] = den1[r] = 0.0f;
  }
#pragma unroll 1
  for (int di = 0; di < K; ++di) {
    float s[K];
#pragma unroll
    for (int dj = 0; dj < K; ++dj) s[dj] = wsp[di * K + dj];
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r) {
      // window row r + di, columns 2*lane .. 2*lane + K
      const float2* p =
          reinterpret_cast<const float2*>(wrow + (r + di) * SW);
      float v[2 * PAIRS];
#pragma unroll
      for (int m = 0; m < PAIRS; ++m) {
        const float2 q = p[m];
        v[2 * m] = q.x;
        v[2 * m + 1] = q.y;
      }
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        tap(v[dj], c0[r], s[dj], lim, lut, num0[r], den0[r]);
        tap(v[dj + 1], c1[r], s[dj], lim, lut, num1[r], den1[r]);
      }
    }
  }
  const int ox = col0 + 2 * lane;
#pragma unroll
  for (int r = 0; r < REG_ROWS; ++r) {
    const int oy = row0 + ty * REG_ROWS + r;
    if (oy >= H) continue;
    float* o = out + static_cast<long long>(oy) * W + ox;
    if (ox < W) o[0] = num0[r] / fmaxf(den0[r], 1e-12f);
    if (ox + 1 < W) o[1] = num1[r] / fmaxf(den1[r], 1e-12f);
  }
}

template <int K>
int launch_reg(const float* img, const float* sp, const float* rl,
               float* out, int H, int W, int n_levels, cudaStream_t stream) {
  const dim3 block(32, REG_TY);
  const dim3 grid((W + REG_TILE_W - 1) / REG_TILE_W,
                  (H + REG_TILE_H - 1) / REG_TILE_H);
  const size_t smem = sizeof(float) *
      (32 * n_levels + (REG_TILE_W + K - 1) * (REG_TILE_H + K - 1) + K * K);
  bilateral_reg_kernel<K><<<grid, block, smem, stream>>>(
      img, sp, rl, out, H, W, n_levels);
  return static_cast<int>(cudaGetLastError());
}

// every finite and infinite f32 bit pattern of [lo, hi) (NaNs skipped):
// counts where level_bits - 0x4B000000 differs from (int)|t| clamped to
// [0, n_levels - 1], the first version's index
__global__ void level_index_check_kernel(unsigned long long lo,
                                         unsigned long long hi,
                                         int n_levels,
                                         unsigned long long* mismatches) {
  const unsigned lim = 0x4B000000u + static_cast<unsigned>(n_levels - 1);
  unsigned long long bad = 0;
  for (unsigned long long b = lo + blockIdx.x * blockDim.x + threadIdx.x;
       b < hi; b += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float t = __uint_as_float(static_cast<unsigned>(b));
    if (isnan(t)) continue;
    int q = static_cast<int>(fabsf(t));
    q = min(max(q, 0), n_levels - 1);
    bad += static_cast<int>(level_bits(t, lim) - 0x4B000000u) != q;
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// odd K <= 15 and 1 <= n_levels <= 256: the wrapper's route checks them
extern "C" int bilateral_reg_f32(const float* img, const float* sp,
                                 const float* rl, float* out, int H, int W,
                                 int K, int n_levels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_reg<1>(img, sp, rl, out, H, W, n_levels, s);
    case 3: return launch_reg<3>(img, sp, rl, out, H, W, n_levels, s);
    case 5: return launch_reg<5>(img, sp, rl, out, H, W, n_levels, s);
    case 7: return launch_reg<7>(img, sp, rl, out, H, W, n_levels, s);
    case 9: return launch_reg<9>(img, sp, rl, out, H, W, n_levels, s);
    case 11: return launch_reg<11>(img, sp, rl, out, H, W, n_levels, s);
    case 13: return launch_reg<13>(img, sp, rl, out, H, W, n_levels, s);
    case 15: return launch_reg<15>(img, sp, rl, out, H, W, n_levels, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the level-index check over bit patterns [lo, hi) (a test's, not the
// filter's): adds the mismatches to *mismatches, a device counter
extern "C" int bilateral_level_index_check(unsigned long long lo,
                                           unsigned long long hi,
                                           int n_levels,
                                           unsigned long long* mismatches,
                                           void* stream) {
  level_index_check_kernel<<<132 * 8, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lo, hi, n_levels, mismatches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bilateral_f32(const float* img, const float* sp,
                             const float* rl, float* out, int H, int W,
                             int K, int n_levels, void* stream) {
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  const size_t smem = sizeof(float) *
      ((TILE_W + K - 1) * (TILE_H + K - 1) + K * K + n_levels);
  bilateral_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      img, sp, rl, out, H, W, K, n_levels);
  return static_cast<int>(cudaGetLastError());
}
