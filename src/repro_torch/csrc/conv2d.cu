// K1: "same" zero-padded 2-D correlation, f32.
//
// Replaces the TPU kernel conv2d_pallas (src/repro/kernels/conv2d/
// conv2d.py, body _conv_kernel): each grid step there receives its own
// (row_tile+K-1) x (col_tile+K-1) halo window in VMEM and accumulates K^2
// shifted multiply-adds.
//
// Bound on an H100: 2*H*W*K^2 FLOP on the f32 CUDA cores (67 TFLOP/s);
// it reads H*W + K*K floats and writes H*W, so at K=15 it is compute-
// bound by two orders of magnitude.
//
// Design: one 256-thread block per TILE_H x TILE_W output tile.  The
// block stages its halo window and the filter in shared memory once
// (zero outside the image: no host-side padding copy), then every
// thread does the K^2 FMAs of one output in f32, reading both operands
// from shared memory.  Threads of a warp cover 32 neighbouring columns,
// so the window loads are coalesced and the shared reads conflict-free.
// The ragged edge is masked.  Simple first: no register blocking.
#include <cuda_runtime.h>

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

}  // namespace

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
