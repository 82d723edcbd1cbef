// K4: o = x + 1 over a small f32 tile — the cost model's dispatch probe.
//
// Replaces the trivial Pallas kernel of _probe_interpret_step (src/repro/
// core/cost_model.py), which timed interpret-mode grid steps.  Kernels
// here are compiled, so the probe prices what a trivial launch costs on
// the card instead (HardwareProfile.dispatch_s).
//
// Bound on an H100: 8 bytes per element at 3.35 TB/s — 0.04 us for the
// 128x128 tile, so its time is the launch's, which is what the probe
// measures.  No layout takes it below the card's launch floor, which
// launch_floor_noop (an empty one-block kernel, called by no path of the
// program) lets a measurement read under the same timer.
//
// probe_add_one_vec_f32 (the probe's entry): the least device work a
// launch of it can carry, one block of 1024 threads, 4 float4 loads a
// thread at 128x128 issued before any store, a scalar tail for a numel
// that is not a multiple of 4 (and a scalar loop when x or o is off a
// 16-byte boundary).  probe_add_one_f32 (the first version, kept for
// the same-run comparison): one thread an element, up to 1024 blocks of
// 256 (64 at 128x128).  Measured by chip_smoke.py (H100 80GB HBM3, 700 W,
// inputs evicted from L2): the floor 0.0049 ms, the one block 0.0066, the
// 64 blocks 0.0057: one SM moves the tile's 128 KB slower than 64 SMs do,
// so the least work a launch carries is not the least time it takes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    o[i] = x[i] + 1.0f;
}

constexpr int VEC_THREADS = 1024;
constexpr int VEC_TRIP = 4;

__global__ void __launch_bounds__(VEC_THREADS)
    add_one_vec_kernel(const float* __restrict__ x, float* __restrict__ o,
                       int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) &
       15u) == 0) {
    const int n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int b = threadIdx.x; b < n4; b += VEC_TRIP * VEC_THREADS) {
      float4 a[VEC_TRIP];
#pragma unroll
      for (int u = 0; u < VEC_TRIP; ++u) {
        const int q = b + u * VEC_THREADS;
        a[u] = q < n4 ? x4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < VEC_TRIP; ++u) {
        const int q = b + u * VEC_THREADS;
        if (q < n4)
          o4[q] = make_float4(a[u].x + 1.0f, a[u].y + 1.0f, a[u].z + 1.0f,
                              a[u].w + 1.0f);
      }
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += VEC_THREADS)
    o[i] = x[i] + 1.0f;
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" int probe_add_one_vec_f32(const float* x, float* o, int n,
                                     void* stream) {
  add_one_vec_kernel<<<1, VEC_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_add_one_f32(const float* x, float* o, int n,
                                 void* stream) {
  int blocks = (n + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  add_one_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n);
  return static_cast<int>(cudaGetLastError());
}

// an empty kernel, one block of 32 threads: the launch floor under a
// timer (measurement only; no path of the program launches it)
extern "C" int launch_floor_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The wrappers turn a nonzero return code of the entry points above into
// an exception carrying this text.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
