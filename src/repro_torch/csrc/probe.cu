// K4: o = x + 1 over a small f32 tile — the cost model's dispatch probe.
//
// Replaces the trivial Pallas kernel of _probe_interpret_step (src/repro/
// core/cost_model.py), which timed interpret-mode grid steps.  Kernels
// here are compiled, so the probe prices what a trivial launch costs on
// the card instead (HardwareProfile.dispatch_s).
//
// Bound on an H100: 8 bytes per element at 3.35 TB/s — nanoseconds for
// the 128x128 tile, so its time is launch overhead, which is what the
// probe measures.  Design: one thread per element, grid-stride.
#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    o[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" int probe_add_one_f32(const float* x, float* o, int n,
                                 void* stream) {
  int blocks = (n + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  add_one_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, n);
  return static_cast<int>(cudaGetLastError());
}

// The wrappers turn a nonzero return code of the entry points above into
// an exception carrying this text.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
