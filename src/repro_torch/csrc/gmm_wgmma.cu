// K8, tensor-core route: grouped (per-expert) matmul in bf16,
// out[e] = x[e] @ w[e] for x (E, C, D) and w (E, D, F), out (E, C, F)
// bf16, f32 accumulation; D % 8 == 0 and F % 8 == 0 (16-byte rows, as
// TMA needs).  f32 and other shapes take the CUDA-core route in gmm.cu.
//
// Replaces the TPU kernel gmm_pallas (src/repro/kernels/gmm/gmm.py:58,
// body _gmm_kernel): f32 sums of the operands' products over the
// contraction, stored in x's type.
//
// Bound on an H100: bytes.  In an MoE layer C is small (decode: the
// batch, 4; prefill: 104 and a tail pass of 24 at T = 1024), so the
// expert weights, 11.3 GB a call at kimi-k2's 384 x 7168 x 2048, set
// the time (3.4 ms at 3.35 TB/s); 2 C D F flops are at most 104 flops
// a weight byte, under the bf16 tensor cores' 295.
//
// Design: swap-AB on wgmma, a weight stream.  The kernel computes
// out[e]^T = w[e]^T x[e]^T, so the weight's F axis fills wgmma's 64
// rows and the few tokens C are its N (8, 16, 32, 64 or 128, the
// smallest that covers C, tiles of 128 above): nothing of the product
// is spent on padding C up to 64 rows.  A block owns a 128-wide slice
// of F of one expert (two consumer warpgroups of 64 rows each) and a
// tile of N tokens; a producer warp streams the contraction in steps
// of 64 through a 4-stage ring with TMA: each stage is the 64 x 128
// weight tile (16 KB, two 64 x 64 boxes, bf16 as stored) and the
// N x 64 slice of x, completing one mbarrier; the consumers release
// it on an "empty" mbarrier when their products have read it, so three
// stages (48 KB of weights) stay in flight a block.  w[e] is (D, F)
// with F contiguous: an M-major A, which bf16 wgmma takes transposed
// (imm-trans-a); x[e] is (C, D) with D contiguous, the natural K-major
// B; both are read by wgmma straight from the 128-byte-swizzled tiles
// TMA wrote.  TMA fills rows and columns past C, D and F with zeros.
// Blocks of one expert are adjacent in launch order (blockIdx.x walks
// F), so x[e] is read from HBM once and from L2 thereafter.  The f32
// sums are stored transposed, one value at a time at out[e][c][f],
// rounded to nearest even (__float2bfloat16).  The two tensor maps
// (w, x) are encoded on the host for every call.
#include "hopper.cuh"

namespace {

using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int BM = 128;          // columns of F per block
constexpr int BK = 64;           // contraction step (one ring stage)
constexpr int STAGES = 4;
constexpr int BOX = 64 * 64 * 2; // one 64 x 64 weight box: 8 KB
constexpr int W_BYTES = 2 * BOX; // a stage's weight tile: 16 KB
constexpr int NT = 288;          // two consumer warpgroups + a producer

// d (64 x N f32) += A (64 x 16, shared, M-major) * B (16 x N, shared,
// K-major): the weight tile transposed times the tokens' slice
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tn<8>(float (&d)[4], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// N: tokens per block (a multiple of 8)
template <int N>
__global__ void __launch_bounds__(NT)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  constexpr int STAGE = W_BYTES + N * BK * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, empty
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_u32(bars);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  const int e = blockIdx.z;
  const int f0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * N;
  const int KT = (D + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warp: one lane issues every load
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty(s), ((kt / STAGES) - 1) & 1);
        const uint32_t st = base + s * STAGE;
        hopper::mbar_expect_tx(full(s), STAGE);
        hopper::tma_load_3d(st, &wmap, f0, kt * BK, e, full(s));
        hopper::tma_load_3d(st + BOX, &wmap, f0 + 64, kt * BK, e, full(s));
        hopper::tma_load_3d(st + W_BYTES, &xmap, kt * BK, n0, e, full(s));
      }
    }
    return;
  }

  // consumer warpgroup h owns F rows f0 + 64 h .. f0 + 64 h + 63
  const int h = threadIdx.x >> 7;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint32_t st = base + s * STAGE;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: M-major box, 8-row (contraction) groups 1024 bytes apart, a
      // 16-row step +2048; B: K-major rows of x, a 16-column step +32
      const uint64_t da =
          hopper::wgmma_desc(st + h * BOX + kk * 2048, BOX, 1024);
      const uint64_t db = hopper::wgmma_desc(st + W_BYTES + kk * 32, 16, 1024);
      wgmma_tn<N>(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(empty(s));
  }

  // acc[4 j + r]: f = 16 w + g + 8 (r / 2), c = 8 j + 2 t + r % 2
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* oe = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int f = f0 + 64 * h + 16 * w + g + 8 * ((i >> 1) & 1);
    const int c = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (f < F && c < C)
      oe[static_cast<long long>(c) * F + f] = __float2bfloat16(acc[i]);
  }
}

template <int N>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  if (!hopper::encode_bf16_3d(&wmap, w, F, D, E) ||
      !hopper::encode_bf16_3d(&xmap, x, D, C, E, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + STAGES * (W_BYTES + N * BK * 2);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + BM - 1) / BM, (C + N - 1) / N, E);
  gmm_wgmma_kernel<N><<<grid, NT, smem, stream>>>(
      wmap, xmap, static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gmm_wgmma_bf16(const void* x, const void* w, void* out,
                              int E, int C, int D, int F, void* stream) {
  if (D % 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 8) return launch<8>(x, w, out, E, C, D, F, st);
  if (C <= 16) return launch<16>(x, w, out, E, C, D, F, st);
  if (C <= 32) return launch<32>(x, w, out, E, C, D, F, st);
  if (C <= 64) return launch<64>(x, w, out, E, C, D, F, st);
  return launch<128>(x, w, out, E, C, D, F, st);
}
