// K7, tensor-core route: blocked (flash) attention in bf16 on wgmma,
// fed by TMA through a ring of mbarrier-guarded stages.
// q (BH, T, d), k/v (BHkv, S, d) bf16, BH = BHkv * rep: query head bh
// reads K/V head bh / rep (grouped-query attention without a repeat in
// memory).  Returns (BH, T, d) bf16.  d % 8 == 0 (16-byte rows, as TMA
// needs) and d <= 128; f32 and other shapes take the CUDA-core route
// in flash_attention.cu.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/flash_attention.py:94, body _flash_kernel): the
// running max m, sum l and accumulator of each query row in f32 over
// the key blocks; scores scaled by d^-0.5; causal mask kpos <= qpos
// (top-left, whatever T and S are); padded keys masked.
//
// Bound on an H100: operations.  At prefill (T = S = 1024, d = 112, 8
// query heads a K/V head) the causal half of q k^T and p v is ~455
// flops a byte, above the bf16 tensor cores' 295: only wgmma reaches
// the card's bf16 rate.
//
// Design.  One block per (query head, 64-row query tile), the last
// (heaviest, under the causal mask) tiles launched first; four warps
// form the consumer warpgroup, a fifth warp is the producer.  The
// producer loads the q tile once and streams the 64-key K and V tiles
// into a ring of 2 stages with TMA (one 64 x 64 box = 128 bytes a row
// per 64 columns of d, 128-byte swizzle), each tile completing its own
// mbarrier; the consumers release a stage on an "empty" mbarrier once
// their p v product has read it.  Per key tile the warpgroup runs
// S = q k^T (wgmma m64n64k16, both operands in shared memory, K-major)
// into f32 registers, scales S by d^-0.5 log2(e), masks only the tiles
// that cross the diagonal or the ragged end of S (tiles wholly above
// the diagonal are never loaded), updates m and l with exp2 in
// registers (each thread holds 2 rows x 16 keys: the row reduction is
// two shuffles), rounds p to bf16 and feeds it from registers as
// wgmma's A operand for O += p v, with the V tile as the shared-memory
// B operand, MN-major (d contiguous: the transposed form bf16 wgmma
// takes).  d is padded to 64 or 128 columns: TMA fills columns past d
// with zeros, which add 0 to S, and the padded output columns are not
// stored.  One more rounding than the plain version: p is rounded to
// bf16 before p v (the plain version keeps p in f32); l sums the f32
// p.  The tile map's rows are per head (a 3-D tensor map), so rows
// past T or S read zeros, never the next head.  The tensor maps are
// encoded on the host for every call (three cuTensorMapEncodeTiled
// calls).
#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int BQ = 64;           // query rows per block (one warpgroup)
constexpr int BKV = 64;          // keys per tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int BOX = 64 * 64 * 2; // one TMA box: 64 rows x 128 bytes
constexpr int NT = 160;          // the consumer warpgroup + the producer

// d[0..31] (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..31] += A (64x16, registers) * B (16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..63] += A (64x16, registers) * B (16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// DP: d padded to 64 or 128 (NSUB boxes of 64 columns)
template <int DP>
__global__ void __launch_bounds__(NT)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int Tq, int S, int d,
                   int rep, float scale_log2, int causal) {
  constexpr int NSUB = DP / 64;
  constexpr int TILE = NSUB * BOX;         // a q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  auto k_s = [&](int s) { return base + TILE * (1 + s); };
  auto v_s = [&](int s) { return base + TILE * (1 + STAGES + s); };
  auto k_full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar0 + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one lane issues every load
    if (threadIdx.x == 128) {
      const int kvh = bh / rep;
      hopper::mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int c = 0; c < NSUB; ++c)
        hopper::tma_load_3d(q_s + c * BOX, &qmap, c * 64, q0, bh, q_full);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
        hopper::mbar_expect_tx(k_full(s), TILE);
#pragma unroll
        for (int c = 0; c < NSUB; ++c)
          hopper::tma_load_3d(k_s(s) + c * BOX, &kmap, c * 64, j * BKV, kvh,
                              k_full(s));
        hopper::mbar_expect_tx(v_full(s), TILE);
#pragma unroll
        for (int c = 0; c < NSUB; ++c)
          hopper::tma_load_3d(v_s(s) + c * BOX, &vmap, c * 64, j * BKV, kvh,
                              v_full(s));
      }
    }
    return;
  }

  // consumer warpgroup.  Accumulator layout of wgmma m64nN: thread
  // (warp w, lane 4 g + t) holds, for each 8-column block j, columns
  // 8 j + 2 t + {0, 1} of rows 16 w + g (regs 4 j, 4 j + 1) and
  // 16 w + g + 8 (regs 4 j + 2, 4 j + 3).
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * w + g, r1 = r0 + 8;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int ph = (j / STAGES) & 1;
    mbar_wait(k_full(s), ph);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NSUB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // K-major, 128-byte swizzle: a 16-column step is +32 bytes
        const uint64_t da =
            hopper::wgmma_desc(q_s + c * BOX + kk * 32, 16, 1024);
        const uint64_t db =
            hopper::wgmma_desc(k_s(s) + c * BOX + kk * 32, 16, 1024);
        wgmma_ss_m64n64(sc, da, db, (c | kk) != 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale, mask (only tiles on the diagonal or past S), row max
    const int k0 = j * BKV;
    const bool need_mask = k0 + BKV > S || (causal && k0 + BKV - 1 > q0);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (need_mask) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        if (key >= S || (causal && key > row)) x = -INFINITY;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every row sees key 0 in tile 0, so the maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(sc[i] - ((i & 2) ? mn1 : mn0));
      sc[i] = p;
      if (i & 2) rs1 += p; else rs0 += p;
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = a0 * l0 + rs0;
    l1 = a1 * l1 + rs1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

    // p as wgmma's register A operand: keys 16 kk .. 16 kk + 15 are
    // accumulator blocks 2 kk and 2 kk + 1, in the fragment's order
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r],
                                      sc[8 * kk + 2 * r + 1]);

    mbar_wait(v_full(s), ph);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // MN-major, 128-byte swizzle: 8-key groups 1024 bytes apart (SBO),
      // 64-column boxes BOX apart (LBO); a 16-key step is +2048 bytes
      const uint64_t db = hopper::wgmma_desc(v_s(s) + kk * 2048, BOX, 1024);
      if constexpr (DP == 128)
        wgmma_rs_m64n128(o, pa[kk], db);
      else
        wgmma_rs_m64n64(o, pa[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(empty(s));
  }

  // l >= 1 (the row maximum contributes exp2(0))
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  __nv_bfloat16* ob = out + static_cast<long long>(blockIdx.x) * Tq * d;
#pragma unroll
  for (int jb = 0; jb < DP / 8; ++jb) {
    const int col = 8 * jb + 2 * t;
    if (col >= d) continue;                 // d % 8 == 0: pairs in or out
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r0) * d +
                                   col) =
          hopper::pack_bf16(o[4 * jb] * inv0, o[4 * jb + 1] * inv0);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r1) * d +
                                   col) =
          hopper::pack_bf16(o[4 * jb + 2] * inv1, o[4 * jb + 3] * inv1);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Tq, int S, int d, int rep, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!hopper::encode_bf16_3d(&qmap, q, d, Tq, BH) ||
      !hopper::encode_bf16_3d(&kmap, k, d, S, BH / rep) ||
      !hopper::encode_bf16_3d(&vmap, v, d, S, BH / rep))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + (1 + 2 * STAGES) * (DP / 64) * BOX;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_wgmma_kernel<DP><<<grid, NT, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Tq, S, d, rep,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k,
                                          const void* v, void* out, int BH,
                                          int Tq, int S, int d, int rep,
                                          float scale, int causal,
                                          void* stream) {
  if (d % 8 || d > 128 || (Tq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k, v, out, BH, Tq, S, d, rep, scale, causal, st);
  return launch<128>(q, k, v, out, BH, Tq, S, d, rep, scale, causal, st);
}
