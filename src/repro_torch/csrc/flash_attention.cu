// K7, CUDA-core route: blocked (flash) attention with an online softmax,
// for f32 and the shapes the tensor-core route (flash_attention_wgmma.cu:
// bf16, d % 8 == 0, d <= 128) does not take.
// q (BH, T, d), k/v (BHkv, S, d), BH = BHkv * rep: query head bh reads
// K/V head bh / rep (grouped-query attention without materialising the
// repeat).  Returns (BH, T, d) in q's type; f32 or bf16 in and out.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/flash_attention.py:75, body _flash_kernel): a grid of
// (bh, q block, kv block) with the kv block innermost and sequential,
// the running max m, sum l and accumulator acc of each query row kept
// in f32 VMEM scratch; q scaled by d^-0.5 in f32 before q k^T; causal
// mask kpos <= qpos (top-left, whatever T and S are), padded keys
// masked; masked scores are -1e30; the output is acc / max(l, 1e-30).
// This kernel runs the same update, a 64-key tile at a time.
//
// Bound on an H100: operations.  At prefill T = S = 1024, d = 112 with
// 8 query heads per K/V head, the causal half of q k^T and p v is
// ~2 T^2 d flops per query head against ~(2 T + 2 S / 8) d bf16 bytes:
// ~455 flops a byte, above the bf16 tensor cores' 295 (989 TFLOP/s
// over 3.35 TB/s), so bound by operations, ~1.5x.
//
// Design (simple first: f32 FMAs on the CUDA cores, no tensor cores,
// no TMA, no pipelining).  One 256-thread block per (bh, 64-row query
// tile).  The q tile is staged once in shared memory as f32, already
// scaled.  The block then walks the 64-key tiles that the causal mask
// leaves any visible key in (tiles wholly above the diagonal are
// skipped; masking them would add exactly 0 to l and acc): it stages
// the K and V tile as f32, each thread computes a 4 x 4 block of
// scores (rows ty + 16 i, keys tx + 16 j, so the 16 lanes that share a
// row reduce its max and sum by warp shuffles), rescales its rows'
// accumulators by alpha = exp(m_old - m_new), writes p to shared memory
// and accumulates p v for its 4 rows and every 16th column of d.  The
// K and q tiles use an odd row stride so the 16 keys a warp reads at
// once fall in 16 banks.  m, l and acc stay in registers for the whole
// walk; HBM sees each q row read once, each K/V tile once per query
// tile, and each output row written once.  d <= 256 (shared memory:
// ~104 KB at d = 112, ~209 KB at d = 256, above the 48 KB default, so
// the launch opts in).  exp is expf and the division is IEEE: the
// build has no --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BKV = 64;          // keys per tile
constexpr int NT = 256;          // a 16 x 16 grid of threads
constexpr int PS = BKV + 1;      // row stride of the p tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// DC: columns of d per thread (d <= 16 * DC)
template <typename T, int DC>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Tq, int S,
             int d, int rep, float scale, int causal) {
  extern __shared__ float smem[];
  const int dp = d | 1;          // odd stride: conflict-free key reads
  float* Qs = smem;              // BQ x dp, q * scale
  float* Ks = Qs + BQ * dp;      // BKV x dp
  float* Vs = Ks + BKV * dp;     // BKV x d
  float* Ps = Vs + BKV * d;      // BQ x PS
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* qb = q + (static_cast<long long>(bh) * Tq + q0) * d;
  const T* kb = k + static_cast<long long>(bh / rep) * S * d;
  const T* vb = v + static_cast<long long>(bh / rep) * S * d;
  const int qrows = min(BQ, Tq - q0);

  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i - (i / d) * d;
    Qs[r * dp + c] = r < qrows ? to_f32(qb[i]) * scale : 0.0f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.0f;
  }

  // causal: no row of this tile sees a key past q0 + BQ - 1
  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();             // the previous tile's K, V, p are used up
    const int krows = min(BKV, S - k0);
    const long long g0 = static_cast<long long>(k0) * d;
    for (int i = tid; i < BKV * d; i += NT) {
      const int r = i / d, c = i - (i / d) * d;
      const bool ok = r < krows;
      Ks[r * dp + c] = ok ? to_f32(kb[g0 + i]) : 0.0f;
      Vs[i] = ok ? to_f32(vb[g0 + i]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();             // the p tile is complete

    // padded keys have zero V rows, so the full tile can be summed
    for (int j = 0; j < BKV; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int c = tx + 16 * cc;
        const float vv = c < d ? Vs[j * d + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = out + (static_cast<long long>(bh) * Tq + q0) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= qrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int c = tx + 16 * cc;
      if (c < d) store(ob + r * d + c, acc[i][cc] / den);
    }
  }
}

template <typename T, int DC>
int launch(const T* q, const T* k, const T* v, T* out, int BH, int Tq,
           int S, int d, int rep, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ + BKV) * (d | 1) + BKV * d + BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  flash_kernel<T, DC><<<grid, NT, smem, stream>>>(q, k, v, out, Tq, S, d,
                                                  rep, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int Tq, int S, int d, int rep, float scale, int causal,
             void* stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch<T, 2>(qp, kp, vp, op, BH, Tq, S, d, rep, scale, causal, st);
  if (d <= 64) return launch<T, 4>(qp, kp, vp, op, BH, Tq, S, d, rep, scale, causal, st);
  if (d <= 128) return launch<T, 8>(qp, kp, vp, op, BH, Tq, S, d, rep, scale, causal, st);
  if (d <= 256) return launch<T, 16>(qp, kp, vp, op, BH, Tq, S, d, rep, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_fma_f32(const void* q, const void* k,
                                       const void* v, void* out, int BH,
                                       int Tq, int S, int d, int rep,
                                       float scale, int causal,
                                       void* stream) {
  return dispatch<float>(q, k, v, out, BH, Tq, S, d, rep, scale, causal,
                         stream);
}

extern "C" int flash_attention_fma_bf16(const void* q, const void* k,
                                        const void* v, void* out, int BH,
                                        int Tq, int S, int d, int rep,
                                        float scale, int causal,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, BH, Tq, S, d, rep, scale,
                                 causal, stream);
}
