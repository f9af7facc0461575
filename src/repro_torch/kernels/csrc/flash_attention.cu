// flash_attention: attention with an online softmax, K/V streamed in tiles.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel / flash_attention:
// q (B, S, H, D), k and v (B, T, KH, D), in bf16 or float32; query head h
// reads kv head h / (H / KH); scores (q * 1/sqrt(D)) . k in float32, masked
// to -1e30 above the diagonal when causal (key col > query row, both counted
// from 0); a float32 running max m, denominator l and accumulator; the output
// acc / max(l, 1e-20) in q's dtype.  The Pallas kernel keeps K and V whole in
// VMEM and needs S and T to be multiples of its blocks; here K and V stream
// through shared memory one tile at a time (the production form its docstring
// describes), rows past S are not written and keys past T are masked, so any
// S and T work.
//
// Bound on the H100: at the model's prefill shapes (S = T = 512, D = 128)
// the bytes of q, k, v and o (about 8 MB in bf16) take longer at 3.35 TB/s
// than the causal half of 4*B*H*S*T*D operations on the bf16 tensor cores;
// this first kernel runs its products on the CUDA cores in float32, so it is
// bound by those operations.  Design: one block of 128 threads per (query
// tile of BQ = 32 rows, head, batch).  Per key tile of BK = 64: the threads
// load K and V into shared memory (rows padded by one float against bank
// conflicts), each computes a 4 x 4 register tile of scores (rows rg + 8i,
// keys cg + 16j), each warp then updates the running max and denominator of
// 8 rows with shuffles, and each thread accumulates P.V for 4 rows and D/16
// head dims in registers.  Causal blocks stop at the diagonal's last tile.
// Tensor cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int FA_THREADS = 128;
constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int ROW_GROUPS = 8;          // thread groups along rows
constexpr int COL_GROUPS = 16;         // along keys (scores) or dims (P.V)
constexpr int RPT = BQ / ROW_GROUPS;   // rows per thread: 4
constexpr int CPT = BK / COL_GROUPS;   // keys per thread: 4
constexpr int ROWS_PER_WARP = BQ / (FA_THREADS / 32);  // 8
constexpr float NEG_INF = -1e30f;      // the reference kernel's mask value
constexpr int MAX_D = 256;
static_assert(ROW_GROUPS * COL_GROUPS == FA_THREADS, "thread layout");
static_assert(BK == 64, "phase 2 reads two keys per lane");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

inline size_t smem_bytes(int d) {
  const size_t ld = d + 1;
  return sizeof(float) *
         (BQ * ld + 2 * BK * ld + BQ * (BK + 1) + 3 * BQ);
}

// NC = head dims per thread in P.V: 16 * NC >= D.
template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s,
                       int t, int h, int kh, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                        // BQ x ld, scaled
  float* ks = qs + BQ * ld;                // BK x ld
  float* vs = ks + BK * ld;                // BK x ld
  float* ps = vs + BK * ld;                // BQ x (BK + 1): scores, then P
  float* row_m = ps + BQ * (BK + 1);       // BQ
  float* row_l = row_m + BQ;               // BQ
  float* row_alpha = row_l + BQ;           // BQ

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = head / (h / kh);
  const int tid = threadIdx.x;
  const int rg = tid / COL_GROUPS;
  const int cg = tid % COL_GROUPS;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < BQ * d; i += FA_THREADS) {
    const int r = i / d, dd = i % d;
    const int row = q0 + r;
    float val = 0.f;
    if (row < s) val = to_f32(q[((b * s + row) * h + head) * d + dd]) * scale;
    qs[r * ld + dd] = val;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  // a causal block needs the keys up to its last row only
  const int t_end = causal ? min(t, q0 + BQ) : t;
  for (int k0 = 0; k0 < t_end; k0 += BK) {
    __syncthreads();       // the previous tile's readers are done
    for (int i = tid; i < BK * d; i += FA_THREADS) {
      const int r = i / d, dd = i % d;
      const int col = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (col < t) {
        const int64_t off = ((b * t + col) * kh + kvh) * d + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r * ld + dd] = kv;
      vs[r * ld + dd] = vv;
    }
    __syncthreads();

    // scores of rows rg + 8i against keys cg + 16j
    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(rg + ROW_GROUPS * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(cg + COL_GROUPS * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + ROW_GROUPS * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + COL_GROUPS * j;
        const int col = k0 + c;
        const bool keep = col < t && (!causal || col <= q0 + r);
        ps[r * (BK + 1) + c] = keep ? sc[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: each warp updates ROWS_PER_WARP rows
    for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
      float* pr = ps + r * (BK + 1);
      const float a = pr[lane], c = pr[lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      pr[lane] = pa;
      pr[lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = row_alpha[rg + ROW_GROUPS * i];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(rg + ROW_GROUPS * i) * (BK + 1) + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int dd = cg + COL_GROUPS * n;
        const float vv = dd < d ? vs[c * ld + dd] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + ROW_GROUPS * i;
    const int row = q0 + r;
    if (row >= s) continue;
    const float l = fmaxf(row_l[r], 1e-20f);
    T* orow = o + ((b * s + row) * h + head) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int dd = cg + COL_GROUPS * n;
      if (dd < d) orow[dd] = from_f32<T>(acc[i][n] / l);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int t, int h, int kh, int d, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_attention_kernel<T, NC><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, h, kh, d, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int s, int t, int h, int kh, int d, float scale, int causal,
             cudaStream_t st) {
  if (d <= 16) return launch<T, 1>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  if (d <= 32) return launch<T, 2>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  if (d <= 64) return launch<T, 4>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  if (d <= 128) return launch<T, 8>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  return launch<T, 16>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
}

}  // namespace

// q, o (B, S, H, D); k, v (B, T, KH, D); all contiguous, in bf16 ? bf16 :
// float32.  H a multiple of KH, 1 <= D <= 256.  Returns a cudaError_t code
// (cudaErrorInvalidValue for shapes outside those).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bf16, int b,
                                     int s, int t, int h, int kh, int d,
                                     float scale, int causal, void* stream) {
  if (d < 1 || d > MAX_D || kh < 1 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, s, t, h, kh, d, scale,
                                   causal, st);
  return launch_d<float>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
}
