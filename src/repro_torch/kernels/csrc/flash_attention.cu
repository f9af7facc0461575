// flash_attention: attention with an online softmax, K/V streamed in tiles.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel / flash_attention:
// q (B, S, H, D), k and v (B, T, KH, D), in bf16 or float32; query head h
// reads kv head h / (H / KH); scores q . k / sqrt(D) in float32, masked to
// -1e30 above the diagonal when causal (key col > query row, both counted
// from 0); a float32 running max m, denominator l and accumulator; the output
// acc / max(l, 1e-20) in q's dtype.  The Pallas kernel keeps K and V whole in
// VMEM and needs S and T to be multiples of its blocks; here K and V stream
// through shared memory one tile at a time, rows past S are not written and
// keys past T are masked, so any S and T work.
//
// Bound on the H100: at the model's prefill shapes (bf16, S = T = 512,
// D = 128) the bytes of q, k, v and o take longer at 3.35 TB/s than the
// causal half of 4*B*H*S*T*D operations on the bf16 tensor cores.  What held
// the first kernel back was arithmetic: every product ran in float32 on the
// CUDA cores, every score went through shared memory between three barriers
// per key tile, and K and V were widened to float32 there.  What bounds this
// one is the chain of key tiles of the longest causal query tile: each step
// of it waits on the one before (scores, softmax, P.V).
//
// Two instantiations behind one entry, chosen by the dtype:
//
// * bf16: tensor cores (mma.sync m16n8k16, bf16 operands from ldmatrix,
//   float32 sums).  A block takes a 64-row query tile of one (batch, head)
//   with two key groups of 4 warps; a warp owns 16 query rows.  Group g
//   streams key tiles g, g + 2, ... of 64 keys through its own 3-stage ring
//   in shared memory, in bf16, with cp.async (16-byte chunks, zero-filled
//   past T) two tiles ahead, and the groups merge their rows' maxima, sums
//   and accumulators through shared memory at the end: that halves the
//   chain of a causal block and gives every SM sub-core two warps.  Q stays
//   in registers as A fragments.  Each step multiplies the scores of the
//   next tile while it turns this tile's into P, in one stretch of code, so
//   the tensor cores and the softmax overlap.  The scale 1/sqrt(D) is
//   applied to the float32 scores in the exp2's FMA; the online softmax
//   stays in registers (quad shuffles for the row max and sum).  P.V runs
//   on the tensor cores without losing P's precision: P = P_hi + P_lo with
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), both products accumulated in
//   float32 (V is bf16 already and exact), which keeps P to about 2^-16
//   relative.  The head dim is zero-padded in shared memory to the next of
//   16, 32, 64, 80, 96, 128, 192, 256; rows are padded by 16 bytes so
//   ldmatrix reads no bank twice.  Above D = 128 one key group streams
//   every tile (two rings would not fit).  Query tiles are launched
//   longest-first.  mma.sync rather than wgmma: P.V on wgmma was tried and
//   was not faster here, as the chain above and not the tensor rate sets
//   the time.
// * float32: the first kernel, on the CUDA cores.  A bf16 tensor core cannot
//   take float32 operands exactly.  One block of 128 threads per (query tile
//   of 32 rows, head, batch); per key tile of 64 the threads load K and V
//   into shared memory (rows padded by one float against bank conflicts),
//   each computes a 4 x 4 register tile of scores, each warp then updates
//   the running max and denominator of 8 rows with shuffles, and each thread
//   accumulates P.V for 4 rows and D/16 head dims in registers.
//
// Causal blocks of both stop at the diagonal's last key tile.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;      // the reference kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_D = 256;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_GROUP = 128;          // threads of a key group
constexpr int TC_WARPS = TC_GROUP / 32;  // its warps, 16 query rows each
constexpr int TC_BQ = 16 * TC_WARPS;   // query rows per block
constexpr int TC_BK = 64;              // keys per tile
constexpr int TC_KN = TC_BK / 8;       // key n-tiles of a score tile
constexpr int TC_KCH = TC_BK / 16;     // 16-key steps of P . V
constexpr int TC_KG = 2;               // key groups where the rings fit

// Per padded head dim DP: key groups per block (each streams every KG-th key
// tile through its own ring; two where their rings fit in shared memory),
// the depth of a group's K/V ring, threads, and shared-memory rows of
// DP + 8 bf16 (at most 227 KB).
template <int DP>
struct TcCfg {
  static constexpr int KG = DP <= 128 ? TC_KG : 1;
  static constexpr int STAGES = DP <= 192 ? 3 : 2;
  static constexpr int THREADS = TC_GROUP * KG;
  static constexpr int ROWS = TC_BQ + KG * STAGES * 2 * TC_BK;
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * ROWS * (DP + 8);
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros where `bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// a barrier of the 128 threads of key group g only
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(TC_GROUP) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 -> (bf16(x0), bf16(x1)) and the bf16 of what that rounding lost
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 2^x in one MUFU instruction (results below 2^-126 flush to zero)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Which 16-byte chunks of a tile thread gt of a key group copies:
// rows r, r + dr, ... with column chunk c, c + dc, ... carried into the next
// row, the same for every tile, so the copy loop needs no division.
struct Chunks {
  int gt, r, c, dr, dc, n;   // n: chunks per row
  __device__ Chunks(int gt_, int d) : gt(gt_) {
    n = d / 8;
    r = gt / n;
    c = gt % n;
    dr = TC_GROUP / n;
    dc = TC_GROUP % n;
  }
};

// Rows [r0, r0 + ROWS) of head hh of a (B, len, nh, d) tensor into a tile
// of DP + 8 bf16 per row, by the threads of one key group; rows past len
// are zeros.  With d a multiple of 8 each row is d / 8 asynchronous 16-byte
// chunks and the columns d..DP stay as zeroed at the start; otherwise every
// column is written, zeros past d.
template <int DP, int ROWS = TC_BK>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t b, int r0, int len, int nh,
                                          int hh, int d, bool vec,
                                          const Chunks& ch) {
  constexpr int LD = DP + 8;
  const int64_t stride = static_cast<int64_t>(nh) * d;
  const bf16* base = src + ((b * len + r0) * nh + hh) * d;
  const int rows = len - r0;            // rows of this tile that exist
  if (vec) {
    int r = ch.r, c = ch.c;
    while (r < ROWS) {
      const bool in = r < rows;
      cp_async16(dst + r * LD + c * 8, base + (in ? r : 0) * stride + c * 8,
                 in ? 16 : 0);
      r += ch.dr;
      c += ch.dc;
      if (c >= ch.n) {
        c -= ch.n;
        ++r;
      }
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = ch.gt; i < ROWS * DP; i += TC_GROUP) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = r < rows && c < d ? base[r * stride + c] : zero;
    }
  }
}

// the largest divisor of n that is at most 8: head-dim pairs of n-tiles
// whose V fragments a warp holds at once
__host__ __device__ constexpr int v_group(int n) {
  int g = n < 8 ? n : 8;
  while (n % g) --g;
  return g;
}

// S = Q . K^T of one key tile: 8 n-tiles of 8 keys for the warp's 16 rows;
// the K fragments of the next 16 dims load while these multiply.  q_lane and
// kst are this lane's ldmatrix addresses; qf holds Q where Q_IN_REGS.
template <int DP, bool Q_IN_REGS>
__device__ __forceinline__ void qk_tile(float (&sc)[TC_KN][4],
                                        const uint32_t (&qf)[Q_IN_REGS ? DP / 16 : 1][4],
                                        const bf16* q_lane, const bf16* kst) {
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;
#pragma unroll
  for (int n = 0; n < TC_KN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  uint32_t kf[2][TC_KN / 2][4];
#pragma unroll
  for (int np = 0; np < TC_KN / 2; ++np)
    ldmatrix_x4(kf[0][np], kst + np * 16 * LD);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if (kc + 1 < KC) {
#pragma unroll
      for (int np = 0; np < TC_KN / 2; ++np)
        ldmatrix_x4(kf[(kc + 1) % 2][np], kst + np * 16 * LD + (kc + 1) * 16);
    }
    uint32_t a[4];
    if (Q_IN_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[Q_IN_REGS ? kc : 0][e];
    } else {
      ldmatrix_x4(a, q_lane + kc * 16);
    }
#pragma unroll
    for (int np = 0; np < TC_KN / 2; ++np) {
      mma_bf16(sc[2 * np], a, kf[kc % 2][np][0], kf[kc % 2][np][1]);
      mma_bf16(sc[2 * np + 1], a, kf[kc % 2][np][2], kf[kc % 2][np][3]);
    }
  }
}

// NEG_INF at keys past t and, when causal, above the diagonal, for the key
// tile at k0 of the warp whose first row is r0; rows a and b and first key
// column col0 are this thread's.  Tiles that need no mask return at once.
__device__ __forceinline__ void mask_tile(float (&sc)[TC_KN][4], int k0, int t,
                                          int causal, int r0, int row_a,
                                          int row_b, int col0) {
  if (k0 + TC_BK <= t && (!causal || k0 + TC_BK - 1 <= r0)) return;
#pragma unroll
  for (int n = 0; n < TC_KN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + n * 8 + col0 + (e & 1);
      const int row = e < 2 ? row_a : row_b;
      if (col >= t || (causal && col > row)) sc[n][e] = NEG_INF;
    }
}

// One step of the online softmax on the scores sc of a key tile (masked,
// unscaled): the rows' new maxima and sums, acc rescaled, and P split into
// bf16 hi and lo parts as A fragments of keys 16c..16c+15: the C fragments
// of key n-tiles 2c and 2c+1.
template <int NT>
__device__ __forceinline__ void softmax_step(
    float (&sc)[TC_KN][4], float& m_a, float& m_b, float& l_a, float& l_b,
    float (&acc)[NT][4], float scale_log2e, uint32_t (&ph)[TC_KCH][4],
    uint32_t (&pl)[TC_KCH][4]) {
  // the new running max of each row (of the unscaled scores: the scale is
  // positive)
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int n = 0; n < TC_KN; ++n) {
    mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  // exp(scale (x - m)) as 2^(x scale log2 e - m scale log2 e): the scale
  // applied to the float32 score in one FMA, then one MUFU
  const float ml_a = mx_a * scale_log2e, ml_b = mx_b * scale_log2e;
  const float alpha_a = exp2_ftz(fmaf(m_a, scale_log2e, -ml_a));
  const float alpha_b = exp2_ftz(fmaf(m_b, scale_log2e, -ml_b));
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < TC_KN; ++n) {
    sc[n][0] = exp2_ftz(fmaf(sc[n][0], scale_log2e, -ml_a));
    sc[n][1] = exp2_ftz(fmaf(sc[n][1], scale_log2e, -ml_a));
    sc[n][2] = exp2_ftz(fmaf(sc[n][2], scale_log2e, -ml_b));
    sc[n][3] = exp2_ftz(fmaf(sc[n][3], scale_log2e, -ml_b));
    sum_a += sc[n][0] + sc[n][1];
    sum_b += sc[n][2] + sc[n][3];
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= alpha_a;
    acc[n][1] *= alpha_a;
    acc[n][2] *= alpha_b;
    acc[n][3] *= alpha_b;
  }
#pragma unroll
  for (int c = 0; c < TC_KCH; ++c) {
    split2(sc[2 * c][0], sc[2 * c][1], ph[c][0], pl[c][0]);
    split2(sc[2 * c][2], sc[2 * c][3], ph[c][1], pl[c][1]);
    split2(sc[2 * c + 1][0], sc[2 * c + 1][1], ph[c][2], pl[c][2]);
    split2(sc[2 * c + 1][2], sc[2 * c + 1][3], ph[c][3], pl[c][3]);
  }
}

// acc += P_hi . V + P_lo . V over a key tile, 16 keys by VG pairs of dim
// n-tiles at a time: every hi product first, so each lo product finds its
// sum ready.  vst is this lane's ldmatrix address in the V tile.
template <int DP>
__device__ __forceinline__ void pv_tile(float (&acc)[DP / 8][4],
                                        const uint32_t (&ph)[TC_KCH][4],
                                        const uint32_t (&pl)[TC_KCH][4],
                                        const bf16* vst) {
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;
  constexpr int VG = v_group(KC);
#pragma unroll
  for (int c = 0; c < TC_KCH; ++c) {
#pragma unroll
    for (int g0 = 0; g0 < KC; g0 += VG) {
      uint32_t vf[VG][4];
#pragma unroll
      for (int g = 0; g < VG; ++g)
        ldmatrix_x4_trans(vf[g], vst + c * 16 * LD + (g0 + g) * 16);
#pragma unroll
      for (int g = 0; g < VG; ++g) {
        mma_bf16(acc[2 * (g0 + g)], ph[c], vf[g][0], vf[g][1]);
        mma_bf16(acc[2 * (g0 + g) + 1], ph[c], vf[g][2], vf[g][3]);
      }
#pragma unroll
      for (int g = 0; g < VG; ++g) {
        mma_bf16(acc[2 * (g0 + g)], pl[c], vf[g][0], vf[g][1]);
        mma_bf16(acc[2 * (g0 + g) + 1], pl[c], vf[g][2], vf[g][3]);
      }
    }
  }
}

// DP: the head dim padded to a multiple of 16 (the mma's depth)
template <int DP>
__global__ void __launch_bounds__(TcCfg<DP>::THREADS)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int s, int t, int h, int kh, int d, float scale,
                            int causal) {
  using Cfg = TcCfg<DP>;
  constexpr int KG = Cfg::KG;
  constexpr int STAGES = Cfg::STAGES;
  constexpr int LD = DP + 8;            // 16 bytes of padding per row
  constexpr int KC = DP / 16;           // 16-wide steps along the head dim
  constexpr int NT = DP / 8;            // head-dim n-tiles of the output
  constexpr bool Q_IN_REGS = DP <= 128;
  constexpr int TILE = TC_BK * LD;
  static_assert(STAGES == 2 || STAGES == 3, "ring depth");
  extern __shared__ __align__(16) unsigned char fa_tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_tc_smem);   // TC_BQ x LD

  const int head = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;  // longest first
  const int kvh = head / (h / kh);
  const int kg = threadIdx.x / TC_GROUP;                 // key group
  const int wr = threadIdx.x % TC_GROUP / 32;            // row block
  const int lane = threadIdx.x % 32;
  const bool vec = d % 8 == 0;
  // this group's ring: stages of K, then stages of V
  bf16* ks = qs + TC_BQ * LD + kg * STAGES * 2 * TILE;
  bf16* vs = ks + STAGES * TILE;

  if (vec && d < DP) {                  // the zero padding cp.async skips
    const bf16 zero = __float2bfloat16_rn(0.f);
    const int pad = DP - d;
    for (int i = threadIdx.x; i < Cfg::ROWS * pad; i += Cfg::THREADS)
      qs[(i / pad) * LD + d + i % pad] = zero;
  }

  // key tiles kg, kg + KG, ... are this group's: its i-th tile goes to
  // stage i % STAGES
  const int t_end = causal ? min(t, q0 + TC_BQ) : t;
  const int n_tiles = (t_end + TC_BK - 1) / TC_BK;
  const Chunks ch(threadIdx.x % TC_GROUP, vec ? d : 8);
  auto load_kv = [&](int i) {           // this group's tile i, if any
    const int j = kg + i * KG;
    if (j < n_tiles) {
      const int st = i % STAGES;
      load_tile<DP>(ks + st * TILE, k, b, j * TC_BK, t, kh, kvh, d, vec, ch);
      load_tile<DP>(vs + st * TILE, v, b, j * TC_BK, t, kh, kvh, d, vec, ch);
    }
    cp_async_commit();
  };
  // commit groups: q, tile 0, tile 1, then one tile per step
  if (kg == 0) load_tile<DP, TC_BQ>(qs, q, b, q0, s, h, head, d, vec, ch);
  cp_async_commit();
  load_kv(0);
  load_kv(1);
  cp_async_wait<2>();                   // this thread's q chunks are in
  __syncthreads();                      // and everyone's, zero padding too

  // ldmatrix addresses of this lane: the A fragment (16 rows x 16) of Q,
  // two key n-tiles x 16 dims of K, 16 keys x two dim n-tiles of V
  const bf16* q_lane = qs + (wr * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (lane >> 4) * 8;
  uint32_t qf[Q_IN_REGS ? KC : 1][4];
  if (Q_IN_REGS) {
#pragma unroll
    for (int kc = 0; kc < (Q_IN_REGS ? KC : 0); ++kc)
      ldmatrix_x4(qf[kc], q_lane + kc * 16);
  }
  // this thread's rows (of the mma's C fragment) and first key column
  const int row_a = q0 + wr * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int col0 = 2 * (lane % 4);
  const int r0 = q0 + wr * 16;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;   // running max of rows a and b
  float l_a = 0.f, l_b = 0.f;           // this thread's share of the sums
  const float scale_log2e = scale * LOG2E;

  // S of this group's first tile; then each step multiplies the next
  // tile's S while it turns this one into P (one stretch of code, so the
  // tensor cores and the softmax overlap), and adds P . V
  const int my_tiles = kg < n_tiles ? (n_tiles - kg + KG - 1) / KG : 0;
  float sc[TC_KN][4];
  if (my_tiles > 0) {
    cp_async_wait<1>();                 // tile 0
    group_sync(kg);
    qk_tile<DP, Q_IN_REGS>(sc, qf, q_lane, ks + k_lane);
    mask_tile(sc, kg * TC_BK, t, causal, r0, row_a, row_b, col0);
  }
  for (int i = 0; i < my_tiles; ++i) {
    uint32_t ph[TC_KCH][4], pl[TC_KCH][4];
    const bf16* vst = vs + i % STAGES * TILE + v_lane;
    if (i + 1 < my_tiles) {
      cp_async_wait<0>();               // this thread's chunks of tile i + 1
      group_sync(kg);                   // everyone's; tile i - 1 is done
      float sn[TC_KN][4];
      qk_tile<DP, Q_IN_REGS>(sn, qf, q_lane,
                             ks + (i + 1) % STAGES * TILE + k_lane);
      softmax_step<NT>(sc, m_a, m_b, l_a, l_b, acc, scale_log2e, ph, pl);
      if (STAGES == 3) load_kv(i + 2);  // into tile i - 1's stage
      pv_tile<DP>(acc, ph, pl, vst);
      if (STAGES == 2) {                // a two-stage ring refills only now
        group_sync(kg);
        load_kv(i + 2);
      }
      mask_tile(sn, (kg + (i + 1) * KG) * TC_BK, t, causal, r0, row_a, row_b,
                col0);
#pragma unroll
      for (int n = 0; n < TC_KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = sn[n][e];
    } else {
      softmax_step<NT>(sc, m_a, m_b, l_a, l_b, acc, scale_log2e, ph, pl);
      pv_tile<DP>(acc, ph, pl, vst);
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (KG > 1) {
    // the other groups hand their rows' max, sum and accumulator to group 0
    // through the (now idle) rings, in fragment order, and group 0 merges
    constexpr int W = NT * 4 + 4;       // floats per lane
    float* xs = reinterpret_cast<float*>(qs + TC_BQ * LD) + wr * W * 32 +
                lane;
    __syncthreads();
    if (kg > 0) {
      float* x = xs + (kg - 1) * TC_WARPS * W * 32;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(n * 4 + e) * 32] = acc[n][e];
      x[(NT * 4) * 32] = m_a;
      x[(NT * 4 + 1) * 32] = m_b;
      x[(NT * 4 + 2) * 32] = l_a;
      x[(NT * 4 + 3) * 32] = l_b;
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int g = 1; g < KG; ++g) {
      const float* x = xs + (g - 1) * TC_WARPS * W * 32;
      const float mg_a = x[(NT * 4) * 32], mg_b = x[(NT * 4 + 1) * 32];
      const float mm_a = fmaxf(m_a, mg_a), mm_b = fmaxf(m_b, mg_b);
      const float a0 = exp2_ftz((m_a - mm_a) * scale_log2e);
      const float a1 = exp2_ftz((mg_a - mm_a) * scale_log2e);
      const float b0 = exp2_ftz((m_b - mm_b) * scale_log2e);
      const float b1 = exp2_ftz((mg_b - mm_b) * scale_log2e);
      m_a = mm_a;
      m_b = mm_b;
      l_a = l_a * a0 + x[(NT * 4 + 2) * 32] * a1;
      l_b = l_b * b0 + x[(NT * 4 + 3) * 32] * b1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] = acc[n][0] * a0 + x[(n * 4) * 32] * a1;
        acc[n][1] = acc[n][1] * a0 + x[(n * 4 + 1) * 32] * a1;
        acc[n][2] = acc[n][2] * b0 + x[(n * 4 + 2) * 32] * b1;
        acc[n][3] = acc[n][3] * b0 + x[(n * 4 + 3) * 32] * b1;
      }
    }
  }

  l_a = fmaxf(l_a, 1e-20f);
  l_b = fmaxf(l_b, 1e-20f);
  const bool pairs = d % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= s) continue;
    const float l = half ? l_b : l_a;
    bf16* orow = o + ((b * s + row) * h + head) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + col0;
      const float y0 = acc[n][2 * half] / l, y1 = acc[n][2 * half + 1] / l;
      if (pairs && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (c < d) orow[c] = __float2bfloat16_rn(y0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int s, int t, int h, int kh, int d, float scale, int causal,
                cudaStream_t stream) {
  using Cfg = TcCfg<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b, (s + TC_BQ - 1) / TC_BQ);
  flash_attention_bf16_kernel<DP><<<grid, Cfg::THREADS, Cfg::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), s, t, h, kh, d,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the padded head dims instantiated: each D <= 256 takes the next one up
int launch_bf16_d(const void* q, const void* k, const void* v, void* o, int b,
                  int s, int t, int h, int kh, int d, float scale, int causal,
                  cudaStream_t st) {
#define REPRO_FA_DP(DP) \
  if (d <= DP) return launch_bf16<DP>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st)
  REPRO_FA_DP(16);
  REPRO_FA_DP(32);
  REPRO_FA_DP(64);
  REPRO_FA_DP(80);
  REPRO_FA_DP(96);
  REPRO_FA_DP(128);
  REPRO_FA_DP(192);
  REPRO_FA_DP(256);
#undef REPRO_FA_DP
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FA_THREADS = 128;
constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int ROW_GROUPS = 8;          // thread groups along rows
constexpr int COL_GROUPS = 16;         // along keys (scores) or dims (P.V)
constexpr int RPT = BQ / ROW_GROUPS;   // rows per thread: 4
constexpr int CPT = BK / COL_GROUPS;   // keys per thread: 4
constexpr int ROWS_PER_WARP = BQ / (FA_THREADS / 32);  // 8
static_assert(ROW_GROUPS * COL_GROUPS == FA_THREADS, "thread layout");
static_assert(BK == 64, "phase 2 reads two keys per lane");

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
template <int NC>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int s, int t, int h, int kh, int d, float scale,
                           int causal) {
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
    if (row < s) val = q[((b * s + row) * h + head) * d + dd] * scale;
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
        kv = k[off];
        vv = v[off];
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
    float* orow = o + ((b * s + row) * h + head) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int dd = cg + COL_GROUPS * n;
      if (dd < d) orow[dd] = acc[i][n] / l;
    }
  }
}

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int s, int t, int h, int kh, int d, float scale, int causal,
               cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_attention_f32_kernel<NC><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, t, h, kh, d,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_d(const void* q, const void* k, const void* v, void* o, int b,
                 int s, int t, int h, int kh, int d, float scale, int causal,
                 cudaStream_t st) {
  if (d <= 16) return launch_f32<1>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  if (d <= 32) return launch_f32<2>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  if (d <= 64) return launch_f32<4>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  if (d <= 128) return launch_f32<8>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  return launch_f32<16>(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
}

}  // namespace

// q, o (B, S, H, D); k, v (B, T, KH, D); all contiguous, in bf16 ? bf16 :
// float32.  H a multiple of KH, 1 <= D <= 256.  bf16 runs on the tensor
// cores, float32 on the CUDA cores; neither falls back to the other.
// Returns a cudaError_t code (cudaErrorInvalidValue for shapes outside
// those).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bf16, int b,
                                     int s, int t, int h, int kh, int d,
                                     float scale, int causal, void* stream) {
  if (d < 1 || d > MAX_D || kh < 1 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bf16_d(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
  return launch_f32_d(q, k, v, o, b, s, t, h, kh, d, scale, causal, st);
}
