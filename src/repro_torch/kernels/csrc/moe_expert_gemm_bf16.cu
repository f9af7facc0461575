// moe_expert_gemm_bf16: the expert products of the MoE layer over the filled
// rows of each expert's capacity buffer, in bf16 on the tensor cores.
//
// Replaces no TPU kernel: the reference's expert products are jnp einsums
// (repro/models/moe.py::_moe_layer_flat), left to XLA, and the port ran the
// bf16 ones (an LM's MoE MLP) as three dense torch.bmm over the whole
// (experts, capacity, d) buffer.  Dropless routing (capacity factor
// experts / top-k) gives every expert room for every token of a call, so a
// decode step of 8 tokens reads all 128 experts' weights where about 50 hold
// a row, and a prefill of n tokens computes 128 n rows where 8 n hold one.
// Here each expert's fill (the tokens its buffer holds, clamped to the
// capacity, on the device) bounds the rows computed, and an expert that holds
// no row reads none of its weights:
//
//   moe_expert_gemm_bf16_gate_up  h[e, r, :] = silu(x[e, r] . Wg[e]) * (x[e, r] . Wu[e])
//   moe_expert_gemm_bf16_down     y[e, r, :] = h[e, r] . Wd[e]
//
// for r < fill[e]; rows at or past the fill are not written, and what the
// input holds there reaches no written row.  Layouts are the module's: x
// (E, C, D), Wg and Wu (E, D, F), Wd (E, F, D), h (E, C, F), y (E, C, D), all
// contiguous bf16, D and F multiples of 8.  Products accumulate in float32;
// the SiLU and the product of gate_up's epilogue are float32 too, and each
// output is rounded to bf16 once.
//
// Bound on the H100 (Qwen3-30B-A3B: E 128, D 2048, F 768): the weight bytes
// of the experts that hold a row.  A decode step of 8 tokens routes 64 rows
// to about 50 experts: 0.48 GB a layer, 0.14 ms at 3.35 TB/s, against 0.6
// GFLOP (8 FLOP a weight byte; the card's bf16 balance is 295).  A prefill of
// 1,108 tokens fills all 128 experts with about 69 rows each: 69 FLOP a byte,
// still below the balance.  So the kernels must stream weights at the HBM
// rate while the tensor cores idle.  Design:
//
// * Swapped operands: the weight is the mma's A (its output columns are M,
//   read from shared memory with ldmatrix.trans) and the expert's rows of x
//   or h are its B (N = 8 rows a chunk), so the few rows of a decode step
//   fill an m16n8k16 tile and no tensor-core work pads them to 64.
// * A block takes one item (an expert's tile of up to 64 filled rows) for a
//   slice of weight columns (gate_up: 64 of Wg and the same 64 of Wu, so the
//   SiLU and the product happen in the epilogue; down: 128 of Wd), and
//   streams the slice's K rows through a STAGES-deep ring in shared memory:
//   thread 0 issues TMA copies (3-D tensor maps, zeros past every edge, the
//   128-byte swizzle, so ldmatrix is free of bank conflicts) that complete on
//   the stage's mbarrier.
// * The items are compact: each block reads the fills, numbers every
//   expert's row tiles in expert order, and takes items blockIdx.y,
//   blockIdx.y + gridDim.y, ...  An expert with no row has no item, so its
//   weights are never read.  The grid is fixed by the host's E, C and an
//   upper bound of the fills' sum (the routed rows), never by the fills, so a
//   launch needs no read-back and a CUDA graph can capture it; a bound that is
//   too small costs a loop, not a row.
// * The tile follows the fill: the N side is instantiated for 1, 2, 4 or 8
//   chunks of 8 rows, and only the filled chunks of x are copied.  Tiles of
//   one expert run side by side, so their weight reads meet in L2.
// * Every output is a sum over k in a fixed order whatever the fill, its
//   chunk or its tile: a row's result does not depend on the other rows.
#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;                   // four warps
constexpr int WARPS = THREADS / 32;
constexpr int BOX_COLS = 64;                   // weight columns a box: 128 B
constexpr int BK = 64;                         // K rows a stage: 128 B of x
constexpr int STAGES = 4;
constexpr int CHUNK_ROWS = 8;                  // the mma's N
constexpr int MAX_CHUNKS = 8;
constexpr int TILE_ROWS = CHUNK_ROWS * MAX_CHUNKS;    // rows an item
constexpr int W_BOX_BYTES = BK * BOX_COLS * 2;        // 8 KB
constexpr int X_CHUNK_BYTES = CHUNK_ROWS * BK * 2;    // 1 KB
constexpr int STAGE_BYTES = 2 * W_BOX_BYTES + MAX_CHUNKS * X_CHUNK_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;      // 96 KB
constexpr int SWIZZLE_ALIGN = 1024;            // the 128-byte swizzle's period
constexpr int MIN_BLOCKS = 2;                  // resident blocks an SM
constexpr int MAX_GRID_Y = 65535;

static_assert(BOX_COLS * 2 == 128 && BK * 2 == 128,
              "every box row is one 128-byte swizzle row");
static_assert(BOX_COLS == 16 * WARPS, "a warp owns one m16 tile of a box");
static_assert(BK % 32 == 0, "a stage is whole k32 steps");
static_assert(W_BOX_BYTES % SWIZZLE_ALIGN == 0
              && X_CHUNK_BYTES % SWIZZLE_ALIGN == 0,
              "every box starts on the swizzle's period");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The box of a 3-D tensor map at (c0, c1, c2), innermost first, into the
// shared address dst; its bytes count down bar's transaction.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a box of 128-byte rows that TMA
// wrote with the 128-byte swizzle (the box on the swizzle's period).
__device__ __forceinline__ unsigned swz(int r, int c) {
  return static_cast<unsigned>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Four 8x8 b16 matrices; lanes 8q..8q+7 give the rows of matrix q.
__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// torch's SiLU in float: g / (1 + exp(-g))
__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

// One item: rows [r0, r0 + rows) of expert e (rows <= 8 NCH) by the block's
// column slice.  GATED: x (E, C, K) by Wg (box a) and Wu (box b), both the
// slice's BOX_COLS columns of (E, K, N), into h (E, C, N); otherwise h (E, C,
// K) by Wd's 2 BOX_COLS columns (box a, then box b) into y (E, C, N).  The
// item's stages are g0, g0 + 1, ... of the block's ring.  NCH is a template
// parameter so the inner loop has no branch and holds only the accumulators
// it needs.
template <bool GATED, int NCH>
__device__ __forceinline__ void item_tile(
    const CUtensorMap* tm_x, const CUtensorMap* tm_a, const CUtensorMap* tm_b,
    bf16* __restrict__ y, unsigned ring, uint64_t* full, int e, int r0,
    int rows, int cap, int k_dim, int n_dim, int g0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * (GATED ? BOX_COLS : 2 * BOX_COLS);
  const int c_a = n0, c_b = GATED ? n0 : n0 + BOX_COLS;
  const int nk = (k_dim + BK - 1) / BK;
  const int chunks = (rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const unsigned stage_tx = 2 * W_BOX_BYTES + chunks * X_CHUNK_BYTES;

  // thread 0 loads the item's stage kt, the block's stage g
  auto fetch = [&](int g, int kt) {
    uint64_t* bar = full + g % STAGES;
    const unsigned st = ring + (g % STAGES) * STAGE_BYTES;
    const int k0 = kt * BK;
    mbar_expect_tx(bar, stage_tx);
    tma_load(st, tm_a, bar, c_a, k0, e);
    tma_load(st + W_BOX_BYTES, tm_b, bar, c_b, k0, e);
    for (int c = 0; c < chunks; ++c)
      tma_load(st + 2 * W_BOX_BYTES + c * X_CHUNK_BYTES, tm_x, bar, k0,
               r0 + c * CHUNK_ROWS, e);
  };

  float acc[2][NCH][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[b][j][i] = 0.f;

  // ldmatrix.trans of A: matrix q = lane / 8 is k rows 8 (q / 2) .. + 7 of
  // the k16 step by the warp's columns 8 (q % 2) .. + 7: a0..a3 of the mma
  const int a_row = (lane & 7) + 8 * (lane >> 4);
  const int a_chunk = 2 * warp + ((lane >> 3) & 1);
  // ldmatrix of B: the chunk's 8 rows by k 8q .. 8q + 7 of the k32 step:
  // b0, b1 of its first k16 step, then of its second
  const int b_row = lane & 7, b_chunk = lane >> 3;

  // every thread is done with the ring's stages of the block's last item
  __syncthreads();
  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES - 1 && s < nk; ++s) fetch(g0 + s, s);
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    // every thread is done with stage kt - 1: its slot takes kt + STAGES - 1
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (tid == 0 && next < nk) fetch(g0 + next, next);
    const int g = g0 + kt;
    mbar_wait(full + g % STAGES, (g / STAGES) & 1);
    const unsigned st = ring + (g % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int k32 = 0; k32 < BK / 32; ++k32) {
      uint32_t a[2][2][4];                     // [box][k16 step]
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          ldsm_x4_t(st + b * W_BOX_BYTES + swz(32 * k32 + 16 * s + a_row,
                                               a_chunk), a[b][s]);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        uint32_t bx[4];
        ldsm_x4(st + 2 * W_BOX_BYTES + j * X_CHUNK_BYTES
                + swz(b_row, 4 * k32 + b_chunk), bx);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          mma(acc[b][j], a[b][0], bx[0], bx[1]);
          mma(acc[b][j], a[b][1], bx[2], bx[3]);
        }
      }
    }
  }

  // acc[b][j][i]: column 16 warp + lane / 4 (+ 8 for i >= 2) of box b, row
  // 8 j + 2 (lane % 4) (+ 1 for odd i) of the item
  bf16* ye = y + (static_cast<int64_t>(e) * cap + r0) * n_dim;
  const int m = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = CHUNK_ROWS * j + 2 * (lane & 3) + (i & 1);
      if (row >= rows) continue;
      bf16* yr = ye + static_cast<int64_t>(row) * n_dim;
      const int dm = (i >> 1) * 8;
      if (GATED) {
        const int col = c_a + m + dm;
        if (col < n_dim)
          yr[col] = __float2bfloat16(silu(acc[0][j][i]) * acc[1][j][i]);
      } else {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = (b ? c_b : c_a) + m + dm;
          if (col < n_dim) yr[col] = __float2bfloat16(acc[b][j][i]);
        }
      }
    }
  }
}

// Block (slice, i) takes the items i, i + gridDim.y, ... of the compact list
// of every expert's row tiles, in expert order.
template <bool GATED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
moe_expert_gemm_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b,
                            const int64_t* __restrict__ fill,
                            bf16* __restrict__ y, int n_exp, int cap,
                            int k_dim, int n_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int warp_sum[WARPS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned base = smem_u32(smem);
  const unsigned ring = (base + SWIZZLE_ALIGN - 1) & ~(SWIZZLE_ALIGN - 1u);
  // past the ring, never written by a copy: each expert's fill, and the
  // number of its first item (first[n_exp]: the items of all experts)
  int* fills = reinterpret_cast<int*>(smem + (ring - base) + RING_BYTES);
  int* first = fills + n_exp;

  // each thread counts the tiles of its run of experts; a scan over the
  // block numbers them
  const int per = (n_exp + THREADS - 1) / THREADS;
  const int lo = min(tid * per, n_exp), hi = min(lo + per, n_exp);
  int own = 0;
  for (int i = lo; i < hi; ++i) {
    const int64_t f = fill[i];
    const int fi = static_cast<int>(f < 0 ? 0 : (f > cap ? cap : f));
    fills[i] = fi;
    own += (fi + TILE_ROWS - 1) / TILE_ROWS;
  }
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int i = lo; i < hi; ++i) {
    first[i] = run;
    run += (fills[i] + TILE_ROWS - 1) / TILE_ROWS;
  }
  if (tid == THREADS - 1) first[n_exp] = run;
  __syncthreads();

  const int items = first[n_exp];
  const int nk = (k_dim + BK - 1) / BK;
  int g0 = 0;
#pragma unroll 1
  for (int it = blockIdx.y; it < items; it += gridDim.y, g0 += nk) {
    // the expert whose tiles hold item it: first[e] <= it < first[e + 1]
    int e = 0, e_hi = n_exp;
    while (e_hi - e > 1) {
      const int mid = (e + e_hi) >> 1;
      if (first[mid] <= it) e = mid; else e_hi = mid;
    }
    const int r0 = (it - first[e]) * TILE_ROWS;
    const int rows = min(fills[e] - r0, TILE_ROWS);
    const int chunks = (rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
    if (chunks <= 1)
      item_tile<GATED, 1>(&tm_x, &tm_a, &tm_b, y, ring, full, e, r0, rows,
                          cap, k_dim, n_dim, g0);
    else if (chunks <= 2)
      item_tile<GATED, 2>(&tm_x, &tm_a, &tm_b, y, ring, full, e, r0, rows,
                          cap, k_dim, n_dim, g0);
    else if (chunks <= 4)
      item_tile<GATED, 4>(&tm_x, &tm_a, &tm_b, y, ring, full, e, r0, rows,
                          cap, k_dim, n_dim, g0);
    else
      item_tile<GATED, 8>(&tm_x, &tm_a, &tm_b, y, ring, full, e, r0, rows,
                          cap, k_dim, n_dim, g0);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A bf16 (d2, d1, d0) tensor, contiguous, as a 3-D tensor map whose box is
// (b1, b0) with b0 * 2 = 128 bytes, copied with the 128-byte swizzle:
// elements past its edges read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int d0, int d1, int d2,
                int b0, int b1) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d0) * sizeof(bf16),
      static_cast<cuuint64_t>(d0) * d1 * sizeof(bf16)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATED>
int launch(const void* x, const void* wa, const void* wb,
           const int64_t* fill, void* y, int e, int cap, int k_dim,
           int n_dim, int rows, cudaStream_t stream) {
  const size_t smem = RING_BYTES + SWIZZLE_ALIGN
                      + (2 * static_cast<size_t>(e) + 1) * sizeof(int);
  if (e <= 0 || cap <= 0 || k_dim % 8 || n_dim % 8 || rows < 0
      || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_a, tm_b;
  if (!tensor_map(&tm_x, x, k_dim, cap, e, BK, CHUNK_ROWS)
      || !tensor_map(&tm_a, wa, n_dim, k_dim, e, BOX_COLS, BK)
      || !tensor_map(&tm_b, wb, n_dim, k_dim, e, BOX_COLS, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro::allow_smem(moe_expert_gemm_bf16_kernel<GATED>,
                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most ceil(f / TILE_ROWS) <= f / TILE_ROWS + 1 items an expert, and at
  // most ceil(cap / TILE_ROWS)
  const int64_t tiles = (static_cast<int64_t>(cap) + TILE_ROWS - 1)
                        / TILE_ROWS;
  int64_t items = (static_cast<int64_t>(rows) + TILE_ROWS - 1) / TILE_ROWS
                  + e;
  items = items < e * tiles ? items : e * tiles;
  items = items < MAX_GRID_Y ? items : MAX_GRID_Y;
  const int slice = GATED ? BOX_COLS : 2 * BOX_COLS;
  const dim3 grid((n_dim + slice - 1) / slice, static_cast<unsigned>(items));
  moe_expert_gemm_bf16_kernel<GATED><<<grid, THREADS, smem, stream>>>(
      tm_x, tm_a, tm_b, fill, static_cast<bf16*>(y), e, cap, k_dim, n_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E, C, D), w_gate and w_up (E, D, F), fill (E,) int64, h (E, C, F): all
// contiguous bf16 but fill, D and F multiples of 8; rows an upper bound of
// the fills' sum (it sizes the grid).  Writes h's rows below each expert's
// fill.  Returns a cudaError_t code.
extern "C" int repro_moe_expert_gemm_bf16_gate_up(
    const void* x, const void* w_gate, const void* w_up, const void* fill,
    void* h, int e, int cap, int d, int f, int rows, void* stream) {
  return launch<true>(x, w_gate, w_up, static_cast<const int64_t*>(fill), h,
                      e, cap, d, f, rows, static_cast<cudaStream_t>(stream));
}

// h (E, C, F), w_down (E, F, D), fill (E,) int64, y (E, C, D), as above.
extern "C" int repro_moe_expert_gemm_bf16_down(
    const void* h, const void* w_down, const void* fill, void* y, int e,
    int cap, int f, int d, int rows, void* stream) {
  return launch<false>(h, w_down, w_down, static_cast<const int64_t*>(fill),
                       y, e, cap, f, d, rows,
                       static_cast<cudaStream_t>(stream));
}
