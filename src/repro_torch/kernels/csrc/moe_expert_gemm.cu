// moe_expert_gemm: the expert products of the MoE layer over the filled rows
// of each expert's capacity buffer, in float32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference's expert products are jnp einsums
// (repro/models/moe.py::_moe_layer_flat), left to XLA, and the port ran them
// as three dense torch.bmm over the whole (experts, capacity, d) buffer.  A
// capacity buffer is about half full (capacity factor 2), and a dense batched
// product computes its empty rows too.  Here each expert's fill (the tokens
// its buffer holds, clamped to the capacity, on the device) bounds the rows
// computed, so the host never needs the counts:
//
//   moe_expert_gemm_gate_up  h[e, r, :] = silu(x[e, r] . Wg[e]) * (x[e, r] . Wu[e])
//   moe_expert_gemm_down     y[e, r, :] = h[e, r] . Wd[e]
//
// for r < fill[e]; rows at or past the fill are not written, and what the
// input holds there reaches no written row.  Layouts are the module's: x
// (E, C, D), Wg and Wu (E, D, F), Wd (E, F, D), h (E, C, F), y (E, C, D), all
// contiguous float32.
// Each output sums its K products with fmaf in increasing k, from 0.
//
// Bound on the H100 at the benchmark's shapes (E 128, C 64, D 2048, F 768,
// about 32 filled rows an expert): the weight bytes.  The three weights are
// 2.42 GB a layer (0.72 ms at 3.35 TB/s) against 38.7 GFLOP of filled rows
// (0.58 ms at 67 TFLOP/s): about 16 FLOP a weight byte, below the card's
// float32 balance of 20, so the kernels must stream weights near the HBM
// rate while the multiply-adds keep up.  Design:
//
// * One block holds all rows of its expert's 64-row tile for a slice of 256
//   weight columns (gate_up: 128 columns of Wg and the same 128 of Wu, so the
//   SiLU and the product happen in the epilogue and the two hidden products
//   are never written; down: 256 columns of Wd).  Each weight tile is read
//   from device memory once a call.  Blocks of one expert are neighbours in
//   the grid, so the slices share the expert's rows of x in L2.
// * Thread 0 streams each stage (BK rows of K: two weight half-tiles and
//   the filled row chunks of x) into a STAGES-deep ring in shared memory
//   with TMA copies (3-D tensor maps, zeros past every edge) that complete
//   on the stage's mbarrier: no thread spends instructions on addresses.
// * A warp owns 32 of each half-tile's columns; a thread (row lane rl,
//   column group g) owns 4 columns of each half and the rows 4i + rl of the
//   tile: a register tile of up to 16 rows by 8 columns.  Each weight value a
//   thread loads from shared memory feeds up to 16 multiply-adds.
// * The work follows the fill in chunks of 8 rows: the tile is instantiated
//   for 1 .. 8 chunks, so a block's time scales with its fill rounded up to
//   8, never with the capacity, and all warps stay busy.  A block whose row
//   tile lies past the fill exits.  The grid is fixed by the experts, the
//   column slices and the 64-row tiles of the capacity; block (slice, j)
//   takes the j-th fullest expert, so the longest blocks start first.
// * Rows past the fill inside the last chunk are computed from whatever the
//   buffer holds there and never stored.
#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;                   // four warps
constexpr int ROW_LANES = THREADS / 32;        // row lanes of a warp
constexpr int COL_GROUPS = 32 / ROW_LANES;     // column groups of a warp
constexpr int TILE_ROWS = 64;                  // rows a block holds
constexpr int CHUNK_ROWS = 8;                  // the granularity of the fill
constexpr int CHUNKS = TILE_ROWS / CHUNK_ROWS;  // instantiations of the tile
constexpr int CHUNK_SLOTS = CHUNK_ROWS / ROW_LANES;  // a thread's rows a chunk
constexpr int HALF = 128;                      // columns of a half-tile
constexpr int WARP_COLS = HALF / (THREADS / 32);  // of each half, a warp's
constexpr int COLS = 8;                        // weight columns a thread
constexpr int BK = 16;                         // K rows a stage
constexpr int STAGES = 4;
// steps of 4 K rows unrolled: a shorter loop body ran faster on the card at
// mixed fills than the stage unrolled whole
constexpr int KQ_UNROLL = 2;
constexpr int W_STAGE = 2 * BK * HALF;         // floats: two half-tiles
constexpr int X_STAGE = TILE_ROWS * BK;        // floats
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(STAGES) * (W_STAGE + X_STAGE) * sizeof(float);
constexpr int MIN_BLOCKS = 2;                  // resident blocks an SM

static_assert(WARP_COLS == 4 * COL_GROUPS, "a warp's columns in float4s");
static_assert(CHUNK_ROWS % ROW_LANES == 0 && TILE_ROWS % CHUNK_ROWS == 0,
              "a chunk is whole slots of each thread; whole chunks a tile");
static_assert(BK % 4 == 0 && (BK * 4) % 16 == 0, "TMA boxes of whole 16 B");

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

// The box of a 3-D tensor map at (c0, c1, c2), innermost first, into dst;
// its bytes count down bar's transaction.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// torch's float SiLU: g / (1 + exp(-g))
__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

// One block's tile with NCH chunks of rows to compute (its fill rounded up
// to CHUNK_ROWS).  GATED: x (E, C, K) by Wg and Wu (E, K, N) into h (E, C,
// N), a slice HALF columns wide; otherwise h (E, C, K) by Wd (E, K, N) into
// y (E, C, N), a slice 2 * HALF wide.  NCH is a template parameter so the
// inner loop has no branch and holds only the accumulators it needs.
template <bool GATED, int NCH>
__device__ __forceinline__ void expert_tile(
    const CUtensorMap* tm_x, const CUtensorMap* tm_a, const CUtensorMap* tm_b,
    float* __restrict__ y, float* smem, uint64_t* full, int e, int r0,
    int rows, int cap, int k_dim, int n_dim) {
  constexpr int NS = NCH * CHUNK_SLOTS;        // rows a thread computes
  constexpr unsigned STAGE_TX =
      (W_STAGE + NCH * CHUNK_ROWS * BK) * sizeof(float);
  float* ws = smem;                            // STAGES x (2, BK, HALF)
  float* xs = smem + STAGES * W_STAGE;         // STAGES x (TILE_ROWS, BK)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rl = lane / COL_GROUPS;            // row lane
  // this thread's first column in each half-tile
  const int col = (tid >> 5) * WARP_COLS + 4 * (lane % COL_GROUPS);
  const int n0 = blockIdx.x * (GATED ? HALF : 2 * HALF);
  // global column of each half-tile's first column
  const int c_a = n0, c_b = GATED ? n0 : n0 + HALF;
  const int nk = (k_dim + BK - 1) / BK;

  // thread 0 loads stage kt into ring slot `slot`
  auto fetch = [&](int slot, int kt) {
    uint64_t* bar = full + slot;
    const int k0 = kt * BK;
    float* wsd = ws + slot * W_STAGE;
    float* xsd = xs + slot * X_STAGE;
    mbar_expect_tx(bar, STAGE_TX);
    tma_load(wsd, tm_a, bar, c_a, k0, e);
    tma_load(wsd + BK * HALF, tm_b, bar, c_b, k0, e);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load(xsd + c * CHUNK_ROWS * BK, tm_x, bar, k0, r0 + c * CHUNK_ROWS,
               e);
  };

  float acc[NS][COLS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[i][j] = 0.f;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES - 1 && s < nk; ++s) fetch(s, s);
  }

#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    // every thread is done with stage kt - 1: its slot takes stage
    // kt + STAGES - 1
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (tid == 0 && next < nk) fetch(next % STAGES, next);
    const int slot = kt % STAGES;
    mbar_wait(full + slot, (kt / STAGES) & 1);

    const float* wsd = ws + slot * W_STAGE + col;
    const float* xsd = xs + slot * X_STAGE + rl * BK;
#pragma unroll KQ_UNROLL
    for (int kq = 0; kq < BK / 4; ++kq) {
      float wv[4][COLS];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wrow = wsd + (4 * kq + kk) * HALF;
        const float4 a = *reinterpret_cast<const float4*>(wrow);
        const float4 b = *reinterpret_cast<const float4*>(wrow + BK * HALF);
        wv[kk][0] = a.x; wv[kk][1] = a.y; wv[kk][2] = a.z; wv[kk][3] = a.w;
        wv[kk][4] = b.x; wv[kk][5] = b.y; wv[kk][6] = b.z; wv[kk][7] = b.w;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        // slot i is row ROW_LANES * i + rl of the tile
        const float4 xv = *reinterpret_cast<const float4*>(
            xsd + ROW_LANES * i * BK + 4 * kq);
        const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[i][j] = fmaf(xk[kk], wv[kk][j], acc[i][j]);
      }
    }
  }

  float* ye = y + (static_cast<int64_t>(e) * cap + r0) * n_dim;
  const int ca = c_a + col, cb = c_b + col;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int row = ROW_LANES * i + rl;
    if (row >= rows) continue;
    float* yr = ye + static_cast<int64_t>(row) * n_dim;
    if (GATED) {
      if (ca < n_dim) {
        *reinterpret_cast<float4*>(yr + ca) = make_float4(
            silu(acc[i][0]) * acc[i][4], silu(acc[i][1]) * acc[i][5],
            silu(acc[i][2]) * acc[i][6], silu(acc[i][3]) * acc[i][7]);
      }
    } else {
      if (ca < n_dim)
        *reinterpret_cast<float4*>(yr + ca) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (cb < n_dim)
        *reinterpret_cast<float4*>(yr + cb) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// The tile instantiated for nch chunks, 1 <= nch <= N.
template <bool GATED, int N, typename... Args>
__device__ __forceinline__ void tile_of(int nch, Args... args) {
  if constexpr (N > 1) {
    if (nch < N) {
      tile_of<GATED, N - 1>(nch, args...);
      return;
    }
  }
  expert_tile<GATED, N>(args...);
}

// Block (slice, j, tile) computes the j-th fullest expert, the lower index
// first among equal fills: the longest blocks start first, and the short
// ones fill the last wave.
template <bool GATED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
moe_expert_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const int64_t* __restrict__ fill,
                       float* __restrict__ y, int cap, int k_dim, int n_dim) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int expert;
  const int n_exp = gridDim.y;
  int* fills = reinterpret_cast<int*>(smem);   // before the ring is filled
  for (int i = threadIdx.x; i < n_exp; i += THREADS) {
    const int64_t f = fill[i];
    fills[i] = static_cast<int>(f < 0 ? 0 : (f > cap ? cap : f));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_exp; j += THREADS) {
    const int fj = fills[j];
    int rank = 0;
    for (int i = 0; i < n_exp; ++i) {
      const int fi = fills[i];
      rank += fi > fj || (fi == fj && i < j);
    }
    if (rank == static_cast<int>(blockIdx.y)) expert = j;
  }
  __syncthreads();
  const int e = expert;
  const int r0 = blockIdx.z * TILE_ROWS;
  const int rows = min(fills[e] - r0, TILE_ROWS);
  // fills is read: the ring's copies (the async proxy) may overwrite it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (rows <= 0) return;                       // the tile is past the fill
  tile_of<GATED, CHUNKS>((rows + CHUNK_ROWS - 1) / CHUNK_ROWS, &tm_x, &tm_a,
                         &tm_b, y, smem, full, e, r0, rows, cap, k_dim, n_dim);
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

// A float32 (d2, d1, d0) tensor, contiguous, as a 3-D tensor map whose box
// is (b1, b0): elements past its edges read as zeros.
bool tensor_map(CUtensorMap* map, const float* base, int d0, int d1, int d2,
                int b0, int b1) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(d0) * sizeof(float),
      static_cast<cuuint64_t>(d0) * d1 * sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATED>
int launch(const float* x, const float* wa, const float* wb,
           const int64_t* fill, float* y, int e, int cap, int k_dim,
           int n_dim, cudaStream_t stream) {
  if (static_cast<size_t>(e) * sizeof(int) > SMEM_BYTES || e > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_a, tm_b;
  if (!tensor_map(&tm_x, x, k_dim, cap, e, BK, CHUNK_ROWS)
      || !tensor_map(&tm_a, wa, n_dim, k_dim, e, HALF, BK)
      || !tensor_map(&tm_b, wb, n_dim, k_dim, e, HALF, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro::allow_smem(moe_expert_gemm_kernel<GATED>,
                                      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slice = GATED ? HALF : 2 * HALF;
  const dim3 grid((n_dim + slice - 1) / slice, e,
                  (cap + TILE_ROWS - 1) / TILE_ROWS);
  moe_expert_gemm_kernel<GATED><<<grid, THREADS, SMEM_BYTES, stream>>>(
      tm_x, tm_a, tm_b, fill, y, cap, k_dim, n_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E, C, D), w_gate and w_up (E, D, F), fill (E,) int64, h (E, C, F): all
// contiguous float32 but fill, D and F multiples of 4.  Writes h's rows below
// each expert's fill.  Returns a cudaError_t code.
extern "C" int repro_moe_expert_gemm_gate_up(
    const void* x, const void* w_gate, const void* w_up, const void* fill,
    void* h, int e, int cap, int d, int f, void* stream) {
  return launch<true>(static_cast<const float*>(x),
                      static_cast<const float*>(w_gate),
                      static_cast<const float*>(w_up),
                      static_cast<const int64_t*>(fill),
                      static_cast<float*>(h), e, cap, d, f,
                      static_cast<cudaStream_t>(stream));
}

// h (E, C, F), w_down (E, F, D), fill (E,) int64, y (E, C, D), as above.
extern "C" int repro_moe_expert_gemm_down(const void* h, const void* w_down,
                                          const void* fill, void* y, int e,
                                          int cap, int f, int d,
                                          void* stream) {
  const float* w = static_cast<const float*>(w_down);
  return launch<false>(static_cast<const float*>(h), w, w,
                       static_cast<const int64_t*>(fill),
                       static_cast<float*>(y), e, cap, f, d,
                       static_cast<cudaStream_t>(stream));
}
