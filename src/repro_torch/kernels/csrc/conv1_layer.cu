// conv1_layer: the multiply-free Conv1 block over a whole CNN layer.
//
// Replaces repro/kernels/conv2d.py::conv1_kernel as ConvBlock.batched_layer
// drives it (repro/blocks/base.py): one pallas_call per (image, oc, ic)
// plane over row tiles, vmapped, then a sum over ic.  Here one launch does
// the whole layer: every plane, the sum over ic and every image.
//
// Arithmetic.  The TPU kernel adds, per tap, tap << b for every bit b <
// coeff_bits set in |w|, then applies w's sign, in the accumulator width.
// Modulo 2^32 that sum is exactly tap * w', with w' = sign(w) * (|w| &
// (2^coeff_bits - 1)), so a plane is sum_t tap_t * w'_t mod 2^32: one
// integer multiply-add per (tap, oc).  Where the TPU accumulates a plane in
// int16 (acc16: d + c + 5 <= 16), wrapping modulo 2^16 commutes with the sum,
// so the plane's low 16 bits are sign-extended before the int32 sum over ic;
// the result wraps exactly where the reference's does.
//
// Bound on the H100: memory bytes at the serving shapes; the function is a
// plain 3x3 convolution, 2 * 9 * ic operations per output.  The first
// kernel was bound by its instructions instead: a runtime loop of coeff_bits
// shift-adds with a branch per bit for every (pixel, oc, ic, tap), and every
// tap re-read from global memory behind four bounds checks once per (oc
// tile, ic, tap).  Design: w' is computed once per block into shared memory
// (ic, tap, oc).  A block takes a 16 x 32 tile of one image and stages it
// with its one-pixel halo, 8 input channels at a time, in shared memory as
// 32-bit words, zero padding written at staging (8-byte vector loads where
// the channels allow), so the inner loop has no bounds checks.  Each thread
// owns 4 vertically adjacent pixels of one column: per input channel it
// reads the 6 x 3 window of taps once into registers and applies each tap
// to 8 output channels held in registers.  A warp is 32 neighbouring
// columns, so tap reads hit 32 banks and output writes are coalesced along W.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int TILE_W = 32;                         // one warp across
constexpr int PPT = 4;                             // pixels (rows) per thread
constexpr int TILE_H = repro::THREADS / TILE_W * PPT;  // 16
constexpr int HALO_H = TILE_H + 2, HALO_W = TILE_W + 2;
constexpr int PLANE = HALO_H * HALO_W;             // words per staged channel
constexpr int ICC = 8;                             // channels staged at once
constexpr int OCT = repro::OC_TILE;                // output channels in regs

inline size_t smem_words(int ic, int oc) {
  return ((static_cast<size_t>(oc) * ic * 9 + 3) & ~size_t{3}) +
         static_cast<size_t>(ICC) * PLANE;
}

// Channels [c0, c0 + cc) of the halo tile at (tr0 - 1, tc0 - 1) of image
// img into xs (cc, HALO_H, HALO_W), zeros outside the image.
template <typename TX>
__device__ __forceinline__ void stage(uint32_t* xs, const TX* __restrict__ x,
                                     int64_t img, int tr0, int tc0, int h,
                                     int wd, int ic, int c0, int cc) {
  constexpr int U = 8 / sizeof(TX);   // channels per 8-byte load
  const bool vec = ic % U == 0 && c0 % U == 0 && cc % U == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 7) == 0;
  if (vec) {
    const int units = cc / U;
    for (int i = threadIdx.x; i < PLANE * units; i += repro::THREADS) {
      const int pos = i / units, u = i % units;
      const int r = tr0 + pos / HALO_W - 1, q = tc0 + pos % HALO_W - 1;
      uint2 raw = make_uint2(0u, 0u);
      if (r >= 0 && r < h && q >= 0 && q < wd)
        raw = *reinterpret_cast<const uint2*>(
            x + ((img * h + r) * wd + q) * ic + c0 + u * U);
      TX vals[U];
      memcpy(vals, &raw, sizeof(raw));
#pragma unroll
      for (int e = 0; e < U; ++e)
        xs[(u * U + e) * PLANE + pos] =
            static_cast<uint32_t>(static_cast<int32_t>(vals[e]));
    }
  } else {
    for (int i = threadIdx.x; i < PLANE * cc; i += repro::THREADS) {
      const int pos = i / cc, cl = i % cc;
      const int r = tr0 + pos / HALO_W - 1, q = tc0 + pos % HALO_W - 1;
      uint32_t val = 0u;
      if (r >= 0 && r < h && q >= 0 && q < wd)
        val = static_cast<uint32_t>(static_cast<int32_t>(
            x[((img * h + r) * wd + q) * ic + c0 + cl]));
      xs[cl * PLANE + pos] = val;
    }
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
conv1_layer_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   int32_t* __restrict__ out, int h, int wd, int ic, int oc,
                   int coeff_bits, int acc16) {
  extern __shared__ __align__(16) uint32_t c1_smem[];
  uint32_t* wsm = c1_smem;                          // (ic, 9, oc): w'
  uint32_t* xs = c1_smem + ((oc * ic * 9 + 3) & ~3);  // (ICC, HALO_H, HALO_W)

  const int tiles_w = (wd + TILE_W - 1) / TILE_W;
  const int tiles_h = (h + TILE_H - 1) / TILE_H;
  const int64_t img = blockIdx.x / (tiles_w * tiles_h);
  const int tile = blockIdx.x % (tiles_w * tiles_h);
  const int tr0 = tile / tiles_w * TILE_H, tc0 = tile % tiles_w * TILE_W;
  const int col = threadIdx.x % TILE_W;
  const int r0 = threadIdx.x / TILE_W * PPT;        // first row in the tile

  // w' = sign(w) * (|w| & mask) modulo 2^32, from w (oc, ic, 3, 3)
  const uint32_t mask = (1u << coeff_bits) - 1u;
  const int per_oc = ic * 9;
  for (int i = threadIdx.x; i < oc * per_oc; i += repro::THREADS) {
    const int32_t v = static_cast<int32_t>(w[i]);
    const uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v) & mask;
    wsm[(i % per_oc) * oc + i / per_oc] = v < 0 ? 0u - mag : mag;
  }
  // an int16 plane keeps its low 16 bits, sign-extended
  const int sh = acc16 ? 16 : 0;

  for (int o0 = 0; o0 < oc; o0 += OCT) {
    uint32_t total[PPT][OCT];
#pragma unroll
    for (int p = 0; p < PPT; ++p)
#pragma unroll
      for (int j = 0; j < OCT; ++j) total[p][j] = 0u;
    for (int c0 = 0; c0 < ic; c0 += ICC) {
      const int cc = min(ICC, ic - c0);
      if (o0 == 0 || ic > ICC) {        // one chunk stays staged across oc
        __syncthreads();
        stage(xs, x, img, tr0, tc0, h, wd, ic, c0, cc);
        __syncthreads();
      }
      for (int cl = 0; cl < cc; ++cl) {
        uint32_t win[PPT + 2][3];
        const uint32_t* xc = xs + cl * PLANE + r0 * HALO_W + col;
#pragma unroll
        for (int r = 0; r < PPT + 2; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) win[r][q] = xc[r * HALO_W + q];
        const uint32_t* wc = wsm + (c0 + cl) * 9 * oc + o0;
        uint32_t plane[PPT][OCT];
#pragma unroll
        for (int p = 0; p < PPT; ++p)
#pragma unroll
          for (int j = 0; j < OCT; ++j) plane[p][j] = 0u;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          uint32_t wt[OCT];
#pragma unroll
          for (int j = 0; j < OCT; ++j)
            wt[j] = o0 + j < oc ? wc[t * oc + j] : 0u;
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            const uint32_t tap = win[p + t / 3][t % 3];
#pragma unroll
            for (int j = 0; j < OCT; ++j) plane[p][j] += tap * wt[j];
          }
        }
#pragma unroll
        for (int p = 0; p < PPT; ++p)
#pragma unroll
          for (int j = 0; j < OCT; ++j)
            total[p][j] += static_cast<uint32_t>(
                static_cast<int32_t>(plane[p][j] << sh) >> sh);
      }
    }
    const int q = tc0 + col;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int r = tr0 + r0 + p;
      if (r >= h || q >= wd) continue;
      int32_t* o = out + (img * oc + o0) * h * wd +
                   static_cast<int64_t>(r) * wd + q;
#pragma unroll
      for (int j = 0; j < OCT; ++j)
        if (o0 + j < oc)
          o[static_cast<int64_t>(j) * h * wd] =
              static_cast<int32_t>(total[p][j]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int n, int h, int wd,
            int ic, int oc, int coeff_bits, int acc16, cudaStream_t stream) {
  const size_t bytes = sizeof(uint32_t) * smem_words(ic, oc);
  // above 48 KB only after opting in; a refusal is the launch's error
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(conv1_layer_kernel<TX, TW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return;
  const int64_t blocks = static_cast<int64_t>(n) *
                         ((h + TILE_H - 1) / TILE_H) *
                         ((wd + TILE_W - 1) / TILE_W);
  conv1_layer_kernel<TX, TW>
      <<<static_cast<unsigned>(blocks), repro::THREADS, bytes, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), h, wd, ic, oc, coeff_bits, acc16);
}

}  // namespace

extern "C" int repro_conv1_layer(const void* x, const void* w, void* out,
                                 int x_int16, int w_int16, int n, int h,
                                 int wd, int ic, int oc, int coeff_bits,
                                 int acc16, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, n, h, wd,
                            ic, oc, coeff_bits, acc16,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
