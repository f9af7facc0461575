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
// (ic, tap, oc), while the first input chunk's loads are in flight.  A block
// takes a 16 x 32 tile of one image and stages it with its one-pixel halo,
// 8 input channels at a time, in shared memory as 32-bit words, zero padding
// written at staging (8-byte vector loads where the channels allow), so the
// inner loop has no bounds checks; the tile and its staging (common.cuh) are
// shared with fused_dot_layer and packed_dot_layer.  Each of the block's 256
// threads owns 2 vertically adjacent pixels of one column: per input
// channel it reads the 4 x 3 window of taps once into registers and applies
// each tap to 8 output channels held in registers.  A warp is 32
// neighbouring columns, so tap reads hit 32 banks and output writes are
// coalesced along W.
#include "common.cuh"

namespace {

using repro::HALO_W;
using repro::ICC;
using repro::PLANE;
using repro::PPT;
constexpr int OCT = repro::OC_TILE;                // output channels in regs

inline size_t smem_words(int ic, int oc) {
  return ((static_cast<size_t>(oc) * ic * 9 + 3) & ~size_t{3}) +
         static_cast<size_t>(ICC) * PLANE;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::TILE_THREADS)
conv1_layer_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   int32_t* __restrict__ out, int h, int wd, int ic, int oc,
                   int coeff_bits, int acc16) {
  extern __shared__ __align__(16) uint32_t c1_smem[];
  uint32_t* wsm = c1_smem;                          // (ic, 9, oc): w'
  uint32_t* xs = c1_smem + ((oc * ic * 9 + 3) & ~3);  // (ICC, HALO_H, HALO_W)

  const repro::TilePos tp = repro::tile_pos(wd);

  // w' = sign(w) * (|w| & mask) modulo 2^32, from w (oc, ic, 3, 3),
  // staged while the first chunk's loads are in flight
  const uint32_t mask = (1u << coeff_bits) - 1u;
  const int per_oc = ic * 9;
  auto stage_weights = [&] {
    repro::stage_words(wsm, oc * per_oc, [&](int i) {
      const int32_t v = static_cast<int32_t>(w[i % oc * per_oc + i / oc]);
      const uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v) & mask;
      return v < 0 ? 0u - mag : mag;
    });
  };
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
        repro::stage(xs, x, tp.img, tp.tr0, tp.tc0, h, wd, ic, c0, cc, [&] {
          if (o0 == 0 && c0 == 0) stage_weights();
        });
        __syncthreads();
      }
      for (int cl = 0; cl < cc; ++cl) {
        uint32_t win[PPT + 2][3];
        const uint32_t* xc = xs + cl * PLANE + tp.r0 * HALO_W + tp.col;
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
    repro::write_pixels<int32_t, OCT>(out, total, tp, h, wd, oc, o0, 0, 0);
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int n, int h, int wd,
            int ic, int oc, int coeff_bits, int acc16, cudaStream_t stream) {
  const size_t bytes = sizeof(uint32_t) * smem_words(ic, oc);
  // a refusal is the launch's error
  if (repro::allow_smem(conv1_layer_kernel<TX, TW>, bytes) != cudaSuccess)
    return;
  conv1_layer_kernel<TX, TW>
      <<<repro::tile_grid(n, h, wd), repro::TILE_THREADS, bytes, stream>>>(
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
