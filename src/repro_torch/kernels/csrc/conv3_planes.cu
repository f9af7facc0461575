// conv3_planes: the Conv3 block on P planes, the operand-packed dual
// convolution.
//
// Replaces repro/kernels/conv2d.py::conv3_kernel as the reference runs it:
// a pallas_call over row tiles of one plane, vmapped over the (channel pair,
// ic) planes of a layer (repro/blocks/base.py::_apply_batched) or called on
// one plane (ConvBlock.apply).  Inside the packing regime (d + c <= 12) the
// two 9-tap weight vectors share one int32 operand
//     packed[t] = (w_hi[t] << S) + w_lo[t],   S = d + c + 3,
// one dot per pixel yields both convolutions, and the signed field split
//     lo = ((acc + half) & (2^S - 1)) - half,   hi = (acc - lo) >> S
// recovers them, into (2, H, W) = (hi, lo).  Outside the regime the
// reference degrades to two dots in _dot_dtype (shift = 0 here), which run
// Conv4's code (common.cuh: dot_planes).
//
// The operand is formed in uint32_t (a left shift of a negative signed value
// is undefined before C++20) and every sum is taken in uint32_t, which gives
// the reference's int32 bits; the right shift of a negative int32 is
// arithmetic under nvcc.  The packed operand is an int32, which neither
// __dp4a nor the tensor cores take: its dot runs as 32-bit multiply-adds on
// the CUDA cores, as the two dots do.
//
// Bound on the H100: memory bytes (one container read and two int32 writes
// per pixel against 18 or 36 integer operations), and below that, at the
// per-plane path's small launches (8 blocks at P = 1), by each block's chain
// of latencies.  The first version of this kernel ran one thread per pixel
// in a grid-stride loop: two 64-bit divisions per pixel, the 9 packed
// operands re-formed per pixel from weights reloaded from global memory, and
// 9 taps read behind four bounds checks each.  Design: the staged tile of
// common.cuh, as conv4_planes: one block per 16 x 32 tile of one plane; the
// halo tile staged with zeros outside the plane; the 9 packed operands
// formed once per block while the tile's loads are in flight; 2 pixels of
// one column per thread, the split in registers, each output plane's stores
// coalesced along W.  A block stages one tile, so there is nothing for
// cp.async or TMA to overlap.
#include "common.cuh"

namespace {

using repro::PPT;

template <typename TX, typename TW, bool PACKED>
__global__ void __launch_bounds__(repro::TILE_THREADS)
conv3_planes_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    int32_t* __restrict__ out, int h, int wd, int shift) {
  __shared__ __align__(16) uint32_t xs[repro::PLANE];
  __shared__ __align__(16) uint32_t ws[repro::PLANE_WORDS];
  const repro::TilePos tp = repro::tile_pos(wd);
  const TW* wp = w + tp.img * 18;
  if constexpr (!PACKED) {
    repro::dot_planes<2>(xs, ws, x, wp, out, tp, h, wd);
  } else {
    repro::stage_plane(xs, ws, x, tp, h, wd, [&](int i) {
      return i < 9 ? (repro::word(wp[i]) << shift) + repro::word(wp[9 + i])
                   : 0u;
    });
    uint32_t win[PPT + 2][3], packed[12];
    repro::load_window(win, xs, tp);
    repro::load_words(packed, ws);
    const uint32_t half = 1u << (shift - 1);
    const uint32_t field = (1u << shift) - 1u;
    uint32_t res[PPT][2];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      uint32_t acc = 0u;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc += win[p + t / 3][t % 3] * packed[t];
      // (acc + half) & field < 2^31, so the subtraction cannot overflow
      const int32_t lo = static_cast<int32_t>((acc + half) & field) -
                         static_cast<int32_t>(half);
      const int32_t hi =
          static_cast<int32_t>(acc - static_cast<uint32_t>(lo)) >> shift;
      res[p][0] = static_cast<uint32_t>(hi);
      res[p][1] = static_cast<uint32_t>(lo);
    }
    repro::write_pixels<int32_t, 2>(out, res, tp, h, wd, 2, 0, 0, 0);
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int p, int h, int wd,
            int shift, cudaStream_t stream) {
  const dim3 grid = repro::tile_grid(p, h, wd);
  if (shift)
    conv3_planes_kernel<TX, TW, true>
        <<<grid, repro::TILE_THREADS, 0, stream>>>(
            static_cast<const TX*>(x), static_cast<const TW*>(w),
            static_cast<int32_t*>(out), h, wd, shift);
  else
    conv3_planes_kernel<TX, TW, false>
        <<<grid, repro::TILE_THREADS, 0, stream>>>(
            static_cast<const TX*>(x), static_cast<const TW*>(w),
            static_cast<int32_t*>(out), h, wd, 0);
}

}  // namespace

// shift = S = d + c + 3 in the packing regime (at most 15), 0 outside it.
extern "C" int repro_conv3_planes(const void* x, const void* w, void* out,
                                  int x_int16, int w_int16, int p, int h,
                                  int wd, int shift, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, p, h, wd,
                            shift, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
