// conv2_planes: the Conv2 block on P planes, each with its own 3x3 weights.
//
// Replaces repro/kernels/conv2d.py::conv2_kernel as the reference runs it:
// a pallas_call over row tiles of one plane, vmapped over the (oc, ic)
// planes of a layer (repro/blocks/base.py::_apply_batched) or called on one
// plane (ConvBlock.apply).  Each grid step forms the (th*w, 9) im2col of its
// tile and dots it with the 9 taps in _dot_dtype (int8 when d, c <= 8, else
// int32) into int32 (H, W).
//
// Sums are taken in uint32_t (the reference's int32 dot wraps modulo 2^32 at
// wide widths); the wrapper narrows both operands to int8 where the
// reference's int8 dot would.
//
// Bound on the H100: memory bytes (one container read and one int32 write
// per pixel against 18 integer operations), and below that, at the
// per-plane path's small launches (8 blocks at P = 1), by each block's chain
// of latencies.  The first version of this kernel ran one thread per pixel
// in a grid-stride loop: two 64-bit divisions per pixel at the head of its
// load chain, the plane's 9 weights reloaded per pixel, and 9 taps read from
// global memory behind four bounds checks each.  Design: conv4_planes' with
// one output, on the staged tile of common.cuh: one block per 16 x 32 tile
// of one plane found with one 32-bit division; the halo tile staged with
// zeros outside the plane, each thread's loads issued together; the plane's
// 9 weights staged once per block while the tile's loads are in flight; 2
// pixels of one column per thread, the window rows they share read once
// into registers, 9 multiply-adds per pixel on the CUDA cores (faster than
// __dp4a on int8 dots at conv4_planes' shapes, with twice the multiplies);
// stores coalesced along W (common.cuh: dot_planes<1>).  A block stages one
// tile, so there is nothing for cp.async or TMA to overlap.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::TILE_THREADS)
conv2_planes_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    int32_t* __restrict__ out, int h, int wd) {
  __shared__ __align__(16) uint32_t xs[repro::PLANE];
  __shared__ __align__(16) uint32_t ws[repro::PLANE_WORDS];
  const repro::TilePos tp = repro::tile_pos(wd);
  repro::dot_planes<1>(xs, ws, x, w + tp.img * 9, out, tp, h, wd);
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int p, int h, int wd,
            cudaStream_t stream) {
  conv2_planes_kernel<TX, TW>
      <<<repro::tile_grid(p, h, wd), repro::TILE_THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), h, wd);
}

}  // namespace

extern "C" int repro_conv2_planes(const void* x, const void* w, void* out,
                                  int x_int16, int w_int16, int p, int h,
                                  int wd, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, p, h, wd,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
