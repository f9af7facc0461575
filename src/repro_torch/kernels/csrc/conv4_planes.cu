// conv4_planes: the Conv4 block on P planes, two independent 3x3
// convolutions per plane.
//
// Replaces repro/kernels/conv2d.py::conv4_kernel as the reference runs it:
// a pallas_call over row tiles of one plane, vmapped over the (channel pair,
// ic) planes of a layer (repro/blocks/base.py::_apply_batched) or called on
// one plane (ConvBlock.apply).  Each grid step dots the (th*w, 9) im2col of
// its tile with each of the two 9-tap weight vectors in _dot_dtype (the
// paper's two DSPs), into int32 (2, H, W).
//
// Sums are taken in uint32_t (the reference's int32 dots wrap modulo 2^32 at
// wide widths); the wrapper narrows to int8 where the reference's dot does.
//
// Bound on the H100: memory bytes (one container read and two int32 writes
// per pixel against 36 integer operations), and below that, at the per-plane
// path's small launches (8 blocks at P = 1), by each block's chain of
// latencies.  The first version of this kernel ran one thread per pixel in a
// grid-stride loop: two 64-bit divisions per pixel at the head of its load
// chain, the plane's 18 weights reloaded per pixel, and 9 taps read from
// global memory behind four bounds checks each.  Design: the staged tile of
// common.cuh, one block per 16 x 32 tile of one plane found with one 32-bit
// division; the halo tile staged with zeros outside the plane, each thread's
// loads issued together; the plane's weights staged once per block while
// the tile's loads are in flight; 2 pixels of one column per thread, the
// window rows they share read once into registers, 18 multiply-adds per
// pixel on the CUDA cores (faster here than __dp4a on int8 dots); each
// output plane's stores coalesced along W (common.cuh: dot_planes).  A
// block stages one tile, so there is nothing for cp.async or TMA to
// overlap.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::TILE_THREADS)
conv4_planes_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    int32_t* __restrict__ out, int h, int wd) {
  __shared__ __align__(16) uint32_t xs[repro::PLANE];
  __shared__ __align__(16) uint32_t ws[repro::PLANE_WORDS];
  const repro::TilePos tp = repro::tile_pos(wd);
  repro::dot_planes<2>(xs, ws, x, w + tp.img * 18, out, tp, h, wd);
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int p, int h, int wd,
            cudaStream_t stream) {
  conv4_planes_kernel<TX, TW>
      <<<repro::tile_grid(p, h, wd), repro::TILE_THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), h, wd);
}

}  // namespace

extern "C" int repro_conv4_planes(const void* x, const void* w, void* out,
                                  int x_int16, int w_int16, int p, int h,
                                  int wd, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, p, h, wd,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
