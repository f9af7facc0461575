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
// per pixel against 36 integer operations).  Design: one thread per output
// pixel in a grid-stride loop; the plane's 18 weights in registers; each tap
// is read once and feeds both dots; neighbouring threads write neighbouring
// outputs of each of the two planes.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
conv4_planes_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    int32_t* __restrict__ out, int p, int h, int wd) {
  const int64_t hw = static_cast<int64_t>(h) * wd;
  const int64_t pixels = hw * p;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < pixels; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t plane = i / hw;
    const int64_t pix = i % hw;
    const int row = static_cast<int>(pix / wd);
    const int col = static_cast<int>(pix % wd);
    const TX* xp = x + plane * hw;
    const TW* wp = w + plane * 18;
    uint32_t w0[9], w1[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      w0[t] = repro::word(wp[t]);
      w1[t] = repro::word(wp[9 + t]);
    }
    uint32_t acc0 = 0u, acc1 = 0u;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint32_t tap = repro::plane_tap(xp, row, col, t, h, wd);
      acc0 += tap * w0[t];
      acc1 += tap * w1[t];
    }
    int32_t* op = out + plane * 2 * hw + pix;
    op[0] = static_cast<int32_t>(acc0);
    op[hw] = static_cast<int32_t>(acc1);
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int p, int h, int wd,
            cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(p) * h * wd;
  conv4_planes_kernel<TX, TW>
      <<<repro::grid_for(pixels), repro::THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), p, h, wd);
}

}  // namespace

extern "C" int repro_conv4_planes(const void* x, const void* w, void* out,
                                  int x_int16, int w_int16, int p, int h,
                                  int wd, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, p, h, wd,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
