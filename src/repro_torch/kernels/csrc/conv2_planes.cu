// conv2_planes: the Conv2 block on P planes, each with its own 3x3 weights.
//
// Replaces repro/kernels/conv2d.py::conv2_kernel as the reference runs it:
// a pallas_call over row tiles of one plane, vmapped over the (oc, ic)
// planes of a layer (repro/blocks/base.py::_apply_batched) or called on one
// plane (ConvBlock.apply).  Each grid step forms the (th*w, 9) im2col of its
// tile and dots it with the 9 taps in _dot_dtype (int8 when d, c <= 8, else
// int32) into int32.  Here one launch covers every pixel of every plane.
//
// The reference's int32 dot wraps modulo 2^32 at wide widths; the taps and
// weights are sign-extended and the sum is taken in uint32_t, which gives
// the same bits.  The wrapper narrows both operands to int8 where the
// reference's int8 dot would.
//
// Bound on the H100: memory bytes (one container read and one int32 write
// per pixel against 18 integer operations).  Design: one thread per output
// pixel in a grid-stride loop; the plane's 9 weights are read into
// registers (the threads of a block share a plane, so the loads hit the
// same lines); neighbouring threads read neighbouring taps and write
// neighbouring outputs.  A simple kernel: faster forms are later work.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
conv2_planes_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    int32_t* __restrict__ out, int p, int h, int wd) {
  const int64_t hw = static_cast<int64_t>(h) * wd;
  const int64_t pixels = hw * p;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < pixels; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t plane = i / hw;
    const int row = static_cast<int>((i % hw) / wd);
    const int col = static_cast<int>(i % wd);
    const TX* xp = x + plane * hw;
    const TW* wp = w + plane * 9;
    uint32_t wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = repro::word(wp[t]);
    uint32_t acc = 0u;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      acc += repro::plane_tap(xp, row, col, t, h, wd) * wk[t];
    out[i] = static_cast<int32_t>(acc);
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int p, int h, int wd,
            cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(p) * h * wd;
  conv2_planes_kernel<TX, TW>
      <<<repro::grid_for(pixels), repro::THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), p, h, wd);
}

}  // namespace

extern "C" int repro_conv2_planes(const void* x, const void* w, void* out,
                                  int x_int16, int w_int16, int p, int h,
                                  int wd, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, p, h, wd,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
