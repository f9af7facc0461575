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
// reference degrades to two dots in _dot_dtype: shift = 0 here.
//
// The operand is formed in uint32_t (a left shift of a negative signed value
// is undefined before C++20) and every sum is taken in uint32_t, which gives
// the reference's int32 bits; the right shift of a negative int32 is
// arithmetic under nvcc.
//
// Bound on the H100: memory bytes (one container read and two int32 writes
// per pixel against 18 or 36 integer operations).  Design: one thread per
// output pixel in a grid-stride loop; the plane's packed operands (or its
// 18 weights) in registers; the branch on shift is the same for every
// thread, so warps never diverge on it.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
conv3_planes_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    int32_t* __restrict__ out, int p, int h, int wd,
                    int shift) {
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
    int32_t* op = out + plane * 2 * hw + pix;
    if (shift) {
      uint32_t packed[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        packed[t] = (repro::word(wp[t]) << shift) + repro::word(wp[9 + t]);
      uint32_t acc = 0u;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        acc += repro::plane_tap(xp, row, col, t, h, wd) * packed[t];
      const uint32_t half = 1u << (shift - 1);
      const uint32_t field = (1u << shift) - 1u;
      // (acc + half) & field < 2^31, so the subtraction cannot overflow
      const int32_t lo = static_cast<int32_t>((acc + half) & field) -
                         static_cast<int32_t>(half);
      const int32_t hi =
          static_cast<int32_t>(acc - static_cast<uint32_t>(lo)) >> shift;
      op[0] = hi;
      op[hw] = lo;
    } else {
      uint32_t acc0 = 0u, acc1 = 0u;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const uint32_t tap = repro::plane_tap(xp, row, col, t, h, wd);
        acc0 += tap * repro::word(wp[t]);
        acc1 += tap * repro::word(wp[9 + t]);
      }
      op[0] = static_cast<int32_t>(acc0);
      op[hw] = static_cast<int32_t>(acc1);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int p, int h, int wd,
            int shift, cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(p) * h * wd;
  conv3_planes_kernel<TX, TW>
      <<<repro::grid_for(pixels), repro::THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), p, h, wd, shift);
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
