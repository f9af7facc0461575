// conv1_layer: the multiply-free Conv1 block over a whole CNN layer.
//
// Replaces repro/kernels/conv2d.py::conv1_kernel as ConvBlock.batched_layer
// drives it (repro/blocks/base.py): one pallas_call per (image, oc, ic)
// plane over row tiles, vmapped, then a sum over ic.  Here one launch does
// the whole layer: every plane, the sum over ic and every image.
//
// Arithmetic, as the TPU kernel does it: per tap, for each of the
// coeff_bits bits b of |w|, add tap << b where the bit is set, then apply
// the sign of w.  The TPU accumulates a plane in int16 when d + c + 5 <= 16
// (acc16) and in int32 otherwise; each plane is reduced to that width
// before the int32 sum over ic, so the result wraps exactly where the
// reference's does.
//
// Bound on the H100: memory bytes at the serving shapes.  Where no plane
// wraps, the function is a plain 3x3 convolution, whose 2 * 9 * ic
// operations per output sit far below the int8 tensor-core rate per byte;
// the shift-adds (two CUDA-core instructions per set coefficient bit per
// tap) are how the reference computes it, and their issue rate limits this
// first kernel long before memory does.  Design: the layer's weights are
// staged in shared memory once per block, pre-split into the masked
// magnitude and a sign flag; each thread reads each input tap once and
// applies it to OC_TILE output channels held in registers; the bit loop
// branches on a weight that every thread of the block shares, so warps
// never diverge on it.
#include "common.cuh"

namespace {

constexpr uint32_t SIGN = 0x80000000u;  // flag stored above the magnitude

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
conv1_layer_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   int32_t* __restrict__ out, int n, int h, int wd, int ic,
                   int oc, int coeff_bits, int acc16) {
  extern __shared__ uint32_t wsm[];  // (oc, ic, 9): |w| & mask, SIGN if w<0
  const int nw = oc * ic * 9;
  const uint32_t mask = (1u << coeff_bits) - 1u;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int32_t v = static_cast<int32_t>(w[i]);
    const uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v) & mask;
    wsm[i] = mag | (v < 0 ? SIGN : 0u);
  }
  __syncthreads();

  const int64_t hw = static_cast<int64_t>(h) * wd;
  const int64_t pixels = hw * n;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pixels; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t img = p / hw;
    const int row = static_cast<int>((p % hw) / wd);
    const int col = static_cast<int>(p % wd);
    const TX* xi = x + img * hw * ic;
    int32_t* oi = out + img * oc * hw + static_cast<int64_t>(row) * wd + col;
    for (int o0 = 0; o0 < oc; o0 += repro::OC_TILE) {
      uint32_t total[repro::OC_TILE] = {};
      for (int c = 0; c < ic; ++c) {
        uint32_t plane[repro::OC_TILE] = {};
        for (int t = 0; t < 9; ++t) {
          const uint32_t tap = repro::tap_at(xi, row, col, t, h, wd, ic, c);
#pragma unroll
          for (int j = 0; j < repro::OC_TILE; ++j) {
            if (o0 + j >= oc) continue;
            const uint32_t m = wsm[((o0 + j) * ic + c) * 9 + t];
            uint32_t part = 0u;
            for (int b = 0; b < coeff_bits; ++b)
              if ((m >> b) & 1u) part += tap << b;
            plane[j] += (m & SIGN) ? 0u - part : part;
          }
        }
#pragma unroll
        for (int j = 0; j < repro::OC_TILE; ++j)
          total[j] += acc16 ? static_cast<uint32_t>(static_cast<int32_t>(
                                  static_cast<int16_t>(plane[j] & 0xFFFFu)))
                            : plane[j];
      }
#pragma unroll
      for (int j = 0; j < repro::OC_TILE; ++j)
        if (o0 + j < oc) oi[(o0 + j) * hw] = static_cast<int32_t>(total[j]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int n, int h, int wd,
            int ic, int oc, int coeff_bits, int acc16, cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(n) * h * wd;
  const size_t smem = sizeof(uint32_t) * oc * ic * 9;
  conv1_layer_kernel<TX, TW>
      <<<repro::grid_for(pixels), repro::THREADS, smem, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), n, h, wd, ic, oc, coeff_bits, acc16);
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
