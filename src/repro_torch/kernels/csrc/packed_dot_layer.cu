// packed_dot_layer: Conv3's operand-packed dual convolution over a whole
// CNN layer.
//
// Replaces repro/blocks/base.py::packed_dot_layer (the layer-fused form of
// repro/kernels/conv2d.py::conv3_kernel's packed regime; jnp compiled by
// XLA on the TPU).  Output channels go in pairs (an odd tail is paired with
// a copy of itself and the twin discarded); each pair shares one int32
// operand (w_hi << S) + w_lo with S = d + c + 3, so one 9-tap dot per
// (image, pixel, pair, input channel) yields both convolutions.  The
// signed field split
//     lo = ((acc + half) & (2^S - 1)) - half,   hi = (acc - lo) >> S
// happens per input plane, before the sum over input channels.  Inside the
// packing regime (d + c <= 12) the split is exact, so the layer's output
// equals a plain 3x3 convolution's: the kernel does the reference's packed
// arithmetic (one int32 dot per pair, then the per-plane split), and a
// library convolution of the same layer is its yardstick.
//
// Bound on the H100: memory bytes at the serving shapes (the dot work is
// half a plain convolution's).  The packing is an int32 multiply on CUDA
// cores; their integer issue rate limits this first kernel before memory
// does.  Design: the packed operands are formed once per block in shared
// memory; each thread reads each input tap once and applies it to OC_TILE
// channel pairs held in registers; the split runs in registers per plane.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
packed_dot_layer_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        int32_t* __restrict__ out, int n, int h, int wd,
                        int ic, int oc, int shift) {
  extern __shared__ uint32_t psm[];  // (pairs, ic, 9) packed operands
  const int pairs = (oc + 1) / 2;
  const int npk = pairs * ic * 9;
  for (int i = threadIdx.x; i < npk; i += blockDim.x) {
    const int pr = i / (ic * 9);
    const int rest = i % (ic * 9);
    const int lo_ch = min(2 * pr + 1, oc - 1);  // odd tail: its own twin
    const uint32_t hi = static_cast<uint32_t>(
        static_cast<int32_t>(w[2 * pr * ic * 9 + rest]));
    const uint32_t lo = static_cast<uint32_t>(
        static_cast<int32_t>(w[lo_ch * ic * 9 + rest]));
    psm[i] = (hi << shift) + lo;
  }
  __syncthreads();

  const uint32_t half = 1u << (shift - 1);
  const uint32_t field = (1u << shift) - 1u;
  const int64_t hw = static_cast<int64_t>(h) * wd;
  const int64_t pixels = hw * n;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pixels; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t img = p / hw;
    const int row = static_cast<int>((p % hw) / wd);
    const int col = static_cast<int>(p % wd);
    const TX* xi = x + img * hw * ic;
    int32_t* oi = out + img * oc * hw + static_cast<int64_t>(row) * wd + col;
    for (int p0 = 0; p0 < pairs; p0 += repro::OC_TILE) {
      uint32_t sum_hi[repro::OC_TILE] = {};
      uint32_t sum_lo[repro::OC_TILE] = {};
      for (int c = 0; c < ic; ++c) {
        uint32_t acc[repro::OC_TILE] = {};
        for (int t = 0; t < 9; ++t) {
          const uint32_t tap = repro::tap_at(xi, row, col, t, h, wd, ic, c);
#pragma unroll
          for (int j = 0; j < repro::OC_TILE; ++j)
            if (p0 + j < pairs) acc[j] += tap * psm[((p0 + j) * ic + c) * 9 + t];
        }
#pragma unroll
        for (int j = 0; j < repro::OC_TILE; ++j) {
          // (acc + half) & field < 2^31, so the subtraction cannot overflow;
          // the right shift of a negative int32 is arithmetic under nvcc
          const int32_t lo =
              static_cast<int32_t>((acc[j] + half) & field) -
              static_cast<int32_t>(half);
          const int32_t hi =
              static_cast<int32_t>(acc[j] - static_cast<uint32_t>(lo)) >> shift;
          sum_hi[j] += static_cast<uint32_t>(hi);
          sum_lo[j] += static_cast<uint32_t>(lo);
        }
      }
#pragma unroll
      for (int j = 0; j < repro::OC_TILE; ++j) {
        const int o = 2 * (p0 + j);
        if (o < oc) oi[o * hw] = static_cast<int32_t>(sum_hi[j]);
        if (o + 1 < oc) oi[(o + 1) * hw] = static_cast<int32_t>(sum_lo[j]);
      }
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int n, int h, int wd,
            int ic, int oc, int shift, cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(n) * h * wd;
  const size_t smem = sizeof(uint32_t) * ((oc + 1) / 2) * ic * 9;
  packed_dot_layer_kernel<TX, TW>
      <<<repro::grid_for(pixels), repro::THREADS, smem, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), n, h, wd, ic, oc, shift);
}

}  // namespace

// shift = S = d + c + 3, at most 31 (the wrapper checks).
extern "C" int repro_packed_dot_layer(const void* x, const void* w, void* out,
                                      int x_int16, int w_int16, int n, int h,
                                      int wd, int ic, int oc, int shift,
                                      void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, n, h, wd,
                            ic, oc, shift, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
