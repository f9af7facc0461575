// fused_dot_layer: one integer dot for a whole CNN layer, as an implicit
// GEMM.
//
// Replaces repro/blocks/base.py::fused_dot_layer, the layer-fused dot that
// carries conv2, conv4 and conv3 outside its packing regime on the serving
// path (jnp compiled by XLA on the TPU, not Pallas).  It contracts the
// 'same'-padded 3x3 taps of all IC input channels with the (IC * 9, OC)
// weights into int32, for every image, without writing the im2col matrix
// to device memory: each thread gathers its pixel's taps straight from x.
//
// The reference dots in int8 when both widths are <= 8 bits and in int32
// otherwise; either way the result is the exact sum modulo 2^32, which is
// what the uint32 accumulation here gives.  The wrapper narrows an int16
// operand to int8 first where the reference's int8 dot would.
//
// Bound on the H100: memory bytes at the serving shapes (an 8 -> 8 layer
// does 144 integer operations per output it writes, far below the int8
// tensor-core rate per byte).  This first kernel runs the products on CUDA
// cores, whose integer issue rate limits it before memory does.  Design:
// the layer's weights are staged in shared memory once per block; each
// thread reads each input tap once and multiplies it into OC_TILE output
// channels held in registers; output stores are coalesced along W.
#include "common.cuh"

namespace {

template <typename TX, typename TW>
__global__ void __launch_bounds__(repro::THREADS)
fused_dot_layer_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       int32_t* __restrict__ out, int n, int h, int wd,
                       int ic, int oc) {
  extern __shared__ uint32_t wsm[];  // (oc, ic, 9) modulo 2^32
  const int nw = oc * ic * 9;
  for (int i = threadIdx.x; i < nw; i += blockDim.x)
    wsm[i] = static_cast<uint32_t>(static_cast<int32_t>(w[i]));
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
      uint32_t acc[repro::OC_TILE] = {};
      for (int c = 0; c < ic; ++c) {
        for (int t = 0; t < 9; ++t) {
          const uint32_t tap = repro::tap_at(xi, row, col, t, h, wd, ic, c);
#pragma unroll
          for (int j = 0; j < repro::OC_TILE; ++j)
            if (o0 + j < oc) acc[j] += tap * wsm[((o0 + j) * ic + c) * 9 + t];
        }
      }
#pragma unroll
      for (int j = 0; j < repro::OC_TILE; ++j)
        if (o0 + j < oc) oi[(o0 + j) * hw] = static_cast<int32_t>(acc[j]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, int n, int h, int wd,
            int ic, int oc, cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(n) * h * wd;
  const size_t smem = sizeof(uint32_t) * oc * ic * 9;
  fused_dot_layer_kernel<TX, TW>
      <<<repro::grid_for(pixels), repro::THREADS, smem, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<int32_t*>(out), n, h, wd, ic, oc);
}

}  // namespace

extern "C" int repro_fused_dot_layer(const void* x, const void* w, void* out,
                                     int x_int16, int w_int16, int n, int h,
                                     int wd, int ic, int oc, void* stream) {
  REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, launch, x, w, out, n, h, wd,
                            ic, oc, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
