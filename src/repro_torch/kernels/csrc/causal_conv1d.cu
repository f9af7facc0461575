// causal_conv1d: the depthwise causal conv1d of the Mamba-2 mixer.
//
// Replaces repro/kernels/conv1d.py::_kernel / causal_conv1d_pallas: x
// (B, S, C) and w (K, C), both bf16 or both float32, a left halo of K-1
// positions, and K float32 multiply-adds per output, written as float32
// (B, S, C) before the SiLU.  The Pallas kernel pads the halo with zeros;
// here the halo is read from a state (B, K-1, C), the trailing inputs of the
// previous call, or is zero where there is none (a prefill), so one kernel
// serves prefill (any S) and decode (S = 1 with the cache's state):
//
//   y[b, s, c] = sum_j (state ‖ x)[b, s + j, c] * w[j, c].
//
// Products and sums are rounded one at a time (__fmul_rn, __fadd_rn, no
// fused multiply-add), in the order j = 0 .. K-1 from 0, as the plain
// version and the Pallas body add them, so the kernel equals its plain
// version bit for bit.
//
// Bound on the H100: memory bytes (each input element read once, 4 bytes
// written, against 2K operations).  Design: one thread per channel walks a
// tile of SEQ_TILE positions with its K taps and the K-1 previous inputs in
// registers, so each input is read once per tile (plus the K-1 halo);
// neighbouring threads own neighbouring channels, so every load and store of
// a warp is one contiguous run.  A simple kernel: faster forms are later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int CONV_THREADS = 128;
constexpr int SEQ_TILE = 64;
constexpr int MAX_K = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(CONV_THREADS)
causal_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ state, float* __restrict__ y,
                     int s, int c) {
  const int ch = blockIdx.x * CONV_THREADS + threadIdx.x;
  if (ch >= c) return;
  const int s0 = blockIdx.y * SEQ_TILE;
  const int64_t b = blockIdx.z;
  const T* xb = x + b * s * c;
  float wk[K];
#pragma unroll
  for (int j = 0; j < K; ++j) wk[j] = to_f32(w[static_cast<int64_t>(j) * c + ch]);
  // win[j] = (state ‖ x)[b, t + j, ch] for the current position t
  float win[K];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int i = s0 + j;              // index into state ‖ x
    float v = 0.f;
    if (i >= K - 1) {
      v = to_f32(xb[static_cast<int64_t>(i - (K - 1)) * c + ch]);
    } else if (state != nullptr) {
      v = to_f32(state[(b * (K - 1) + i) * c + ch]);
    }
    win[j] = v;
  }
  const int s1 = min(s0 + SEQ_TILE, s);
  for (int t = s0; t < s1; ++t) {
    win[K - 1] = to_f32(xb[static_cast<int64_t>(t) * c + ch]);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(win[j], wk[j]));
    y[(b * s + t) * c + ch] = acc;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
  }
}

template <typename T, int K>
void launch(const void* x, const void* w, const void* state, void* y, int b,
            int s, int c, cudaStream_t stream) {
  const dim3 grid((c + CONV_THREADS - 1) / CONV_THREADS,
                  (s + SEQ_TILE - 1) / SEQ_TILE, b);
  causal_conv1d_kernel<T, K><<<grid, CONV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(state), static_cast<float*>(y), s, c);
}

template <typename T>
int launch_k(int k, const void* x, const void* w, const void* state, void* y,
             int b, int s, int c, cudaStream_t stream) {
  switch (k) {
    case 1: launch<T, 1>(x, w, state, y, b, s, c, stream); break;
    case 2: launch<T, 2>(x, w, state, y, b, s, c, stream); break;
    case 3: launch<T, 3>(x, w, state, y, b, s, c, stream); break;
    case 4: launch<T, 4>(x, w, state, y, b, s, c, stream); break;
    case 5: launch<T, 5>(x, w, state, y, b, s, c, stream); break;
    case 6: launch<T, 6>(x, w, state, y, b, s, c, stream); break;
    case 7: launch<T, 7>(x, w, state, y, b, s, c, stream); break;
    case 8: launch<T, 8>(x, w, state, y, b, s, c, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

static_assert(MAX_K == 8, "launch_k instantiates K = 1 .. 8");

}  // namespace

// x (B, S, C), w (K, C) and state (B, K-1, C) or null, in bf16 ? bf16 :
// float32; y (B, S, C) float32.  All contiguous.  Returns a cudaError_t
// code (cudaErrorInvalidValue for K outside 1 .. 8).
extern "C" int repro_causal_conv1d(const void* x, const void* w,
                                   const void* state, void* y, int bf16,
                                   int b, int s, int c, int k,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_k<__nv_bfloat16>(k, x, w, state, y, b, s, c, st);
  return launch_k<float>(k, x, w, state, y, b, s, c, st);
}
