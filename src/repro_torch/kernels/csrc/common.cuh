// Shared by the layer kernels of the CNN serving path and the per-plane
// kernels of the blocks.
//
// Layouts (the reference's public ones): activations x (N, H, W, IC)
// channels-last in their int8/int16 container; weights w (OC, IC, 3, 3) in
// theirs; the layer accumulator out (N, OC, H, W) int32.  The plane kernels
// take P planes x (P, H, W), each with its own weights w (P, 3, 3) or
// (P, 2, 3, 3), and write out (P, H, W) or (P, 2, H, W) int32.  Convolution
// is 'same' zero-padded cross-correlation: tap t = 3*di + dj reads
// x[row + di - 1, col + dj - 1].
//
// Every sum is taken in uint32_t and reinterpreted at the end: the
// reference's int32 dots wrap modulo 2^32 at wide bit widths (one plane
// reaches 9 * 2^30 at d = c = 16), and signed overflow and left shifts of
// negative values are undefined in C++.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// One thread per output pixel (n, row, col); a block of THREADS pixels
// walks the pixels in a grid-stride loop after staging the whole layer's
// weights in shared memory once.
constexpr int THREADS = 128;
constexpr int MAX_BLOCKS = 4096;
// Output channels (or channel pairs) a thread keeps in registers while it
// reads each input tap once: a register tile of the implicit GEMM.
constexpr int OC_TILE = 8;

inline int grid_for(int64_t pixels) {
  int64_t blocks = (pixels + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

// The tap value at (row + di - 1, col + dj - 1) of channel c, or 0 in the
// zero padding, sign-extended and then taken modulo 2^32.
template <typename TX>
__device__ __forceinline__ uint32_t tap_at(const TX* __restrict__ xi, int row,
                                           int col, int t, int h, int wd,
                                           int ic, int c) {
  const int r = row + t / 3 - 1;
  const int q = col + t % 3 - 1;
  if (r < 0 || r >= h || q < 0 || q >= wd) return 0u;
  return static_cast<uint32_t>(
      static_cast<int32_t>(xi[(static_cast<int64_t>(r) * wd + q) * ic + c]));
}

// The same for one (H, W) plane.
template <typename TX>
__device__ __forceinline__ uint32_t plane_tap(const TX* __restrict__ xp,
                                              int row, int col, int t, int h,
                                              int wd) {
  const int r = row + t / 3 - 1;
  const int q = col + t % 3 - 1;
  if (r < 0 || r >= h || q < 0 || q >= wd) return 0u;
  return static_cast<uint32_t>(
      static_cast<int32_t>(xp[static_cast<int64_t>(r) * wd + q]));
}

// A weight taken modulo 2^32 after sign extension.
template <typename TW>
__device__ __forceinline__ uint32_t word(TW v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

}  // namespace repro

// Message for a code returned by one of the repro_* entries.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Instantiate LAUNCH<TX, TW>(...) for the containers the caller names.
#define REPRO_DISPATCH_CONTAINERS(x_int16, w_int16, LAUNCH, ...)   \
  do {                                                             \
    if (x_int16 && w_int16) LAUNCH<int16_t, int16_t>(__VA_ARGS__); \
    else if (x_int16) LAUNCH<int16_t, int8_t>(__VA_ARGS__);        \
    else if (w_int16) LAUNCH<int8_t, int16_t>(__VA_ARGS__);        \
    else LAUNCH<int8_t, int8_t>(__VA_ARGS__);                      \
  } while (0)
