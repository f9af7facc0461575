// Shared by the layer kernels of the CNN serving path and the per-plane
// kernels of the blocks.
//
// Layouts (the reference's public ones): activations x (N, H, W, IC)
// channels-last in their int8/int16 container; weights w (OC, IC, 3, 3) in
// theirs; the layer accumulator out (N, OC, H, W) int32, or, from a layer
// kernel's requantizing entry, the next layer's activations (N, H, W, OC)
// in their int8/int16 container.  The plane kernels take P planes x (P, H,
// W), each with its own weights w (P, 3, 3) or (P, 2, 3, 3), and write out
// (P, H, W) or (P, 2, H, W) int32.  Convolution is 'same' zero-padded
// cross-correlation: tap t = 3*di + dj reads x[row + di - 1, col + dj - 1].
//
// Every sum is taken in uint32_t and reinterpreted at the end: the
// reference's int32 dots wrap modulo 2^32 at wide bit widths (one plane
// reaches 9 * 2^30 at d = c = 16), and signed overflow and left shifts of
// negative values are undefined in C++.
#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace repro {

// Output channels (or channel pairs) a thread keeps in registers while it
// reads each input tap once: a register tile of the implicit GEMM.
constexpr int OC_TILE = 8;

// A weight taken modulo 2^32 after sign extension.
template <typename TW>
__device__ __forceinline__ uint32_t word(TW v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

// ---------------------------------------------------------------------------
// The staged tile of the layer kernels (conv1_layer, fused_dot_layer,
// packed_dot_layer) and of the plane kernels conv2_planes, conv3_planes and
// conv4_planes (a plane is an image of one channel).  A block of
// TILE_THREADS threads takes a TILE_H x TILE_W tile of one image and stages
// it with its one-pixel halo in shared memory, zeros written outside the
// image, so the inner loops carry no bounds checks.  Thread i owns the PPT
// vertically adjacent pixels of column i % TILE_W from row (i / TILE_W) *
// PPT of the tile: a warp is 32 neighbouring columns, so its reads of a
// staged plane hit 32 banks and its stores are coalesced along W.  At the
// serving shapes (32 x 128 images) a tile is a block and bucket 16 is 128
// blocks of 8 warps: one wave over the 132 SMs, each thread's chain of
// loads short.
// ---------------------------------------------------------------------------
constexpr int TILE_THREADS = 256;
constexpr int TILE_W = 32;                         // one warp across
constexpr int PPT = 2;                             // pixels (rows) per thread
constexpr int TILE_H = TILE_THREADS / TILE_W * PPT;  // 16
constexpr int HALO_H = TILE_H + 2, HALO_W = TILE_W + 2;
constexpr int PLANE = HALO_H * HALO_W;             // words per staged plane
constexpr int ICC = 8;                             // planes staged at once

// Where a block's tile lies and where this thread's pixels lie in it.
struct TilePos {
  int64_t img;
  int tr0, tc0;   // the tile's first row and column in the image
  int r0, col;    // this thread's first row and its column in the tile
};

// The grid is (images x tiles across, tiles down): one division finds a
// block's tile, and a batch of any size fits the grid's x.
__device__ __forceinline__ TilePos tile_pos(int wd) {
  const int tiles_w = (wd + TILE_W - 1) / TILE_W;
  TilePos tp;
  tp.img = blockIdx.x / tiles_w;
  tp.tc0 = (blockIdx.x - tp.img * tiles_w) * TILE_W;
  tp.tr0 = blockIdx.y * TILE_H;
  tp.col = threadIdx.x % TILE_W;
  tp.r0 = threadIdx.x / TILE_W * PPT;
  return tp;
}

// The grid of a launch over n images of h x wd: one block per tile.
inline dim3 tile_grid(int n, int h, int wd) {
  return dim3(static_cast<unsigned>(n) * ((wd + TILE_W - 1) / TILE_W),
              (h + TILE_H - 1) / TILE_H);
}

// Staging loops issue BATCH loads per thread before they write any of them
// to shared memory, so that a tile's loads wait out one memory latency
// together instead of one after another: BATCH * TILE_THREADS covers a
// plane.
constexpr int BATCH = (PLANE + TILE_THREADS - 1) / TILE_THREADS;   // 3

// Stage `count` items of the halo tile at (tr0 - 1, tc0 - 1) of an h x wd
// image, `per` items per position: load(k, pixel) reads item k of a pixel
// (its index in the image), put(pos, k, v) writes it (zero outside the
// image) to shared memory.  `between` runs once, after the first batch of
// loads is issued and before any is waited for: the kernels stage their
// weights there, so the two latencies overlap.
template <typename V, typename Load, typename Put, typename Between>
__device__ __forceinline__ void stage_items(int count, int per, int tr0,
                                            int tc0, int h, int wd, V zero,
                                            Load load, Put put,
                                            Between between) {
  for (int i0 = 0; i0 < count; i0 += BATCH * TILE_THREADS) {
    V v[BATCH];
    int pos[BATCH], k[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * TILE_THREADS + threadIdx.x;
      pos[b] = per == 1 ? i : i / per;
      k[b] = i - pos[b] * per;
      const int r = tr0 + pos[b] / HALO_W - 1, q = tc0 + pos[b] % HALO_W - 1;
      v[b] = zero;
      if (i < count && r >= 0 && r < h && q >= 0 && q < wd)
        v[b] = load(k[b], r * wd + q);
    }
    if (i0 == 0) between();
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      if (i0 + b * TILE_THREADS + threadIdx.x < count)
        put(pos[b], k[b], v[b]);
  }
}

// dst[i] = value(i) for i < count, BATCH values per thread computed (and
// their loads issued) before any is written: a block's weights, staged.
template <typename F>
__device__ __forceinline__ void stage_words(uint32_t* dst, int count,
                                            F value) {
  for (int i0 = 0; i0 < count; i0 += BATCH * TILE_THREADS) {
    uint32_t v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * TILE_THREADS + threadIdx.x;
      v[b] = i < count ? value(i) : 0u;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * TILE_THREADS + threadIdx.x;
      if (i < count) dst[i] = v[b];
    }
  }
}

// Channels [c0, c0 + cc) of the halo tile at (tr0 - 1, tc0 - 1) of image
// img into xs (cc, HALO_H, HALO_W), one sign-extended word per channel,
// zeros outside the image; `between` as in stage_items.
template <typename TX, typename Between>
__device__ __forceinline__ void stage(uint32_t* xs, const TX* __restrict__ x,
                                     int64_t img, int tr0, int tc0, int h,
                                     int wd, int ic, int c0, int cc,
                                     Between between) {
  constexpr int U = 8 / sizeof(TX);   // channels per 8-byte load
  const bool vec = ic % U == 0 && c0 % U == 0 && cc % U == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 7) == 0;
  x += img * h * wd * ic + c0;
  if (vec) {
    const int units = cc / U;
    stage_items(
        PLANE * units, units, tr0, tc0, h, wd, make_uint2(0u, 0u),
        [&](int u, int pixel) {
          return *reinterpret_cast<const uint2*>(
              x + static_cast<int64_t>(pixel) * ic + u * U);
        },
        [&](int pos, int u, uint2 raw) {
          TX vals[U];
          memcpy(vals, &raw, sizeof(raw));
#pragma unroll
          for (int e = 0; e < U; ++e)
            xs[(u * U + e) * PLANE + pos] =
                static_cast<uint32_t>(static_cast<int32_t>(vals[e]));
        },
        between);
  } else {
    stage_items(
        PLANE * cc, cc, tr0, tc0, h, wd, 0u,
        [&](int cl, int pixel) {
          return static_cast<uint32_t>(static_cast<int32_t>(
              x[static_cast<int64_t>(pixel) * ic + cl]));
        },
        [&](int pos, int cl, uint32_t v) { xs[cl * PLANE + pos] = v; },
        between);
  }
}

// Channels [c0, c0 + cc) of the same halo tile into xs as packed words:
// word k of a position holds channels c0 + E*k ... c0 + E*k + E - 1 as they
// lie in memory (E = 4 / sizeof(TX): four int8 or two int16 containers),
// channel c0 + E*k + e in lane e; lanes past cc and everything outside the
// image are 0.  xs is (ceil(cc / E), HALO_H, HALO_W).  8-byte loads where
// the channels allow, else one container at a time; `between` as in
// stage_items.
template <typename TX, typename Between>
__device__ __forceinline__ void stage_packed(uint32_t* xs,
                                            const TX* __restrict__ x,
                                            int64_t img, int tr0, int tc0,
                                            int h, int wd, int ic, int c0,
                                            int cc, Between between) {
  constexpr int E = 4 / sizeof(TX);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const int words = (cc + E - 1) / E;
  x += img * h * wd * ic + c0;
  if (ic % (2 * E) == 0 && c0 % (2 * E) == 0 && cc % (2 * E) == 0 &&
      (addr & 7) == 0) {
    stage_items(
        PLANE * words / 2, words / 2, tr0, tc0, h, wd, make_uint2(0u, 0u),
        [&](int u, int pixel) {
          return *reinterpret_cast<const uint2*>(
              x + static_cast<int64_t>(pixel) * ic + u * 2 * E);
        },
        [&](int pos, int u, uint2 raw) {
          xs[(2 * u) * PLANE + pos] = raw.x;
          xs[(2 * u + 1) * PLANE + pos] = raw.y;
        },
        between);
  } else {
    using UX = std::make_unsigned_t<TX>;
    stage_items(
        PLANE * words, words, tr0, tc0, h, wd, 0u,
        [&](int k, int pixel) {
          const TX* px = x + static_cast<int64_t>(pixel) * ic + k * E;
          uint32_t raw = 0u;
          for (int e = 0; e < E && k * E + e < cc; ++e)
            raw |= static_cast<uint32_t>(static_cast<UX>(px[e]))
                   << (8 * sizeof(TX) * e);
          return raw;
        },
        [&](int pos, int k, uint32_t v) { xs[k * PLANE + pos] = v; },
        between);
  }
}

// Lane e of a packed word of TX containers, sign-extended: one PRMT, whose
// selector nibbles copy the lane's bytes and replicate its top bit.
template <typename TX>
__device__ __forceinline__ uint32_t lane(uint32_t packed, int e) {
  const uint32_t lo = sizeof(TX) * e, top = lo + sizeof(TX) - 1;
  const uint32_t sign = 8u | top;
  const uint32_t sel = sizeof(TX) == 1
                           ? lo | sign << 4 | sign << 8 | sign << 12
                           : lo | top << 4 | sign << 8 | sign << 12;
  uint32_t v;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(v) : "r"(packed), "r"(sel));
  return v;
}

// OCT consecutive words of shared memory (16-byte aligned, OCT a multiple
// of 4) into registers.
template <int OCT>
__device__ __forceinline__ void load_words(uint32_t (&dst)[OCT],
                                           const uint32_t* src) {
  static_assert(OCT % 4 == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < OCT / 4; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

// The (PPT + 2) x 3 window of staged words under this thread's pixels.
__device__ __forceinline__ void load_window(uint32_t (&win)[PPT + 2][3],
                                            const uint32_t* plane,
                                            const TilePos& tp) {
  const uint32_t* xc = plane + tp.r0 * HALO_W + tp.col;
#pragma unroll
  for (int r = 0; r < PPT + 2; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) win[r][q] = xc[r * HALO_W + q];
}

// The layer's requantize (repro/core/cnn.py::_requantize): the int32 sum
// shifted right arithmetically by shift (the wrapper passes min(shift,
// 31)), clamped to [0, hi].
__device__ __forceinline__ int32_t requant(uint32_t acc, int shift,
                                           int32_t hi) {
  return min(max(static_cast<int32_t>(acc) >> shift, 0), hi);
}

// The epilogue of a layer kernel: this thread's PPT pixels x channels [o0,
// o0 + min(OCT, oc - o0)).  TO = int32_t writes the exact accumulator into
// out (N, OC, H, W), coalesced along W.  TO = int8_t or int16_t writes the
// requantized activations into the channels-last container out (N, H, W,
// OC): a pixel's channels are packed in registers and stored as one 4-, 8-
// or 16-byte word where they fill the tile, so a warp writes 32 whole
// neighbouring pixels.
template <typename TO, int OCT>
__device__ __forceinline__ void write_pixels(TO* __restrict__ out,
                                             const uint32_t (&acc)[PPT][OCT],
                                             const TilePos& tp, int h, int wd,
                                             int oc, int o0, int shift,
                                             int32_t hi) {
  const int q = tp.tc0 + tp.col;
  const int n_ch = min(OCT, oc - o0);
  if (q >= wd) return;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int r = tp.tr0 + tp.r0 + p;
    if (r >= h) continue;
    if constexpr (std::is_same<TO, int32_t>::value) {
      int32_t* o = out + ((tp.img * oc + o0) * h + r) * wd + q;
#pragma unroll
      for (int j = 0; j < OCT; ++j)
        if (j < n_ch)
          o[static_cast<int64_t>(j) * h * wd] =
              static_cast<int32_t>(acc[p][j]);
    } else {
      TO v[OCT];
#pragma unroll
      for (int j = 0; j < OCT; ++j)
        v[j] = static_cast<TO>(requant(acc[p][j], shift, hi));
      TO* o = out + ((tp.img * h + r) * wd + q) * oc + o0;
      constexpr int BYTES = OCT * sizeof(TO);
      const uintptr_t a = reinterpret_cast<uintptr_t>(o);
      if (n_ch == OCT && BYTES == 16 && (a & 15) == 0) {
        uint4 u;
        memcpy(&u, v, 16);
        *reinterpret_cast<uint4*>(o) = u;
      } else if (n_ch == OCT && BYTES == 8 && (a & 7) == 0) {
        uint2 u;
        memcpy(&u, v, 8);
        *reinterpret_cast<uint2*>(o) = u;
      } else if (n_ch == OCT && BYTES == 4 && (a & 3) == 0) {
        uint32_t u;
        memcpy(&u, v, 4);
        *reinterpret_cast<uint32_t*>(o) = u;
      } else {
#pragma unroll
        for (int j = 0; j < OCT; ++j)
          if (j < n_ch) o[j] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The plane kernels (conv2_planes, conv3_planes, conv4_planes) on the same
// tile.  P planes x (P, H, W) are an (N = P, H, W, ic = 1) batch whose
// images each carry their own weights, w (P, 3, 3) or (P, 2, 3, 3): block
// (plane, tile) stages its plane's halo tile with stage(..., ic = 1, ...)
// and, once, in `between`, the plane's weights as PLANE_WORDS words in
// shared memory.  Every thread then reads those words with 16-byte
// broadcasts, computes its PPT pixels of the plane's one or two outputs,
// and write_pixels stores them into out (P, H, W) or (P, 2, H, W),
// coalesced along W.
// ---------------------------------------------------------------------------
constexpr int PLANE_WORDS = 20;   // 18 weights, padded to 16-byte loads

// Stage plane tp.img's halo tile into xs (HALO_H, HALO_W) and ws[i] =
// weight(i) for i < PLANE_WORDS (thread i forms word i, its loads issued
// while the tile's are in flight), then wait for both.
template <typename TX, typename F>
__device__ __forceinline__ void stage_plane(uint32_t* xs, uint32_t* ws,
                                            const TX* __restrict__ x,
                                            const TilePos& tp, int h, int wd,
                                            F weight) {
  stage(xs, x, tp.img, tp.tr0, tp.tc0, h, wd, 1, 0, 1, [&] {
    if (threadIdx.x < PLANE_WORDS) ws[threadIdx.x] = weight(threadIdx.x);
  });
  __syncthreads();
}

// NOUT independent 9-tap dots per pixel: conv2_kernel (NOUT = 1),
// conv4_kernel and conv3_kernel outside its packing regime (NOUT = 2), on
// plane tp.img of x with its weights wp (NOUT, 3, 3), into out (P, NOUT,
// H, W).  ws holds the 9 * NOUT sign-extended weights, w[j][t] at 9 * j +
// t, and each (tap, output) is a 32-bit multiply-add on the CUDA cores,
// also for the int8 dots: __dp4a over a window row's 3 taps packed into a
// word (fused_dot_layer's route at ic = 1) ran 1.10-1.12x slower at every
// timed shape of conv4_planes on the H100 (PERF.md).
template <int NOUT, typename TX, typename TW>
__device__ __forceinline__ void dot_planes(uint32_t* xs, uint32_t* ws,
                                           const TX* __restrict__ x,
                                           const TW* __restrict__ wp,
                                           int32_t* __restrict__ out,
                                           const TilePos& tp, int h, int wd) {
  constexpr int WORDS = (9 * NOUT + 3) / 4 * 4;   // whole 16-byte loads
  static_assert(WORDS <= PLANE_WORDS, "the staged weights hold them");
  stage_plane(xs, ws, x, tp, h, wd,
              [&](int i) { return i < 9 * NOUT ? word(wp[i]) : 0u; });
  uint32_t win[PPT + 2][3], wr[WORDS], acc[PPT][NOUT];
  load_window(win, xs, tp);
  load_words(wr, ws);
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
      uint32_t a = 0u;
#pragma unroll
      for (int t = 0; t < 9; ++t) a += win[p + t / 3][t % 3] * wr[9 * j + t];
      acc[p][j] = a;
    }
  write_pixels<int32_t, NOUT>(out, acc, tp, h, wd, NOUT, 0, 0, 0);
}

// Give a kernel the dynamic shared memory it needs: above 48 KB only after
// opting in.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
