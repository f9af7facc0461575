// fused_dot_layer: one integer dot for a whole CNN layer, as an implicit
// GEMM, optionally ending in the layer's requantize.
//
// Replaces repro/blocks/base.py::fused_dot_layer, the layer-fused dot that
// carries conv2, conv4 and conv3 outside its packing regime on the serving
// path (jnp compiled by XLA on the TPU, not Pallas), and with its second
// entry the same dot followed by repro/core/cnn.py::_requantize, which the
// reference compiles into the same per-layer executable.  It contracts the
// 'same'-padded 3x3 taps of all IC input channels with the (IC * 9, OC)
// weights into int32, for every image, without writing the im2col matrix
// to device memory.
//
// The reference dots in int8 when both widths are <= 8 bits and in int32
// otherwise; either way the result is the exact sum modulo 2^32.  The
// wrapper narrows an int16 operand to int8 first where the reference's int8
// dot would, and the entry picks the route from the containers alone:
// - both int8: __dp4a, four int8 products summed into an int32 per
//   instruction.  Where IC is a multiple of 4, a staged word holds four
//   channels of one pixel as they lie in memory and the weights are packed
//   the same way (IC / 4 * 9 instructions per pixel and output); otherwise,
//   as at IC = 1, the three taps of a window row are packed into one word
//   (3 * IC instructions).  The int32 sum wraps modulo 2^32 as the
//   reference's does; for an int8 dot |sum| <= IC * 9 * 2^14.
// - an int16 container (an int32 dot): one 32-bit multiply-add per (tap,
//   output) on the CUDA cores, summed in uint32_t, exact modulo 2^32.
//
// Bound on the H100: memory bytes at the serving shapes (an 8 -> 8 layer does
// 144 integer operations per output it writes), and below that, at these small
// layers, by each block's chain of latencies (its loads, its compute, its
// stores), not by a rate.  The first version of this kernel ran one pixel per
// thread and read every tap from global memory behind four bounds checks; it
// was bound by its loads.  Design: the tile of common.cuh (16 x 32 pixels and
// its halo, zeros written at staging) in shared memory, 8 channels (IMAD,
// rows) or 8 packed words (32 channels, DP4A) at a time, each thread's loads
// issued together; the weights staged once per block, while the first chunk's
// loads are in flight, in the order the inner loop reads them and padded to
// the register tile so that each tap's weights are whole 16-byte loads; each
// of 256 threads computes 2 pixels x OCT outputs (OCT = 4 or 8, the smaller
// where OC <= 4).  The epilogue writes the int32 accumulator (N, OC, H, W), or
// requantizes and writes the next layer's channels-last container (N, H, W,
// OC), one 4-, 8- or 16-byte store per pixel.
#include "common.cuh"

namespace {

using repro::ICC;
using repro::load_window;
using repro::PLANE;
using repro::PPT;

__device__ __forceinline__ uint32_t dp4a(uint32_t a, uint32_t b, uint32_t c) {
  return static_cast<uint32_t>(__dp4a(static_cast<int>(a),
                                      static_cast<int>(b),
                                      static_cast<int>(c)));
}

// Four int8 weights as one word, the first in the low byte.
__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

// The int32 dot.  Weights wsm (o-tiles, IC, 9, OCT), zero past OC.
template <typename TX, typename TW, typename TO, int OCT>
__global__ void __launch_bounds__(repro::TILE_THREADS)
fused_imad_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  TO* __restrict__ out, int h, int wd, int ic, int oc,
                  int shift, int32_t hi) {
  extern __shared__ __align__(16) uint32_t fd_smem[];
  const int otiles = (oc + OCT - 1) / OCT;
  const int kw = ic * 9;
  uint32_t* wsm = fd_smem;
  uint32_t* xs = fd_smem + otiles * kw * OCT;       // (ICC, HALO_H, HALO_W)
  // staged while the first chunk's loads are in flight
  auto stage_weights = [&] {
    repro::stage_words(wsm, otiles * kw * OCT, [&](int i) {
      const int j = i % OCT, rest = i / OCT;
      const int ot = otiles == 1 ? 0 : rest / kw;
      const int o = ot * OCT + j;
      return o < oc ? repro::word(w[o * kw + rest - ot * kw]) : 0u;
    });
  };
  const repro::TilePos tp = repro::tile_pos(wd);

  for (int ot = 0; ot < otiles; ++ot) {
    uint32_t acc[PPT][OCT] = {};
    for (int c0 = 0; c0 < ic; c0 += ICC) {
      const int cc = min(ICC, ic - c0);
      if (ot == 0 || ic > ICC) {        // one chunk stays staged across oc
        __syncthreads();
        repro::stage(xs, x, tp.img, tp.tr0, tp.tc0, h, wd, ic, c0, cc, [&] {
          if (ot == 0 && c0 == 0) stage_weights();
        });
        __syncthreads();
      }
      for (int cl = 0; cl < cc; ++cl) {
        uint32_t win[PPT + 2][3];
        load_window(win, xs + cl * PLANE, tp);
        const uint32_t* wc = wsm + (ot * kw + (c0 + cl) * 9) * OCT;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          uint32_t wt[OCT];
          repro::load_words(wt, wc + t * OCT);
#pragma unroll
          for (int p = 0; p < PPT; ++p)
#pragma unroll
            for (int j = 0; j < OCT; ++j)
              acc[p][j] += win[p + t / 3][t % 3] * wt[j];
        }
      }
    }
    repro::write_pixels<TO, OCT>(out, acc, tp, h, wd, oc, ot * OCT, shift,
                                 hi);
  }
}

// The int8 dot.  CHANNELS (IC % 4 == 0): staged words of 4 channels, weights
// wsm (o-tiles, IC / 4, 9, OCT) packed alike.  Otherwise one sign-extended
// word per channel is staged, each window row's 3 taps are packed into a
// word in registers, and the weights wsm (o-tiles, IC, 3, OCT) hold a row's
// 3 taps and a zero byte.
template <typename TO, int OCT, bool CHANNELS>
__global__ void __launch_bounds__(repro::TILE_THREADS)
fused_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  TO* __restrict__ out, int h, int wd, int ic, int oc,
                  int shift, int32_t hi) {
  extern __shared__ __align__(16) uint32_t fd_smem[];
  const int otiles = (oc + OCT - 1) / OCT;
  const int kw = CHANNELS ? ic / 4 * 9 : ic * 3;     // words per output
  uint32_t* wsm = fd_smem;
  uint32_t* xs = fd_smem + otiles * kw * OCT;        // (ICC, HALO_H, HALO_W)
  // staged while the first chunk's loads are in flight
  auto stage_weights = [&] {
    repro::stage_words(wsm, otiles * kw * OCT, [&](int i) {
      const int j = i % OCT, rest = i / OCT;
      const int ot = otiles == 1 ? 0 : rest / kw;
      const int o = ot * OCT + j, k = rest - ot * kw;
      if (o >= oc) return 0u;
      const int8_t* wo = w + o * ic * 9;
      if constexpr (CHANNELS) {
        const int8_t* wk = wo + k / 9 * 4 * 9 + k % 9;   // 4 channels, tap
        return pack4(wk[0], wk[9], wk[18], wk[27]);
      }
      return pack4(wo[k * 3], wo[k * 3 + 1], wo[k * 3 + 2], 0);
    });
  };
  const repro::TilePos tp = repro::tile_pos(wd);
  // channels per staged plane, and channels staged at once
  constexpr int PER = CHANNELS ? 4 : 1;
  constexpr int CHUNK = ICC * PER;

  for (int ot = 0; ot < otiles; ++ot) {
    uint32_t acc[PPT][OCT] = {};
    for (int c0 = 0; c0 < ic; c0 += CHUNK) {
      const int cc = min(CHUNK, ic - c0);
      if (ot == 0 || ic > CHUNK) {
        __syncthreads();
        auto first = [&] {
          if (ot == 0 && c0 == 0) stage_weights();
        };
        if constexpr (CHANNELS)
          repro::stage_packed(xs, x, tp.img, tp.tr0, tp.tc0, h, wd, ic, c0,
                              cc, first);
        else
          repro::stage(xs, x, tp.img, tp.tr0, tp.tc0, h, wd, ic, c0, cc,
                       first);
        __syncthreads();
      }
      for (int kl = 0; kl < cc / PER; ++kl) {
        uint32_t win[PPT + 2][3];
        load_window(win, xs + kl * PLANE, tp);
        constexpr int WORDS = CHANNELS ? 9 : 3;   // weight words per plane
        const uint32_t* wc = wsm + (ot * kw + (c0 / PER + kl) * WORDS) * OCT;
        if constexpr (CHANNELS) {
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            uint32_t wt[OCT];
            repro::load_words(wt, wc + t * OCT);
#pragma unroll
            for (int p = 0; p < PPT; ++p)
#pragma unroll
              for (int j = 0; j < OCT; ++j)
                acc[p][j] = dp4a(win[p + t / 3][t % 3], wt[j], acc[p][j]);
          }
        } else {
          // the low bytes of a row's 3 sign-extended taps, packed
          uint32_t row[PPT + 2];
#pragma unroll
          for (int r = 0; r < PPT + 2; ++r)
            row[r] = __byte_perm(__byte_perm(win[r][0], win[r][1], 0x0040),
                                 win[r][2], 0x3410);
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            uint32_t wt[OCT];
            repro::load_words(wt, wc + di * OCT);
#pragma unroll
            for (int p = 0; p < PPT; ++p)
#pragma unroll
              for (int j = 0; j < OCT; ++j)
                acc[p][j] = dp4a(row[p + di], wt[j], acc[p][j]);
          }
        }
      }
    }
    repro::write_pixels<TO, OCT>(out, acc, tp, h, wd, oc, ot * OCT, shift,
                                 hi);
  }
}

struct Args {
  const void* x;
  const void* w;
  void* out;
  int n, h, wd, ic, oc, shift;
  int32_t hi;
  cudaStream_t stream;
};

// Launch `kernel` with `weight_words` of staged weights beside the staged
// tile; a refusal of its shared memory is the launch's error.
template <typename TX, typename TW, typename TO, typename K>
cudaError_t run(K* kernel, size_t weight_words, const Args& a) {
  const size_t bytes =
      sizeof(uint32_t) * (weight_words + static_cast<size_t>(ICC) * PLANE);
  const cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<repro::tile_grid(a.n, a.h, a.wd), repro::TILE_THREADS, bytes,
           a.stream>>>(static_cast<const TX*>(a.x),
                       static_cast<const TW*>(a.w), static_cast<TO*>(a.out),
                       a.h, a.wd, a.ic, a.oc, a.shift, a.hi);
  return cudaGetLastError();
}

template <typename TO, int OCT>
cudaError_t launch_tile(const Args& a, int x_int16, int w_int16) {
  const size_t otiles = (a.oc + OCT - 1) / OCT;
  if (!x_int16 && !w_int16) {
    if (a.ic % 4 == 0)
      return run<int8_t, int8_t, TO>(fused_dp4a_kernel<TO, OCT, true>,
                                     otiles * (a.ic / 4) * 9 * OCT, a);
    return run<int8_t, int8_t, TO>(fused_dp4a_kernel<TO, OCT, false>,
                                   otiles * a.ic * 3 * OCT, a);
  }
  const size_t words = otiles * a.ic * 9 * OCT;
  if (x_int16 && w_int16)
    return run<int16_t, int16_t, TO>(
        fused_imad_kernel<int16_t, int16_t, TO, OCT>, words, a);
  if (x_int16)
    return run<int16_t, int8_t, TO>(
        fused_imad_kernel<int16_t, int8_t, TO, OCT>, words, a);
  return run<int8_t, int16_t, TO>(
      fused_imad_kernel<int8_t, int16_t, TO, OCT>, words, a);
}

template <typename TO>
cudaError_t launch(const Args& a, int x_int16, int w_int16) {
  return a.oc <= 4 ? launch_tile<TO, 4>(a, x_int16, w_int16)
                   : launch_tile<TO, 8>(a, x_int16, w_int16);
}

}  // namespace

extern "C" int repro_fused_dot_layer(const void* x, const void* w, void* out,
                                     int x_int16, int w_int16, int n, int h,
                                     int wd, int ic, int oc, void* stream) {
  const Args a{x, w, out, n, h, wd, ic, oc, 0, 0,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<int32_t>(a, x_int16, w_int16));
}

// The same dot, then the requantize: out (N, H, W, OC) in the container of
// out_bits (int8 up to 8 bits, else int16); 0 <= shift <= 31 (the wrapper
// passes min(shift, 31)).
extern "C" int repro_fused_dot_layer_requant(const void* x, const void* w,
                                             void* out, int x_int16,
                                             int w_int16, int n, int h,
                                             int wd, int ic, int oc,
                                             int shift, int out_bits,
                                             void* stream) {
  const Args a{x, w, out, n, h, wd, ic, oc, shift,
               static_cast<int32_t>((1u << (out_bits - 1)) - 1u),
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      out_bits <= 8 ? launch<int8_t>(a, x_int16, w_int16)
                    : launch<int16_t>(a, x_int16, w_int16));
}
