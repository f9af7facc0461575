// packed_dot_layer: Conv3's operand-packed dual convolution over a whole
// CNN layer, optionally ending in the layer's requantize.
//
// Replaces repro/blocks/base.py::packed_dot_layer (the layer-fused form of
// repro/kernels/conv2d.py::conv3_kernel's packed regime; jnp compiled by
// XLA on the TPU), and with its second entry the same layer followed by
// repro/core/cnn.py::_requantize, which the reference compiles into the
// same per-layer executable.  Output channels go in pairs (an odd tail is
// paired with a copy of itself and the twin discarded); each pair shares one
// int32 operand (w_hi << S) + w_lo with S = d + c + 3, so one 9-tap dot per
// (image, pixel, pair, input channel) yields both convolutions.  The signed
// field split
//     lo = ((acc + half) & (2^S - 1)) - half,   hi = (acc - lo) >> S
// happens per input plane, before the sum over input channels.  Inside the
// packing regime (d + c <= 12) the split is exact, so the layer's output
// equals a plain 3x3 convolution's: the kernel does the reference's packed
// arithmetic (one int32 dot per pair, then the per-plane split), and a
// library convolution of the same layer is its yardstick.  The packed
// operand is an int32, which Hopper's tensor cores do not take: the dots run
// as 32-bit multiply-adds on the CUDA cores.
//
// Bound on the H100: memory bytes at the serving shapes (the dot work is half
// a plain convolution's), and below that, at these small layers, by each
// block's chain of latencies.  The first version of this kernel ran one pixel
// per thread, read every tap from global memory behind four bounds checks and
// kept 8 pairs in registers where the layers have 2 to 4; it was bound by its
// loads.  Design: the tile of common.cuh (16 x 32 pixels and its halo, zeros
// written at staging) in shared memory as packed words, 4 int8 or 2 int16
// channels each, 8 words at a time (8-byte loads of channels-last rows, each
// thread's issued together); each thread reads a word of its 4 x 3 window once
// and extracts its channels in registers (one PRMT each).  The packed operands
// are formed once per block, while the first chunk's loads are in flight, and
// padded to the register tile: 2 pixels x PT pairs per thread, 256 threads (PT
// = 2 where OC <= 4, else 4).  The split runs in registers per plane.  The
// epilogue writes the int32 accumulator (N, OC, H, W), or requantizes and
// writes the next layer's channels-last container (N, H, W, OC), one 4-, 8- or
// 16-byte store per pixel.
#include "common.cuh"

namespace {

using repro::HALO_W;
using repro::ICC;
using repro::PLANE;
using repro::PPT;

template <typename TX, typename TW, typename TO, int PT>
__global__ void __launch_bounds__(repro::TILE_THREADS)
packed_dot_layer_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        TO* __restrict__ out, int h, int wd, int ic, int oc,
                        int pack_shift, int shift, int32_t hi_out) {
  constexpr int E = 4 / sizeof(TX);       // channels per staged word
  constexpr int CHUNK = ICC * E;          // channels staged at once
  constexpr int OCT = 2 * PT;             // output channels per pair tile
  extern __shared__ __align__(16) uint32_t pd_smem[];
  const int pairs = (oc + 1) / 2;
  const int ptiles = (pairs + PT - 1) / PT;
  const int kw = ic * 9;
  uint32_t* psm = pd_smem;                // (pair tiles, IC, 9, PT)
  uint32_t* xs = pd_smem + ptiles * kw * PT;   // (ICC, HALO_H, HALO_W)
  // staged while the first chunk's loads are in flight
  auto stage_weights = [&] {
    repro::stage_words(psm, ptiles * kw * PT, [&](int i) {
      const int j = i % PT, rest = i / PT;
      const int pt = ptiles == 1 ? 0 : rest / kw;
      const int pr = pt * PT + j, ct = rest - pt * kw;
      if (pr >= pairs) return 0u;
      const int lo_ch = min(2 * pr + 1, oc - 1);  // odd tail: its own twin
      return (repro::word(w[2 * pr * kw + ct]) << pack_shift) +
             repro::word(w[lo_ch * kw + ct]);
    });
  };
  const uint32_t half = 1u << (pack_shift - 1);
  const uint32_t field = (1u << pack_shift) - 1u;
  const repro::TilePos tp = repro::tile_pos(wd);

  for (int pt = 0; pt < ptiles; ++pt) {
    uint32_t sums[PPT][OCT] = {};         // (hi, lo) of each pair
    for (int c0 = 0; c0 < ic; c0 += CHUNK) {
      const int cc = min(CHUNK, ic - c0);
      if (pt == 0 || ic > CHUNK) {        // one chunk stays staged across oc
        __syncthreads();
        repro::stage_packed(xs, x, tp.img, tp.tr0, tp.tc0, h, wd, ic, c0, cc,
                            [&] {
                              if (pt == 0 && c0 == 0) stage_weights();
                            });
        __syncthreads();
      }
      for (int k = 0; k < (cc + E - 1) / E; ++k) {
        uint32_t words[PPT + 2][3];
        const uint32_t* xc = xs + k * PLANE + tp.r0 * HALO_W + tp.col;
#pragma unroll
        for (int r = 0; r < PPT + 2; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) words[r][q] = xc[r * HALO_W + q];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = c0 + k * E + e;
          if (c >= ic) break;
          uint32_t win[PPT + 2][3];
#pragma unroll
          for (int r = 0; r < PPT + 2; ++r)
#pragma unroll
            for (int q = 0; q < 3; ++q)
              win[r][q] = repro::lane<TX>(words[r][q], e);
          const uint32_t* wc = psm + (pt * kw + c * 9) * PT;
          uint32_t acc[PPT][PT] = {};
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            uint32_t wt[PT];
#pragma unroll
            for (int j = 0; j < PT; ++j) wt[j] = wc[t * PT + j];
#pragma unroll
            for (int p = 0; p < PPT; ++p)
#pragma unroll
              for (int j = 0; j < PT; ++j)
                acc[p][j] += win[p + t / 3][t % 3] * wt[j];
          }
#pragma unroll
          for (int p = 0; p < PPT; ++p)
#pragma unroll
            for (int j = 0; j < PT; ++j) {
              // (acc + half) & field < 2^31, so the subtraction cannot
              // overflow; the right shift of a negative int32 is arithmetic
              // under nvcc
              const int32_t lo =
                  static_cast<int32_t>((acc[p][j] + half) & field) -
                  static_cast<int32_t>(half);
              const int32_t hi = static_cast<int32_t>(
                                     acc[p][j] - static_cast<uint32_t>(lo)) >>
                                 pack_shift;
              sums[p][2 * j] += static_cast<uint32_t>(hi);
              sums[p][2 * j + 1] += static_cast<uint32_t>(lo);
            }
        }
      }
    }
    repro::write_pixels<TO, OCT>(out, sums, tp, h, wd, oc, pt * OCT, shift,
                                 hi_out);
  }
}

struct Args {
  const void* x;
  const void* w;
  void* out;
  int n, h, wd, ic, oc, pack_shift, shift;
  int32_t hi;
  cudaStream_t stream;
};

template <typename TX, typename TW, typename TO, int PT>
cudaError_t run(const Args& a) {
  auto* kernel = packed_dot_layer_kernel<TX, TW, TO, PT>;
  const size_t ptiles = ((a.oc + 1) / 2 + PT - 1) / PT;
  const size_t bytes = sizeof(uint32_t) * (ptiles * a.ic * 9 * PT +
                                           static_cast<size_t>(ICC) * PLANE);
  // a refusal of the shared memory is the launch's error
  const cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<repro::tile_grid(a.n, a.h, a.wd), repro::TILE_THREADS, bytes,
           a.stream>>>(static_cast<const TX*>(a.x),
                       static_cast<const TW*>(a.w), static_cast<TO*>(a.out),
                       a.h, a.wd, a.ic, a.oc, a.pack_shift, a.shift, a.hi);
  return cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
cudaError_t launch(const Args& a) {
  return a.oc <= 4 ? run<TX, TW, TO, 2>(a) : run<TX, TW, TO, 4>(a);
}

template <typename TO>
cudaError_t launch_containers(const Args& a, int x_int16, int w_int16) {
  if (x_int16 && w_int16) return launch<int16_t, int16_t, TO>(a);
  if (x_int16) return launch<int16_t, int8_t, TO>(a);
  if (w_int16) return launch<int8_t, int16_t, TO>(a);
  return launch<int8_t, int8_t, TO>(a);
}

}  // namespace

// pack_shift = S = d + c + 3, at most 31 (the wrapper checks).
extern "C" int repro_packed_dot_layer(const void* x, const void* w, void* out,
                                      int x_int16, int w_int16, int n, int h,
                                      int wd, int ic, int oc, int pack_shift,
                                      void* stream) {
  const Args a{x, w, out, n, h, wd, ic, oc, pack_shift, 0, 0,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_containers<int32_t>(a, x_int16, w_int16));
}

// The same layer, then the requantize: out (N, H, W, OC) in the container
// of out_bits (int8 up to 8 bits, else int16); 0 <= shift <= 31 (the
// wrapper passes min(shift, 31)).
extern "C" int repro_packed_dot_layer_requant(const void* x, const void* w,
                                              void* out, int x_int16,
                                              int w_int16, int n, int h,
                                              int wd, int ic, int oc,
                                              int pack_shift, int shift,
                                              int out_bits, void* stream) {
  const Args a{x, w, out, n, h, wd, ic, oc, pack_shift, shift,
               static_cast<int32_t>((1u << (out_bits - 1)) - 1u),
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      out_bits <= 8 ? launch_containers<int8_t>(a, x_int16, w_int16)
                    : launch_containers<int16_t>(a, x_int16, w_int16));
}
