// Arithmetic trellis decode for Hopper (sm_90a): the shared decoder of K1's
// tensor-core GEMVs, included by tcq2_gemv.cu (V=2 modes) and tcq1_gemv.cu
// (V=1 modes), both through arith_tc.cuh and arith_wide.cuh, and by
// arith_dequant.cu (K2, K3).
//
// The port's canonical trellis: (T, W) 32-bit words, T = (m/16)*(k/16)
// tiles in tile-row-major order, W = 8*KV/V words a tile (V weights per
// state).  State s of a tile (0 <= s < 256/V) is the 16-bit window u at bit
// KV*s of the tile's circular stream (word indices wrap modulo W).  Tile
// order, as in qpalette_tpu/ops/packing.py:
//   V=2 (sum2, dualmad), paired-K-major: s = 16t + row covers the weights
//       (row, 2t) and (row, 2t+1);
//   V=1 (1mad, 2mad), K-major: s = 16*col + row covers (row, col).
// So for both, row = s % 16 and g = s / 16 is the column pair (V=2) or the
// column (V=1).  The decode modes (qpalette_tpu/ops/codebooks.py), giving
// integer weights that are divided by 147.800537109375:
//   sum2:    h = u*34038481 + 76625530; w0 = sb0+sb1, w1 = sb2+sb3
//   dualmad: h1 = u*34038481, h2 = u*264435761; wi = signed byte sum of hi
//   1mad:    h = u*34038481 + 76625530;           w = unsigned byte sum - 510
//   2mad:    h0 = u*264435761 + 1013904223, h = h0 + hi32(h0*1664525);
//            w as 1mad
// (sb = signed bytes of h, all arithmetic mod 2^32.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qpt {

enum Mode { kSum2 = 0, kDualmad = 1, k1mad = 2, k2mad = 3 };

__host__ __device__ constexpr int mode_v(int mode) {
  return mode <= kDualmad ? 2 : 1;
}

constexpr uint32_t kMad1A = 34038481u;
constexpr uint32_t kMad1B = 76625530u;
constexpr uint32_t kMad2A = 264435761u;
constexpr uint32_t kMad2B = 1013904223u;
constexpr uint32_t kMad2C = 1664525u;
constexpr float kMadInv = (float)(1.0 / 147.800537109375);

// state s of the tile whose W words are wt
template <int KV, int W>
__device__ __forceinline__ uint32_t state_at(const uint32_t* wt, int s) {
  const int off = KV * s;
  const int w0 = off >> 5, sh = off & 31;
  const int w1 = (w0 + 1 == W) ? 0 : w0 + 1;  // the stream is circular
  return __funnelshift_r(wt[w0], wt[w1], sh) & 0xffffu;
}

// V=1 modes: the scrambled word whose unsigned byte sum - 510 is the weight
template <int MODE>
__device__ __forceinline__ uint32_t v1_hash(uint32_t u) {
  if (MODE == k1mad) return u * kMad1A + kMad1B;
  const uint32_t h0 = u * kMad2A + kMad2B;
  return h0 + __umulhi(h0, kMad2C);
}

// unscaled integer weights of state u: w[0] (and w[1] for V=2)
template <int MODE>
__device__ __forceinline__ void state_weights(uint32_t u, int (&w)[2]) {
  if (MODE == kSum2) {
    const int h = (int)(u * kMad1A + kMad1B);
    w[0] = __dp4a(h, 0x00000101, 0);  // sb0 + sb1
    w[1] = __dp4a(h, 0x01010000, 0);  // sb2 + sb3
  } else if (MODE == kDualmad) {
    w[0] = __dp4a((int)(u * kMad1A), 0x01010101, 0);
    w[1] = __dp4a((int)(u * kMad2A), 0x01010101, 0);
  } else {
    w[0] = (int)__dp4a(v1_hash<MODE>(u), 0x01010101u, 0u) - 510;
    w[1] = 0;
  }
}

// ---------------------------------------------------------------------------
// K1: decode + GEMV, y = x @ W_hat^T in float32 (N <= 256 rows, no Wscale)
// ---------------------------------------------------------------------------
//
// Replaces qpalette_tpu/kernels/fused.py::_arith_kernel (reached through
// _arith_decode_matmul from tcq2_decode_matmul / tcq1_decode_matmul), on
// the canonical trellis instead of the TPU's planar layouts.  Which kernel
// serves which case (all on tensor cores):
//   sum2, dualmad at N <= 8        tcq2_gemv.cu's v2_gemv_kernel (per-warp
//                                  TMA rings; its note is there, the body
//                                  in arith_tc.cuh)
//   1mad, 2mad at N <= 8           tcq1_gemv.cu's v1_gemv_kernel (the same
//                                  body, its own lane map)
//   every mode at 8 < N <= 256     arith_wide.cuh's wide_gemv_kernel (a
//                                  tile decoded once for all rows) under
//                                  the mode's tile policy: WideTile (V=2,
//                                  arith_wide.cuh), WideTile1 (V=1,
//                                  tcq1_gemv.cu)
//
// Variants: exact (x rounded to bf16, f32 accumulation of x * w) and a8 (x
// quantized to int8 per 512-column chunk, one absmax scale per chunk over
// all N rows as in the TPU kernel; integer dot per chunk, each chunk
// descaled into f32).  a8 per V=1 state: (unsigned byte sum - 510) * q,
// the exact integer weight (the TPU kernel instead sums XOR'd bytes and
// adds 2*sum(x) in f32).

constexpr int kThreads = 256;  // arith_dequant.cu's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;     // columns per chunk (a8 scale unit)
constexpr int kMaxChunks = 64;  // k <= 32768
constexpr int kV1Bias = 510;    // V=1: the weight is the byte sum - 510

__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  return (uint32_t)__float2int_rn(__fmul_rn(v, inv)) & 0xffu;
}

inline bool bad_gemv_args(int N, int m, int k) {
  return N < 1 || N > 256 || m <= 0 || k <= 0 || m % 16 || k % 16 ||
         k > kChunk * kMaxChunks;
}

}  // namespace qpt
