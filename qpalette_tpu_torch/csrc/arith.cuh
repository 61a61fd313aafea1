// Arithmetic trellis decode for Hopper (sm_90a): the shared decoder and the
// decode-GEMV kernel template (K1 in 1mad and 2mad above 8 rows), included by
// tcq2_gemv.cu (V=2 modes) and tcq1_gemv.cu (V=1 modes), both through
// arith_tc.cuh, and by arith_dequant.cu (K2, K3).
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
// serves which case:
//   sum2, dualmad at N <= 8        tcq2_gemv.cu's v2_gemv_kernel (tensor
//                                  cores, per-warp TMA rings; its note is
//                                  there, the body in arith_tc.cuh)
//   1mad, 2mad at N <= 8           tcq1_gemv.cu's v1_gemv_kernel (the same
//                                  body, its own lane map)
//   sum2, dualmad at 8 < N <= 256  v2_wide.cuh's v2_wide_kernel (tensor
//                                  cores, a tile decoded once for all rows)
//   1mad, 2mad at 8 < N <= 256     this template, 8 rows a pass
//
// Variants: exact (x rounded to bf16, f32 accumulation of x * w) and a8 (x
// quantized to int8 inside the kernel per 512-column chunk, one absmax
// scale per chunk over all N rows as in the TPU kernel; integer dot per
// chunk, each chunk descaled into f32).  a8 per state: (unsigned byte sum
// - 510) * q, the exact integer weight (the TPU kernel instead sums XOR'd
// bytes and adds 2*sum(x) in f32).
//
// What bounds it: at bs=1 every weight is read once, KV/V bits of packed
// trellis per weight, and decoding costs ~5-10 integer ops per state, so
// the kernel is bound by the packed trellis bytes streamed from device
// memory.  Design: one block per 16-row m-tile (its tiles are contiguous);
// the block walks k in 512-column chunks, copies each chunk's words to
// shared memory with 16-byte loads (the next chunk's words are loaded into
// registers while the current chunk is decoded), and its 8 warps stride
// over the chunk's tiles.  Lane l decodes the states l + 32q of a tile,
// all of output row l % 16, so row sums stay in registers and are reduced
// once through shared memory.  Activations are handled in groups of 8 rows
// (weights are re-read from L2 once per group).  wgmma, TMA and a Hopper
// weight layout are later work.

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;               // columns per chunk (a8 scale unit)
constexpr int kChunkTiles = kChunk / 16;  // k-tiles per chunk
constexpr int kMaxChunks = 64;            // k <= 32768
constexpr int kGroup = 8;                 // activation rows per pass

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  return (uint32_t)__float2int_rn(__fmul_rn(v, inv)) & 0xffu;
}

template <typename XT, int MODE, int KV, bool A8>
__global__ void __launch_bounds__(kThreads)
arith_gemv_kernel(const XT* __restrict__ x, const int4* __restrict__ tr,
                  float* __restrict__ out, int N, int m, int k) {
  static_assert(mode_v(MODE) == 1, "the V=2 modes above 8 rows are "
                "v2_wide_kernel");
  constexpr int NG = kGroup;
  constexpr int V = mode_v(MODE);
  constexpr int W = 8 * KV / V;  // 32-bit words per tile
  constexpr int WV = W / 4;      // int4 per tile
  constexpr int Q = 8 / V;       // states per lane per tile
  constexpr int XW = kChunk;  // a8 activation words (q) a row of a chunk
  constexpr int kLoads = (kChunkTiles * WV + kThreads - 1) / kThreads;
  __shared__ __align__(16) uint32_t ws[kChunkTiles * W];
  __shared__ __align__(16) float xs[kGroup * kChunk];  // exact: bf16 values
  __shared__ float sx[kMaxChunks];
  __shared__ float red[kWarps][NG][16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = lane & 15;
  const int mt = blockIdx.x;
  const int kt_total = k >> 4;
  const int nch = (k + kChunk - 1) / kChunk;
  const int4* tr_row = tr + (size_t)mt * kt_total * WV;
  int* xq = reinterpret_cast<int*>(xs);

  if (A8) {  // per-chunk absmax scale over all N rows
    for (int c = warp; c < nch; c += kWarps) {
      const int c0 = c * kChunk, cw = min(kChunk, k - c0);
      float amax = 0.f;
      for (int i = lane; i < N * cw; i += 32) {
        const int n = i / cw, col = i - n * cw;
        amax = fmaxf(amax, fabsf(load_x(x + (size_t)n * k + c0 + col)));
      }
      for (int o = 16; o; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) sx[c] = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-30f);
    }
    __syncthreads();
  }

  int4 wreg[kLoads];
  auto fetch = [&](int c) {
    const int nvec = min(kChunkTiles, kt_total - c * kChunkTiles) * WV;
    const int4* src = tr_row + (size_t)c * kChunkTiles * WV;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kThreads;
      if (i < nvec) wreg[l] = src[i];
    }
  };

  for (int g0 = 0; g0 < N; g0 += NG) {
    const int ng = min(NG, N - g0);
    float acc[NG];
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[n] = 0.f;
    fetch(0);

    for (int c = 0; c < nch; ++c) {
      const int c0 = c * kChunk, cw = min(kChunk, k - c0), ntile = cw >> 4;
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int i = tid + l * kThreads;
        if (i < ntile * WV) reinterpret_cast<int4*>(ws)[i] = wreg[l];
      }
      if (A8) {
        const float inv = __fdiv_rn(1.0f, sx[c]);
        for (int i = tid; i < NG * cw; i += kThreads) {
          const int n = i / cw, p = i - n * cw;
          int v = 0;
          if (n < ng) {
            const XT* xp = x + (size_t)(g0 + n) * k + c0;
            v = __float2int_rn(__fmul_rn(load_x(xp + p), inv));
          }
          xq[n * XW + p] = v;
        }
      } else {
        for (int i = tid; i < NG * cw; i += kThreads) {
          const int n = i / cw, col = i - n * cw;
          float v = 0.f;
          if (n < ng)
            v = __bfloat162float(__float2bfloat16_rn(
                load_x(x + (size_t)(g0 + n) * k + c0 + col)));
          xs[n * kChunk + col] = v;
        }
      }
      __syncthreads();

      if (c + 1 < nch) fetch(c + 1);  // in flight during the decode

      int iacc[NG];
#pragma unroll
      for (int n = 0; n < NG; ++n) iacc[n] = 0;
      for (int j = warp; j < ntile; j += kWarps) {
        const uint32_t* wt = ws + j * W;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int s = lane + 32 * q;
          const int g = s >> 4;  // the column
          const uint32_t u = state_at<KV, W>(wt, s);
          if (A8) {
            int w[2];
            state_weights<MODE>(u, w);
            const int* xr = xq + j * 16 + g;
#pragma unroll
            for (int n = 0; n < NG; ++n) iacc[n] += w[0] * xr[n * XW];
          } else {
            int w[2];
            state_weights<MODE>(u, w);
            const float w0 = (float)w[0];
            const float* xr = xs + j * 16 + g;
#pragma unroll
            for (int n = 0; n < NG; ++n)
              acc[n] = fmaf(xr[n * kChunk], w0, acc[n]);
          }
        }
      }
      if (A8) {
        const float s = sx[c];
#pragma unroll
        for (int n = 0; n < NG; ++n)
          acc[n] = __fadd_rn(acc[n], __fmul_rn((float)iacc[n], s));
      }
      __syncthreads();  // ws / xs are overwritten by the next chunk
    }

    // lanes l and l^16 hold the same row; then sum the warps' partials
#pragma unroll
    for (int n = 0; n < NG; ++n)
      acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], 16);
    if (lane < 16) {
#pragma unroll
      for (int n = 0; n < NG; ++n) red[warp][n][row] = acc[n];
    }
    __syncthreads();
    for (int i = tid; i < ng * 16; i += kThreads) {
      const int n = i >> 4, r = i & 15;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][n][r];
      out[(size_t)(g0 + n) * m + mt * 16 + r] = v * kMadInv;
    }
    __syncthreads();  // red is reused by the next group
  }
}

// 1mad and 2mad reach this template only at N > 8 (the tensor-core
// kernels take N <= 8, v2_wide_kernel the V=2 modes above), so only its
// 8-row instances of those modes are built
template <typename XT, int MODE, int KV, bool A8>
int launch_gemv(const void* x, const void* tr, void* out, int N, int m,
                int k, cudaStream_t st) {
  arith_gemv_kernel<XT, MODE, KV, A8><<<m / 16, kThreads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int4*>(tr),
      static_cast<float*>(out), N, m, k);
  return (int)cudaGetLastError();
}

template <int MODE, int KV>
int gemv_variants(const void* x, int x_bf16, const void* tr, void* out,
                  int N, int m, int k, int a8, cudaStream_t st) {
  if (x_bf16)
    return a8 ? launch_gemv<__nv_bfloat16, MODE, KV, true>(x, tr, out, N, m,
                                                           k, st)
              : launch_gemv<__nv_bfloat16, MODE, KV, false>(x, tr, out, N,
                                                            m, k, st);
  return a8 ? launch_gemv<float, MODE, KV, true>(x, tr, out, N, m, k, st)
            : launch_gemv<float, MODE, KV, false>(x, tr, out, N, m, k, st);
}

inline bool bad_gemv_args(int N, int m, int k) {
  return N < 1 || N > 256 || m <= 0 || k <= 0 || m % 16 || k % 16 ||
         k > kChunk * kMaxChunks;
}

}  // namespace qpt
