// tcq2s (sum2) trellis decode + GEMV for Hopper (sm_90a), plain C interface.
//
// Replaces qpalette_tpu/kernels/fused.py::_arith_kernel in mode "sum2" on the
// dense even-KV layout (reached through tcq2_decode_matmul ->
// _arith_decode_matmul).  It computes the same function on the canonical
// trellis, not the TPU kernel's blocks:
//
//   for each 16x16 tile (index mt*(k/16)+kt, 4*KV words, circular stream)
//     state s = 16t+row (0..127) = 16-bit window at bit KV*s
//     h = u*34038481 + 76625530 mod 2^32, sb0..sb3 = signed bytes of h
//     y[n, row] += x[n, 2t]*(sb0+sb1) + x[n, 2t+1]*(sb2+sb3)
//   y *= 1/147.800537109375                       (f32 out, no Wscale)
//
// Variants: exact (x rounded to bf16, f32 accumulation) and a8 (x quantized
// to int8 inside the kernel per 512-column chunk, one absmax scale per chunk
// over all N rows as in the TPU kernel; one __dp4a(h, [q0,q0,q1,q1]) per
// weight pair into int32; each chunk descaled into f32).
//
// What bounds it: at bs=1 every weight is read once, KV/2 bits per weight of
// packed trellis, and decoding costs ~10 integer ops per weight pair, so the
// kernel is bound by the bytes of packed trellis streamed from device memory.
// Design: one block per 16-row m-tile (its tiles are contiguous in the
// canonical layout); the block walks k in 512-column chunks, copies each
// chunk's words to shared memory with 16-byte loads (the next chunk's load
// is loaded into registers before the current chunk is decoded), and its 8
// warps stride over the chunk's tiles.  Each lane decodes 4 of a tile's 128
// states, all of one output row, and keeps that row's sums in registers;
// rows are reduced through shared memory at the end.  Activations are
// handled in groups of 8 rows (weights are re-read once per group).
// wgmma, TMA and a Hopper weight layout are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;               // columns per chunk (a8 scale unit)
constexpr int kChunkTiles = kChunk / 16;  // k-tiles per chunk
constexpr int kMaxChunks = 64;            // k <= 32768
constexpr int kGroup = 8;                 // activation rows per pass
constexpr uint32_t kMadA = 34038481u;
constexpr uint32_t kMadB = 76625530u;
constexpr float kMadInv = (float)(1.0 / 147.800537109375);

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename XT, int KV, bool A8, int NG>
__global__ void __launch_bounds__(kThreads)
tcq2s_gemv_kernel(const XT* __restrict__ x, const int4* __restrict__ tr,
                  float* __restrict__ out, int N, int m, int k) {
  constexpr int W = 4 * KV;  // 32-bit words per tile
  __shared__ __align__(16) uint32_t ws[kChunkTiles * W];
  // exact: bf16-rounded activations; a8: packed int8 pairs [q0,q0,q1,q1]
  __shared__ __align__(16) float xs[kGroup * kChunk];
  __shared__ float sx[kMaxChunks];
  __shared__ float red[kWarps][NG][16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = blockIdx.x;
  const int kt_total = k >> 4;
  const int nch = (k + kChunk - 1) / kChunk;
  const int4* tr_row = tr + (size_t)mt * kt_total * KV;  // KV int4 per tile
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

  for (int g0 = 0; g0 < N; g0 += NG) {
    const int ng = min(NG, N - g0);
    float acc[NG];
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[n] = 0.f;

    int4 wreg = make_int4(0, 0, 0, 0);
    if (tid < min(kChunkTiles, kt_total) * KV) wreg = tr_row[tid];

    for (int c = 0; c < nch; ++c) {
      const int c0 = c * kChunk, cw = min(kChunk, k - c0), ntile = cw >> 4;
      if (tid < ntile * KV) reinterpret_cast<int4*>(ws)[tid] = wreg;
      if (A8) {
        const float inv = __fdiv_rn(1.0f, sx[c]);
        const int np = cw >> 1;
        for (int i = tid; i < NG * np; i += kThreads) {
          const int n = i / np, p = i - n * np;
          int v = 0;
          if (n < ng) {
            const XT* xp = x + (size_t)(g0 + n) * k + c0 + 2 * p;
            const uint32_t q0 = (uint32_t)__float2int_rn(__fmul_rn(load_x(xp), inv)) & 0xffu;
            const uint32_t q1 = (uint32_t)__float2int_rn(__fmul_rn(load_x(xp + 1), inv)) & 0xffu;
            v = (int)(q0 | (q0 << 8) | (q1 << 16) | (q1 << 24));
          }
          xq[n * (kChunk / 2) + p] = v;
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

      if (c + 1 < nch) {  // next chunk's words in flight during the decode
        const int nt1 = min(kChunkTiles, kt_total - (c + 1) * kChunkTiles);
        if (tid < nt1 * KV)
          wreg = tr_row[(size_t)(c + 1) * kChunkTiles * KV + tid];
      }

      int iacc[NG];
#pragma unroll
      for (int n = 0; n < NG; ++n) iacc[n] = 0;
      for (int j = warp; j < ntile; j += kWarps) {
        const uint32_t* wt = ws + j * W;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = lane + 32 * q;  // row = lane & 15, pair t = s >> 4
          const int t = s >> 4;
          const int off = KV * s;
          const int w0 = off >> 5, sh = off & 31;
          const int w1 = (w0 + 1 == W) ? 0 : w0 + 1;
          const uint32_t u = __funnelshift_r(wt[w0], wt[w1], sh) & 0xffffu;
          const uint32_t h = u * kMadA + kMadB;
          if (A8) {
            const int* xr = xq + j * 8 + t;
#pragma unroll
            for (int n = 0; n < NG; ++n)
              iacc[n] = __dp4a((int)h, xr[n * (kChunk / 2)], iacc[n]);
          } else {
            const float s01 = (float)((int)(int8_t)(h & 0xffu) +
                                      (int)(int8_t)((h >> 8) & 0xffu));
            const float s23 = (float)((int)(int8_t)((h >> 16) & 0xffu) +
                                      (int)(int8_t)(h >> 24));
            const float* xr = xs + j * 16 + 2 * t;
#pragma unroll
            for (int n = 0; n < NG; ++n) {
              acc[n] = fmaf(xr[n * kChunk], s01, acc[n]);
              acc[n] = fmaf(xr[n * kChunk + 1], s23, acc[n]);
            }
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
      for (int n = 0; n < NG; ++n) red[warp][n][lane] = acc[n];
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

template <typename XT, int KV, bool A8>
void launch(const void* x, const void* tr, float* out, int N, int m, int k,
            cudaStream_t st) {
  const dim3 grid(m / 16);
  const XT* xp = static_cast<const XT*>(x);
  const int4* tp = static_cast<const int4*>(tr);
  if (N == 1)
    tcq2s_gemv_kernel<XT, KV, A8, 1><<<grid, kThreads, 0, st>>>(xp, tp, out, N, m, k);
  else
    tcq2s_gemv_kernel<XT, KV, A8, kGroup><<<grid, kThreads, 0, st>>>(xp, tp, out, N, m, k);
}

template <typename XT, bool A8>
int launch_kv(const void* x, const void* tr, float* out, int N, int m, int k,
              int KV, cudaStream_t st) {
  switch (KV) {
    case 4: launch<XT, 4, A8>(x, tr, out, N, m, k, st); return 0;
    case 6: launch<XT, 6, A8>(x, tr, out, N, m, k, st); return 0;
    case 8: launch<XT, 8, A8>(x, tr, out, N, m, k, st); return 0;
    default: return 1;
  }
}

}  // namespace

// x: (N, k) float32 (x_bf16 == 0) or bfloat16; trellis: canonical (T, 4*KV)
// 32-bit words, 16-byte aligned; out: (N, m) float32.  Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int tcq2s_gemv(const void* x, int x_bf16, const void* trellis,
                          void* out, int N, int m, int k, int KV, int a8,
                          void* stream) {
  if (N < 1 || m <= 0 || k <= 0 || m % 16 || k % 16 ||
      k > kChunk * kMaxChunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  int bad;
  if (x_bf16)
    bad = a8 ? launch_kv<__nv_bfloat16, true>(x, trellis, o, N, m, k, KV, st)
             : launch_kv<__nv_bfloat16, false>(x, trellis, o, N, m, k, KV, st);
  else
    bad = a8 ? launch_kv<float, true>(x, trellis, o, N, m, k, KV, st)
             : launch_kv<float, false>(x, trellis, o, N, m, k, KV, st);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
