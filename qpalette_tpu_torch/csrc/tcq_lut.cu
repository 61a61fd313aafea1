// LUT trellis (quantlut_sym) decode for Hopper (sm_90a), plain C interface.
//
// Four kernels on one decoder, each computing what a TPU kernel of
// qpalette_tpu/kernels/fused.py computes, on the port's canonical trellis
// (T, 4*KV) 32-bit words, T = (m/16)*(k/16) tiles in tile-row-major order:
//
//   tcq_lut_gemv      replaces _tcq_kernel            (tcq_decode_matmul)
//   tcomb_lut_gemv    replaces _tcomb_kernel          (tcomb_decode_matmul)
//   tcq_lut_dequant   replaces _tcq_dequant_kernel    (tcq_dequant)
//   tcomb_lut_dequant replaces _tcomb_dequant_kernel  (tcomb_dequant)
//
// The decoder (fused.py::_tcq_decode_tiles): state s (0..127) of a tile is
// the 16-bit window u at bit KV*s of the tile's circular 128*KV-bit stream;
// h = u*(u+1) mod 2^32; bits [15-S, 15) of h index the (2^S, 2) table, bit
// 15 flips the sign of component 0; both values are rounded to bf16.  State
// s = 8*row + t holds weights (row, 2t) and (row, 2t+1) of its 16x16 tile
// (m-major, not tcq2's paired-K-major order).  The table is rounded to bf16
// once, into shared memory, as packed bf16x2 words (component 0 in the low
// half), so a decoded pair is one gather and the sign flip one XOR of bit
// 15.
//
// GEMV (N <= 8 rows of bf16 x): y = x @ W_hat^T in float32, no Wscale.
// What bounds it: at bs=1 each weight is read once as KV/2 bits of packed
// trellis, and decoding costs one shared-memory table gather plus ~8
// integer ops per weight pair, so the kernel is bound by the trellis bytes
// streamed from device memory and, at small m, by latency.  Design (as the
// tcq2s kernel): one block per 16-row m-tile, whose k-tiles are contiguous;
// the block walks k in 512-column chunks, copies each chunk's words to
// shared memory with 16-byte loads (the next chunk's words are loaded into
// registers while the current chunk is decoded), and its 8 warps stride
// over the chunk's tiles.  Lane l decodes states 8*(l%16) + 4*(l/16) + q,
// q < 4, all of output row l%16, so row sums stay in registers and are
// reduced once through shared memory.  tcomb runs both halves in one
// launch: KV1 tiles on columns [0, k/2), then KV2 tiles on [k/2, k), each
// read from its own canonical array (no pad words).
//
// Dequant: the trellis -> bf16 W_hat (m, k), natural order.  What bounds
// it: 2 bytes written per weight against KV/16 bytes read, so the bf16
// writes, and how whole the written lines are.  Design: a capped grid of
// blocks (the table is loaded once per block); each warp takes 4 adjacent
// tiles of one m-tile at a time, a 16 x 64 block of W_hat, and its 8 lanes
// of a row write that row's 128 contiguous bytes as 16-byte stores.  (On an
// H100, one tile per warp writing 32-byte row pieces took 3-4x as long.)
//
// wgmma, TMA, a bank-conflict-free table layout and a Hopper weight layout
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;               // columns per chunk
constexpr int kChunkTiles = kChunk / 16;  // k-tiles per chunk
constexpr int kMaxRows = 8;               // GEMV activation rows
constexpr int kMaxTlutBits = 11;
constexpr int kDequantBlocks = 2112;      // two waves of 8 per SM

// (2^S, 2) float32 table -> 2^S bf16x2 words in shared memory
__device__ __forceinline__ void load_table(const float2* __restrict__ tlut,
                                           int S, uint32_t* tab) {
  for (int i = threadIdx.x; i < (1 << S); i += blockDim.x) {
    const float2 v = tlut[i];
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
    tab[i] = lo | (hi << 16);
  }
}

// state s of the tile whose 4*KV words are wt -> its bf16x2 weight pair
template <int KV>
__device__ __forceinline__ uint32_t decode_state(const uint32_t* wt, int s,
                                                 const uint32_t* tab, int S) {
  constexpr int W = 4 * KV;
  const int off = KV * s;
  const int w0 = off >> 5, sh = off & 31;
  const int w1 = (w0 + 1 == W) ? 0 : w0 + 1;  // the stream is circular
  const uint32_t u = __funnelshift_r(wt[w0], wt[w1], sh) & 0xffffu;
  const uint32_t h = u * (u + 1u);
  const uint32_t e = tab[(h >> (15 - S)) & ((1u << S) - 1u)];
  return e ^ (h & 0x8000u);  // bit 15 of h: sign of component 0
}

// Accumulate nkt k-tiles of one m-tile (words from tr_row, KV int4 per
// tile) against x columns [col0, col0 + 16*nkt) into acc.
template <int KV, int NG>
__device__ __forceinline__ void gemv_part(
    const __nv_bfloat16* __restrict__ x, int N, int k, int col0,
    const int4* __restrict__ tr_row, int nkt, const uint32_t* tab, int S,
    uint32_t* ws, float* xs, float (&acc)[NG]) {
  constexpr int W = 4 * KV;
  constexpr int kLoads = (kChunkTiles * KV + kThreads - 1) / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = lane & 15, tbase = (lane >> 4) * 4;
  const int nch = (nkt + kChunkTiles - 1) / kChunkTiles;

  int4 wreg[kLoads];
  auto fetch = [&](int c) {
    const int nvec = min(kChunkTiles, nkt - c * kChunkTiles) * KV;
    const int4* src = tr_row + (size_t)c * kChunkTiles * KV;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kThreads;
      if (i < nvec) wreg[l] = src[i];
    }
  };
  fetch(0);

  for (int c = 0; c < nch; ++c) {
    const int ntile = min(kChunkTiles, nkt - c * kChunkTiles);
    const int cw = ntile * 16;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kThreads;
      if (i < ntile * KV) reinterpret_cast<int4*>(ws)[i] = wreg[l];
    }
    const __nv_bfloat16* xc = x + col0 + c * kChunk;
#pragma unroll
    for (int n = 0; n < NG; ++n)
      for (int col = tid; col < cw; col += kThreads)
        xs[n * kChunk + col] =
            n < N ? __bfloat162float(xc[(size_t)n * k + col]) : 0.f;
    __syncthreads();

    if (c + 1 < nch) fetch(c + 1);  // in flight during the decode

    for (int j = warp; j < ntile; j += kWarps) {
      const uint32_t* wt = ws + j * W;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = tbase + q;
        const uint32_t e = decode_state<KV>(wt, 8 * row + t, tab, S);
        const float w0 = __uint_as_float(e << 16);
        const float w1 = __uint_as_float(e & 0xffff0000u);
        const float* xr = xs + j * 16 + 2 * t;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          acc[n] = fmaf(xr[n * kChunk], w0, acc[n]);
          acc[n] = fmaf(xr[n * kChunk + 1], w1, acc[n]);
        }
      }
    }
    __syncthreads();  // ws / xs are overwritten by the next chunk
  }
}

// lanes l and l^16 hold the same row; then sum the warps' partials
template <int NG>
__device__ __forceinline__ void reduce_store(float (&acc)[NG],
                                             float (*red)[NG][16],
                                             float* __restrict__ out, int N,
                                             int m, int mt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int n = 0; n < NG; ++n)
    acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], 16);
  if (lane < 16) {
#pragma unroll
    for (int n = 0; n < NG; ++n) red[warp][n][lane] = acc[n];
  }
  __syncthreads();
  for (int i = tid; i < N * 16; i += kThreads) {
    const int n = i >> 4, r = i & 15;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][n][r];
    out[(size_t)n * m + mt * 16 + r] = v;
  }
}

// tcq: KV1 == KV2 and kt2 == 0; tcomb: KV1 tiles on columns [0, 16*kt1),
// KV2 tiles on [16*kt1, k).
template <int KV1, int KV2, int NG>
__global__ void __launch_bounds__(kThreads)
lut_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const int4* __restrict__ tr1, const int4* __restrict__ tr2,
                const float2* __restrict__ tlut, int S,
                float* __restrict__ out, int N, int m, int k, int kt1,
                int kt2) {
  constexpr int KVM = KV1 > KV2 ? KV1 : KV2;
  __shared__ uint32_t tab[1 << kMaxTlutBits];
  __shared__ __align__(16) uint32_t ws[kChunkTiles * 4 * KVM];
  __shared__ float xs[NG * kChunk];
  __shared__ float red[kWarps][NG][16];
  load_table(tlut, S, tab);  // visible after the first chunk's barrier
  const int mt = blockIdx.x;
  float acc[NG];
#pragma unroll
  for (int n = 0; n < NG; ++n) acc[n] = 0.f;
  gemv_part<KV1, NG>(x, N, k, 0, tr1 + (size_t)mt * kt1 * KV1, kt1, tab, S,
                     ws, xs, acc);
  if (kt2)
    gemv_part<KV2, NG>(x, N, k, 16 * kt1, tr2 + (size_t)mt * kt2 * KV2, kt2,
                       tab, S, ws, xs, acc);
  reduce_store<NG>(acc, red, out, N, m, mt);
}

// Up to 4 adjacent k-tiles of one m-tile (a 16 x 64 block of W_hat): lane
// l decodes the 4 states of tile (l/2)%4 that cover 8 columns of row
// 4*rg + l/8, so the 8 lanes of a row write 128 contiguous bytes.
template <int KV>
__device__ __forceinline__ void dequant_group(
    const uint32_t* __restrict__ tiles, int ntile, uint32_t* wsw,
    const uint32_t* tab, int S, __nv_bfloat16* __restrict__ wo, int k) {
  constexpr int W = 4 * KV;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < ntile * W; i += 32) wsw[i] = tiles[i];
  __syncwarp();
  const int tl = (lane >> 1) & 3, t0 = (lane & 1) * 4;
  if (tl < ntile) {
    const uint32_t* wt = wsw + tl * W;
#pragma unroll
    for (int rg = 0; rg < 4; ++rg) {
      const int row = rg * 4 + (lane >> 3);
      uint4 e;
      e.x = decode_state<KV>(wt, 8 * row + t0, tab, S);
      e.y = decode_state<KV>(wt, 8 * row + t0 + 1, tab, S);
      e.z = decode_state<KV>(wt, 8 * row + t0 + 2, tab, S);
      e.w = decode_state<KV>(wt, 8 * row + t0 + 3, tab, S);
      *reinterpret_cast<uint4*>(wo + (size_t)row * k + tl * 16 + 2 * t0) = e;
    }
  }
  __syncwarp();  // wsw is overwritten by the warp's next group
}

template <int KV1, int KV2>
__global__ void __launch_bounds__(kThreads)
lut_dequant_kernel(const uint32_t* __restrict__ tr1,
                   const uint32_t* __restrict__ tr2,
                   const float2* __restrict__ tlut, int S,
                   __nv_bfloat16* __restrict__ w, int m, int k, int kt1,
                   int kt2) {
  constexpr int KVM = KV1 > KV2 ? KV1 : KV2;
  __shared__ uint32_t tab[1 << kMaxTlutBits];
  __shared__ uint32_t wsm[kWarps][4 * 4 * KVM];
  load_table(tlut, S, tab);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int g1 = (kt1 + 3) / 4, gr = g1 + (kt2 + 3) / 4;  // groups a row
  const long long total = (long long)(m >> 4) * gr;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < total;
       g += (long long)gridDim.x * kWarps) {
    const int mt = (int)(g / gr), q = (int)(g - (long long)mt * gr);
    __nv_bfloat16* wrow = w + (size_t)mt * 16 * k;
    if (q < g1) {
      const int j0 = 4 * q;
      dequant_group<KV1>(tr1 + ((size_t)mt * kt1 + j0) * 4 * KV1,
                         min(4, kt1 - j0), wsm[warp], tab, S,
                         wrow + j0 * 16, k);
    } else {
      const int j0 = 4 * (q - g1);
      dequant_group<KV2>(tr2 + ((size_t)mt * kt2 + j0) * 4 * KV2,
                         min(4, kt2 - j0), wsm[warp], tab, S,
                         wrow + (kt1 + j0) * 16, k);
    }
  }
}

template <int KV1, int KV2>
int gemv(const void* x, const void* tr1, const void* tr2, const void* tlut,
         int S, void* out, int N, int m, int k, int kt1, int kt2,
         cudaStream_t st) {
  const dim3 grid(m / 16);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* t1 = static_cast<const int4*>(tr1);
  const auto* t2 = static_cast<const int4*>(tr2);
  const auto* tl = static_cast<const float2*>(tlut);
  float* o = static_cast<float*>(out);
  if (N == 1)
    lut_gemv_kernel<KV1, KV2, 1><<<grid, kThreads, 0, st>>>(
        xp, t1, t2, tl, S, o, N, m, k, kt1, kt2);
  else
    lut_gemv_kernel<KV1, KV2, kMaxRows><<<grid, kThreads, 0, st>>>(
        xp, t1, t2, tl, S, o, N, m, k, kt1, kt2);
  return (int)cudaGetLastError();
}

template <int KV1, int KV2>
int dequant(const void* tr1, const void* tr2, const void* tlut, int S,
            void* w, int m, int k, int kt1, int kt2, cudaStream_t st) {
  const long long groups = (kt1 + 3) / 4 + (kt2 + 3) / 4;
  const long long total = (long long)(m / 16) * groups;
  const long long need = (total + kWarps - 1) / kWarps;
  const int grid = (int)(need < kDequantBlocks ? need : kDequantBlocks);
  lut_dequant_kernel<KV1, KV2><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(tr1), static_cast<const uint32_t*>(tr2),
      static_cast<const float2*>(tlut), S, static_cast<__nv_bfloat16*>(w),
      m, k, kt1, kt2);
  return (int)cudaGetLastError();
}

bool bad_args(int m, int k, int S) {
  return m <= 0 || k <= 0 || m % 16 || k % 16 || S < 1 || S > kMaxTlutBits;
}

}  // namespace

#define QPT_TCQ_CASES(FN, ...)                            \
  switch (KV) {                                           \
    case 3: return FN<3, 3>(__VA_ARGS__);                 \
    case 4: return FN<4, 4>(__VA_ARGS__);                 \
    case 5: return FN<5, 5>(__VA_ARGS__);                 \
    case 6: return FN<6, 6>(__VA_ARGS__);                 \
    case 7: return FN<7, 7>(__VA_ARGS__);                 \
    case 8: return FN<8, 8>(__VA_ARGS__);                 \
    case 9: return FN<9, 9>(__VA_ARGS__);                 \
    case 10: return FN<10, 10>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;           \
  }

#define QPT_TCOMB_CASES(FN, ...)                          \
  if (KV2 != KV1 + 1) return (int)cudaErrorInvalidValue;  \
  switch (KV1) {                                          \
    case 3: return FN<3, 4>(__VA_ARGS__);                 \
    case 4: return FN<4, 5>(__VA_ARGS__);                 \
    case 5: return FN<5, 6>(__VA_ARGS__);                 \
    case 6: return FN<6, 7>(__VA_ARGS__);                 \
    case 7: return FN<7, 8>(__VA_ARGS__);                 \
    case 8: return FN<8, 9>(__VA_ARGS__);                 \
    case 9: return FN<9, 10>(__VA_ARGS__);                \
    default: return (int)cudaErrorInvalidValue;           \
  }

// x: (N, k) bfloat16, 1 <= N <= 8; trellis: canonical (m/16*k/16, 4*KV)
// words, 16-byte aligned; tlut: (2^S, 2) float32; out: (N, m) float32.
// Each function launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int tcq_lut_gemv(const void* x, const void* trellis,
                            const void* tlut, int S, void* out, int N, int m,
                            int k, int KV, void* stream) {
  if (bad_args(m, k, S) || N < 1 || N > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_TCQ_CASES(gemv, x, trellis, trellis, tlut, S, out, N, m, k, k / 16, 0,
                st)
}

// tcomb: trellis1 (m/16*k/32, 4*KV1) on columns [0, k/2), trellis2
// (m/16*k/32, 4*KV2) on [k/2, k); KV2 == KV1 + 1.
extern "C" int tcomb_lut_gemv(const void* x, const void* trellis1,
                              const void* trellis2, const void* tlut, int S,
                              void* out, int N, int m, int k, int KV1,
                              int KV2, void* stream) {
  if (bad_args(m, k, S) || k % 32 || N < 1 || N > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_TCOMB_CASES(gemv, x, trellis1, trellis2, tlut, S, out, N, m, k, k / 32,
                  k / 32, st)
}

// w: (m, k) bfloat16, 16-byte aligned, W_hat in natural order.
extern "C" int tcq_lut_dequant(const void* trellis, const void* tlut, int S,
                               void* w, int m, int k, int KV, void* stream) {
  if (bad_args(m, k, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_TCQ_CASES(dequant, trellis, trellis, tlut, S, w, m, k, k / 16, 0, st)
}

extern "C" int tcomb_lut_dequant(const void* trellis1, const void* trellis2,
                                 const void* tlut, int S, void* w, int m,
                                 int k, int KV1, int KV2, void* stream) {
  if (bad_args(m, k, S) || k % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_TCOMB_CASES(dequant, trellis1, trellis2, tlut, S, w, m, k, k / 32,
                  k / 32, st)
}
