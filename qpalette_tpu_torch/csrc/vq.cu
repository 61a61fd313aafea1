// SQ/VQ row-pack decode for Hopper (sm_90a), plain C interface.
//
// Two kernels on one decoder, each computing what a TPU kernel of
// qpalette_tpu/kernels/fused.py computes, on the port's canonical row-pack:
//
//   vq_gemv     replaces _vq_kernel          (vq_decode_matmul)
//   vq_dequant  replaces _vq_dequant_kernel  (vq_dequant)
//
// The row-pack holds (m, W + 1) 32-bit words, W = P*bits/32 and P = k/vec
// indices a row: index p is the bits-bit window at bit p*bits of its row,
// LSB-first; it straddles two words whenever (p*bits mod 32) + bits > 32,
// and the trailing pad word keeps the last window's second word inside
// the row.  Index p selects row idx of the (2^bits, vec) float32 codebook,
// whose vec values land on columns p*vec .. p*vec + vec - 1 of W_hat.  The
// codebook is rounded to bf16 once per block, into shared memory (bf16 for
// vec 1, packed bf16x2 words for vec 2, component 0 in the low half), as the
// TPU kernel rounds every decoded value to bf16.  Lane l of a warp decodes
// positions l, l + 32, ... of a row, so the 32 windows a warp reads at once
// lie in bits*4 contiguous bytes (one or two sectors through L1) and its
// table reads go to 32 entries at random (bank conflicts at most; broadcast
// for small tables).
//
// GEMV (N <= 8 rows of bf16 x): y = x @ W_hat^T in float32, no Wscale.
// What bounds it: each weight is read once as bits/vec bits of row-pack and
// costs one table read and vec FMAs a row of x, so at bs=1 the row-pack
// bytes streamed from device memory, and at small m the latency.  Design:
// a warp owns one output row at a time (a capped grid, rows taken in a
// grid-stride loop, so the table is loaded once per block) and walks the
// whole row with no block barrier.  Lane l takes groups l, l + 32, ... of
// G = 32/gcd(bits, 32) positions, which fill bits*G/32 whole words: it
// loads those words once (__ldg) and cuts the G indices out with shifts
// that are compile-time constants, then reads x (all N rows, so each
// decoded weight is reused N times) through L1 as 8- or 16-byte pieces.
// Row sums stay in registers and are reduced once by warp shuffles.  (On
// an H100 a first design, x staged in shared memory per 512-column chunk
// with two barriers a chunk, ran at ~6% of the HBM rate; a second, one
// window and two 4-byte loads a position, was bound by the instructions
// it issued a weight.)
//
// Dequant: the row-pack -> bf16 W_hat (m, k), natural order.  What bounds
// it: 2 bytes written per weight against bits/(8*vec) read, so the bf16
// writes.  Design: a capped grid of blocks (the table is loaded once per
// block); each warp takes 256 columns of one row at a time, lane l the 8
// columns l*8 .. l*8 + 7, written as one 16-byte store: 512 contiguous
// bytes a warp.
//
// Staging the row-pack through shared memory with cp.async or TMA, several
// rows per lane at small m, and a tensor-core product fused with the
// dequant are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;    // GEMV activation rows
constexpr int kAlignPos = 128; // P must be a multiple of this
constexpr int kGemvBlocks = 1056;     // one wave of 8 per SM
constexpr int kDequantBlocks = 2112;  // two waves of 8 per SM

template <int VEC>
using Entry = typename std::conditional<VEC == 1, uint16_t, uint32_t>::type;

// (2^BITS, VEC) float32 codebook -> bf16 entries in shared memory
template <int BITS, int VEC>
__device__ __forceinline__ void load_table(const float* __restrict__ lut,
                                           Entry<VEC>* tab) {
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x) {
    if constexpr (VEC == 1) {
      tab[i] = __bfloat16_as_ushort(__float2bfloat16_rn(lut[i]));
    } else {
      const float2 v = reinterpret_cast<const float2*>(lut)[i];
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
      tab[i] = lo | (hi << 16);
    }
  }
}

// index p of the row whose words start at rw
template <int BITS>
__device__ __forceinline__ uint32_t index_at(const uint32_t* __restrict__ rw,
                                             int p) {
  const int o = p * BITS;
  const int w = o >> 5, sh = o & 31;
  const uint32_t lo = __ldg(rw + w), hi = __ldg(rw + w + 1);
  return __funnelshift_r(lo, hi, sh) & ((1u << BITS) - 1u);
}

__host__ __device__ constexpr int gcd(int a, int b) {
  return b ? gcd(b, a % b) : a;
}

// index q of a group whose words are w (q, and so every shift, is a
// compile-time constant once the caller's loops are unrolled)
template <int BITS, int WG>
__device__ __forceinline__ uint32_t group_index(const uint32_t (&w)[WG],
                                                int q) {
  const int o = q * BITS, j = o >> 5, sh = o & 31;
  uint32_t v = w[j] >> sh;
  if (sh + BITS > 32) v |= w[j + 1 < WG ? j + 1 : j] << (32 - sh);
  return v & ((1u << BITS) - 1u);
}

template <int BITS, int VEC, int NG>
__global__ void __launch_bounds__(kThreads)
vq_gemv_kernel(const __nv_bfloat16* __restrict__ x,
               const uint32_t* __restrict__ qw, const float* __restrict__ lut,
               float* __restrict__ out, int N, int m, int k, int ldw) {
  // a lane's group: G positions filling WG whole words
  constexpr int G = 32 / gcd(BITS, 32), WG = G * BITS / 32;
  static_assert(G % 4 == 0, "x is read 4 positions at a time");
  __shared__ Entry<VEC> tab[1 << BITS];
  load_table<BITS, VEC>(lut, tab);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ngroups = k / VEC / G;  // P is a multiple of 128, so of G
  const auto* xh = reinterpret_cast<const uint16_t*>(x);
  for (int row = blockIdx.x * kWarps + warp; row < m;
       row += gridDim.x * kWarps) {
    const uint32_t* rw = qw + (size_t)row * ldw;
    float acc[NG];
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[n] = 0.f;
    for (int gi = lane; gi < ngroups; gi += 32) {
      uint32_t w[WG];
#pragma unroll
      for (int j = 0; j < WG; ++j) w[j] = __ldg(rw + (size_t)gi * WG + j);
      const int p0 = gi * G;
#pragma unroll
      for (int b = 0; b < G / 4; ++b) {
        uint32_t e[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          e[t] = tab[group_index<BITS, WG>(w, 4 * b + t)];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          // rows of x past N are read from row 0 and never stored
          const size_t xo = (size_t)(n < N ? n : 0) * k;
          if constexpr (VEC == 1) {
            // 4 bf16 of x, one a position
            const uint2 xv =
                __ldg(reinterpret_cast<const uint2*>(xh + xo + p0) + b);
            const uint32_t xs[2] = {xv.x, xv.y};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const uint32_t xw = xs[t >> 1];
              const float xf = __uint_as_float((t & 1) ? xw & 0xffff0000u
                                                       : xw << 16);
              acc[n] = fmaf(xf, __uint_as_float(e[t] << 16), acc[n]);
            }
          } else {
            // 8 bf16 of x, a pair a position
            const uint4 xv =
                __ldg(reinterpret_cast<const uint4*>(xh + xo + 2 * p0) + b);
            const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              acc[n] = fmaf(__uint_as_float(xs[t] << 16),
                            __uint_as_float(e[t] << 16), acc[n]);
              acc[n] = fmaf(__uint_as_float(xs[t] & 0xffff0000u),
                            __uint_as_float(e[t] & 0xffff0000u), acc[n]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      float v = acc[n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && n < N) out[(size_t)n * m + row] = v;
    }
  }
}

template <int BITS, int VEC>
__global__ void __launch_bounds__(kThreads)
vq_dequant_kernel(const uint32_t* __restrict__ qw,
                  const float* __restrict__ lut,
                  __nv_bfloat16* __restrict__ w, int m, int k, int ldw) {
  constexpr int kCols = 8;                 // columns a lane: 16 bytes
  constexpr int kPos = kCols / VEC;        // positions a lane
  constexpr int kSeg = 32 * kCols;         // columns a warp step
  __shared__ Entry<VEC> tab[1 << BITS];
  load_table<BITS, VEC>(lut, tab);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = (k + kSeg - 1) / kSeg;
  const long long total = (long long)m * segs;
  for (long long t = (long long)blockIdx.x * kWarps + warp; t < total;
       t += (long long)gridDim.x * kWarps) {
    const int row = (int)(t / segs);
    const int col0 = (int)(t - (long long)row * segs) * kSeg + lane * kCols;
    if (col0 >= k) continue;  // k is a multiple of 128: whole lanes only
    const uint32_t* rw = qw + (size_t)row * ldw;
    const int p0 = col0 / VEC;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (VEC == 1) {
        v[q] = (uint32_t)tab[index_at<BITS>(rw, p0 + 2 * q)] |
               ((uint32_t)tab[index_at<BITS>(rw, p0 + 2 * q + 1)] << 16);
      } else {
        v[q] = tab[index_at<BITS>(rw, p0 + q)];
      }
    }
    static_assert(kPos * VEC == kCols, "a lane writes 8 columns");
    *reinterpret_cast<uint4*>(w + (size_t)row * k + col0) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int BITS, int VEC>
int gemv(const void* x, const void* qw, const void* lut, void* out, int N,
         int m, int k, int ldw, cudaStream_t st) {
  const int need = (m + kWarps - 1) / kWarps;
  const dim3 grid(need < kGemvBlocks ? need : kGemvBlocks);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const uint32_t*>(qw);
  const auto* l = static_cast<const float*>(lut);
  float* o = static_cast<float*>(out);
  if (N == 1)
    vq_gemv_kernel<BITS, VEC, 1><<<grid, kThreads, 0, st>>>(xp, q, l, o, N,
                                                            m, k, ldw);
  else
    vq_gemv_kernel<BITS, VEC, kMaxRows><<<grid, kThreads, 0, st>>>(
        xp, q, l, o, N, m, k, ldw);
  return (int)cudaGetLastError();
}

template <int BITS, int VEC>
int dequant(const void* qw, const void* lut, void* w, int m, int k, int ldw,
            cudaStream_t st) {
  const long long total = (long long)m * ((k + 255) / 256);
  const long long need = (total + kWarps - 1) / kWarps;
  const int grid = (int)(need < kDequantBlocks ? need : kDequantBlocks);
  vq_dequant_kernel<BITS, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(qw), static_cast<const float*>(lut),
      static_cast<__nv_bfloat16*>(w), m, k, ldw);
  return (int)cudaGetLastError();
}

// words a row, pad word included; 0 for shapes the kernels do not take
int row_words(int m, int k, int bits, int vec) {
  if (m <= 0 || k <= 0 || (vec != 1 && vec != 2) || k % vec) return 0;
  const int P = k / vec;
  if (P % kAlignPos) return 0;
  return P / 32 * bits + 1;
}

}  // namespace

// The 17 (bits, vec) pairs of the ldlq palette: vec 1 with bits 2..8, vec 2
// with bits 3..12.
#define QPT_VQ_CASES(FN, ...)                            \
  switch (vec * 16 + bits) {                             \
    case 16 + 2: return FN<2, 1>(__VA_ARGS__);           \
    case 16 + 3: return FN<3, 1>(__VA_ARGS__);           \
    case 16 + 4: return FN<4, 1>(__VA_ARGS__);           \
    case 16 + 5: return FN<5, 1>(__VA_ARGS__);           \
    case 16 + 6: return FN<6, 1>(__VA_ARGS__);           \
    case 16 + 7: return FN<7, 1>(__VA_ARGS__);           \
    case 16 + 8: return FN<8, 1>(__VA_ARGS__);           \
    case 32 + 3: return FN<3, 2>(__VA_ARGS__);           \
    case 32 + 4: return FN<4, 2>(__VA_ARGS__);           \
    case 32 + 5: return FN<5, 2>(__VA_ARGS__);           \
    case 32 + 6: return FN<6, 2>(__VA_ARGS__);           \
    case 32 + 7: return FN<7, 2>(__VA_ARGS__);           \
    case 32 + 8: return FN<8, 2>(__VA_ARGS__);           \
    case 32 + 9: return FN<9, 2>(__VA_ARGS__);           \
    case 32 + 10: return FN<10, 2>(__VA_ARGS__);         \
    case 32 + 11: return FN<11, 2>(__VA_ARGS__);         \
    case 32 + 12: return FN<12, 2>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidValue;          \
  }

// x: (N, k) bfloat16, 1 <= N <= 8; qweight: the canonical row-pack
// (m, P*bits/32 + 1) words, P = k/vec a multiple of 128; lut: (2^bits,
// vec) float32, 8-byte aligned; out: (N, m) float32.  Each function
// launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int vq_gemv(const void* x, const void* qweight, const void* lut,
                       void* out, int N, int m, int k, int bits, int vec,
                       void* stream) {
  const int ldw = row_words(m, k, bits, vec);
  if (!ldw || N < 1 || N > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_VQ_CASES(gemv, x, qweight, lut, out, N, m, k, ldw, st)
}

// w: (m, k) bfloat16, 16-byte aligned, W_hat in natural order.
extern "C" int vq_dequant(const void* qweight, const void* lut, void* w,
                          int m, int k, int bits, int vec, void* stream) {
  const int ldw = row_words(m, k, bits, vec);
  if (!ldw) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_VQ_CASES(dequant, qweight, lut, w, m, k, ldw, st)
}
