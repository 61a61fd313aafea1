// int8 lm_head GEMVs for Hopper (sm_90a), plain C interface.
//
//   int8_gemv_a8  replaces qpalette_tpu/kernels/fused.py::_i8gemv_a8_kernel
//                 (int8_gemv_a8: the rotated int8 head)
//   int8_gemv     replaces fused.py::_i8gemv_kernel (int8_gemv: the same
//                 head without the rotation)
//
// The port's weight layout is its own: (m, k) row-major int8, one
// contiguous k-byte row an output (the vocab padded to a multiple of
// 2048), and float32 scales (m,).  (The TPU's (k, m) layout puts the
// vocab in lanes; it has no use here.)
//
// int8_gemv_a8, exactly as fused.py:1430-1433 and :1460: x is quantized to
// int8 with ONE absmax over all its rows, sx = max|x|/127 + 1e-30,
// xq = round-half-even(x / sx) (a division, not a multiply by the
// reciprocal); then an int8 x int8 -> int32 dot by __dp4a, and
// y = float(acc) * (scales * sx).  The quantization is a small kernel of
// its own (one block; xq and sx go to a scratch buffer the wrapper
// allocates), so the GEMV blocks do not each recompute the absmax.
//
// int8_gemv: int8 -> float (exact, as int8 -> bf16 is), float32 FMAs
// against bf16 x, then y = acc * scales.
//
// What bounds both at N <= 8: the int8 weight bytes streamed from device
// memory (528 MB for Llama-3.1-8B's 129024 x 4096 padded head).  Design: a
// block of 8 warps owns 32 rows (4 a warp) and walks k in 2048-column
// chunks; each chunk of x (int8 or bf16, all N rows) is staged in shared
// memory; lane l reads 16-byte pieces l, l + 32, ... of a row, so a warp
// reads 512 contiguous bytes at a time, and the 4 rows' loads of a chunk
// are in flight together.  Row sums are reduced by warp shuffles.
//
// cp.async / TMA staging of the weight stream and a split over k at small
// m are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 2048;        // columns of x staged per step
constexpr int kPieces = kChunk / 16;  // 16-byte pieces of a row a chunk
constexpr int kMaxRows = 8;         // activation rows
constexpr int kQuantThreads = 1024;

// sx = max|x| / 127 + 1e-30 over all N*k values; xq = rint(x / sx)
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ x, int n,
                int8_t* __restrict__ xq, float* __restrict__ sx_out) {
  __shared__ float red[kQuantThreads / 32];
  __shared__ float sx_s;
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(__bfloat162float(x[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red[0];
    for (int w = 1; w < kQuantThreads / 32; ++w) a = fmaxf(a, red[w]);
    sx_s = __fadd_rn(__fdiv_rn(a, 127.0f), 1e-30f);
    *sx_out = sx_s;
  }
  __syncthreads();
  const float sx = sx_s;
  for (int i = threadIdx.x; i < n; i += kQuantThreads)
    xq[i] = (int8_t)__float2int_rn(__fdiv_rn(__bfloat162float(x[i]), sx));
}

// A8: xs holds int8 x, acc is int32; otherwise bf16 x and float32.
template <bool A8, int NG>
__global__ void __launch_bounds__(kThreads)
i8gemv_kernel(const void* __restrict__ xin, const int4* __restrict__ wq,
              const float* __restrict__ scales, const float* __restrict__ sxp,
              float* __restrict__ out, int N, int m, int k) {
  using Acc = typename std::conditional<A8, int, float>::type;
  constexpr int kXBytes = A8 ? 1 : 2;
  __shared__ __align__(16) uint8_t xs[NG][kChunk * kXBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int kp = k / 16;  // 16-byte pieces a row
  Acc acc[kRowsPerWarp][NG];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[r][n] = 0;

  for (int c0 = 0; c0 < kp; c0 += kPieces) {
    const int np = min(kPieces, kp - c0);
    __syncthreads();  // the previous chunk's xs reads are done
    const int per = np * 16 * kXBytes / 16;  // int4 of x a row this chunk
#pragma unroll
    for (int n = 0; n < NG; ++n)
      for (int i = threadIdx.x; i < per; i += kThreads)
        reinterpret_cast<int4*>(xs[n])[i] =
            n < N ? reinterpret_cast<const int4*>(
                        static_cast<const uint8_t*>(xin) +
                        ((size_t)n * k + (size_t)c0 * 16) * kXBytes)[i]
                  : make_int4(0, 0, 0, 0);
    __syncthreads();
    for (int pc = lane; pc < np; pc += 32) {
      int4 wv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = min(row0 + r, m - 1);  // rows past m: discarded
        wv[r] = __ldg(wq + (size_t)row * kp + c0 + pc);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        if constexpr (A8) {
          const int4 xv = reinterpret_cast<const int4*>(xs[n])[pc];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            acc[r][n] = __dp4a(wv[r].x, xv.x, acc[r][n]);
            acc[r][n] = __dp4a(wv[r].y, xv.y, acc[r][n]);
            acc[r][n] = __dp4a(wv[r].z, xv.z, acc[r][n]);
            acc[r][n] = __dp4a(wv[r].w, xv.w, acc[r][n]);
          }
        } else {
          const int4* xp = reinterpret_cast<const int4*>(xs[n]) + 2 * pc;
          const int4 xa = xp[0], xb = xp[1];
          const uint32_t xw[8] = {(uint32_t)xa.x, (uint32_t)xa.y,
                                  (uint32_t)xa.z, (uint32_t)xa.w,
                                  (uint32_t)xb.x, (uint32_t)xb.y,
                                  (uint32_t)xb.z, (uint32_t)xb.w};
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const uint32_t ww[4] = {(uint32_t)wv[r].x, (uint32_t)wv[r].y,
                                    (uint32_t)wv[r].z, (uint32_t)wv[r].w};
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float xf = __uint_as_float(
                  (j & 1) ? (xw[j >> 1] & 0xffff0000u) : (xw[j >> 1] << 16));
              const float wf =
                  (float)(int8_t)((ww[j >> 2] >> (8 * (j & 3))) & 0xffu);
              acc[r][n] = fmaf(xf, wf, acc[r][n]);
            }
          }
        }
      }
    }
  }

  float sx = 1.f;
  if constexpr (A8) sx = *sxp;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      Acc v = acc[r][n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && row < m && n < N) {
        float y;
        if constexpr (A8)
          y = __fmul_rn(__int2float_rn(v), __fmul_rn(scales[row], sx));
        else
          y = __fmul_rn(v, scales[row]);
        out[(size_t)n * m + row] = y;
      }
    }
  }
}

template <bool A8>
int launch(const void* x, const void* wq, const void* scales, const void* sx,
           void* out, int N, int m, int k, cudaStream_t st) {
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock);
  const auto* w = static_cast<const int4*>(wq);
  const auto* s = static_cast<const float*>(scales);
  const auto* sxp = static_cast<const float*>(sx);
  float* o = static_cast<float*>(out);
  if (N == 1)
    i8gemv_kernel<A8, 1><<<grid, kThreads, 0, st>>>(x, w, s, sxp, o, N, m,
                                                    k);
  else
    i8gemv_kernel<A8, kMaxRows><<<grid, kThreads, 0, st>>>(x, w, s, sxp, o,
                                                           N, m, k);
  return (int)cudaGetLastError();
}

bool bad_args(int N, int m, int k) {
  return N < 1 || N > kMaxRows || m <= 0 || k <= 0 || k % 16;
}

}  // namespace

// x: (N, k) bfloat16, 1 <= N <= 8, 16-byte aligned; wq: (m, k) int8,
// 16-byte aligned, k a multiple of 16; scales: (m,) float32; out: (N, m)
// float32.  int8_gemv_a8 also takes the scratch xq (N, k) int8, 16-byte
// aligned, and sx (1,) float32, which it overwrites.  Each function
// launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int int8_gemv_a8(const void* x, const void* wq, const void* scales,
                            void* xq, void* sx, void* out, int N, int m,
                            int k, void* stream) {
  if (bad_args(N, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quantize_kernel<<<1, kQuantThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), N * k,
      static_cast<int8_t*>(xq), static_cast<float*>(sx));
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch<true>(xq, wq, scales, sx, out, N, m, k, st);
}

extern "C" int int8_gemv(const void* x, const void* wq, const void* scales,
                         void* out, int N, int m, int k, void* stream) {
  if (bad_args(N, m, k)) return (int)cudaErrorInvalidValue;
  return launch<false>(x, wq, scales, nullptr, out, N, m, k,
                       static_cast<cudaStream_t>(stream));
}
