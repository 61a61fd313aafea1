// Arithmetic trellis -> bf16 W_hat (m, k), natural order, for Hopper
// (sm_90a), plain C interface.
//
//   tcq2_dequant  replaces qpalette_tpu/kernels/fused.py::_tcq2_dequant_kernel
//                 (tcq2_dequant; modes sum2 and dualmad, V=2)      K2
//   tcq1_dequant  replaces fused.py::_tcq1_dequant_kernel
//                 (tcq1_dequant; modes 1mad and 2mad, V=1)         K3
//
// Each weight is its integer value (decoder in arith.cuh) times
// 1/147.800537109375 in float32, rounded to bf16, as the TPU kernels'
// bf16 output is.  The TPU kernels write W_hat^T in a permuted kernel
// order that their product absorbs; these write W_hat in natural order.
//
// What bounds it: 2 bytes written per weight against KV/(8V) bytes read,
// so the bf16 writes, and how whole the written lines are.  Design (as the
// LUT trellis dequant in tcq_lut.cu): a capped grid of blocks; each warp
// takes 4 adjacent k-tiles of one m-tile at a time, a 16 x 64 block of
// W_hat, copies their words to shared memory, and its 8 lanes of a row
// write that row's 128 contiguous bytes as 16-byte stores.  Lane l covers
// columns 8*(l%2) .. +8 of tile (l/2)%4 in rows 4*rg + l/8: four V=2
// states (16t + row, t = 4*(l%2) .. +4) or eight V=1 states
// (16*col + row).
//
// The palette's KVs have an instance each (KV a compile-time constant);
// every other KV from 1 to 16 runs the instance KV = 0, which reads the KV
// of its launch, so the kernels take every KV the reference's dequant
// kernels take.

#include "arith.cuh"

using namespace qpt;

namespace {

constexpr int kDequantBlocks = 2112;  // two waves of 8 per SM
constexpr int kMaxKV = 16;            // the 16-bit state's largest step

__device__ __forceinline__ uint32_t bf16_bits(int w) {
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(__fmul_rn((float)w, kMadInv)));
}

// state s of a tile: state_at with KV_ a compile-time constant, else the
// same window at the launch's kv (W words a tile)
template <int KV_, int W_>
__device__ __forceinline__ uint32_t state_of(const uint32_t* wt, int s,
                                             int kv, int W) {
  if constexpr (KV_ != 0) {
    return state_at<KV_, W_>(wt, s);
  } else {
    const int off = kv * s;
    const int w0 = off >> 5, sh = off & 31;
    const int w1 = (w0 + 1 == W) ? 0 : w0 + 1;  // the stream is circular
    return __funnelshift_r(wt[w0], wt[w1], sh) & 0xffffu;
  }
}

// KV_ = 0: the instance of every KV outside the palette's, read from kv
template <int MODE, int KV_>
__global__ void __launch_bounds__(kThreads)
arith_dequant_kernel(const uint32_t* __restrict__ tr,
                     __nv_bfloat16* __restrict__ w, int m, int k, int kv) {
  constexpr int V = mode_v(MODE);
  constexpr int W_ = 8 * KV_ / V;  // words per tile (0: at run time)
  const int W = KV_ ? W_ : 8 * kv / V;
  __shared__ uint32_t wsm[kWarps][4 * 8 * (KV_ ? KV_ : kMaxKV) / V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kt = k >> 4, gr = (kt + 3) / 4;  // 4-tile groups a tile-row
  const long long total = (long long)(m >> 4) * gr;
  const int tl = (lane >> 1) & 3, c0 = (lane & 1) * 8;
  for (long long gi = (long long)blockIdx.x * kWarps + warp; gi < total;
       gi += (long long)gridDim.x * kWarps) {
    const int mt = (int)(gi / gr), j0 = 4 * (int)(gi - (long long)mt * gr);
    const int ntile = min(4, kt - j0);
    const uint32_t* tiles = tr + ((size_t)mt * kt + j0) * W;
    for (int i = lane; i < ntile * W; i += 32) wsm[warp][i] = tiles[i];
    __syncwarp();
    if (tl < ntile) {
      const uint32_t* wt = wsm[warp] + tl * W;
#pragma unroll
      for (int rg = 0; rg < 4; ++rg) {
        const int row = rg * 4 + (lane >> 3);
        uint32_t e[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          int a[2], b[2];
          if (V == 2) {  // pair t = c0/2 + p: columns c0 + 2p, c0 + 2p + 1
            state_weights<MODE>(
                state_of<KV_, W_>(wt, 16 * (c0 / 2 + p) + row, kv, W), a);
            e[p] = bf16_bits(a[0]) | (bf16_bits(a[1]) << 16);
          } else {  // columns c0 + 2p and c0 + 2p + 1, one state each
            state_weights<MODE>(
                state_of<KV_, W_>(wt, 16 * (c0 + 2 * p) + row, kv, W), a);
            state_weights<MODE>(
                state_of<KV_, W_>(wt, 16 * (c0 + 2 * p + 1) + row, kv, W),
                b);
            e[p] = bf16_bits(a[0]) | (bf16_bits(b[0]) << 16);
          }
        }
        *reinterpret_cast<uint4*>(w + (size_t)(mt * 16 + row) * k +
                                  (j0 + tl) * 16 + c0) =
            make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
    __syncwarp();  // wsm is overwritten by the warp's next group
  }
}

template <int MODE, int KV>
int dequant(const void* tr, void* w, int m, int k, int kv, cudaStream_t st) {
  const long long total = (long long)(m / 16) * ((k / 16 + 3) / 4);
  const long long need = (total + kWarps - 1) / kWarps;
  const int grid = (int)(need < kDequantBlocks ? need : kDequantBlocks);
  arith_dequant_kernel<MODE, KV><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(tr), static_cast<__nv_bfloat16*>(w), m,
      k, kv);
  return (int)cudaGetLastError();
}

bool bad_args(int m, int k, int KV) {
  return m <= 0 || k <= 0 || m % 16 || k % 16 || KV < 1 || KV > kMaxKV;
}

}  // namespace

// tr: canonical (m/16*k/16, 4*KV) words, 1 <= KV <= 16; w: (m, k)
// bfloat16, 16-byte aligned; mode 0 = sum2, 1 = dualmad.  Each function
// launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tcq2_dequant(const void* tr, void* w, int m, int k, int KV,
                            int mode, void* stream) {
  if (bad_args(m, k, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QPT_K2(MODE)                                                 \
  switch (KV) {                                                      \
    case 4: return dequant<MODE, 4>(tr, w, m, k, KV, st);            \
    case 5: return dequant<MODE, 5>(tr, w, m, k, KV, st);            \
    case 6: return dequant<MODE, 6>(tr, w, m, k, KV, st);            \
    case 7: return dequant<MODE, 7>(tr, w, m, k, KV, st);            \
    case 8: return dequant<MODE, 8>(tr, w, m, k, KV, st);            \
    case 9: return dequant<MODE, 9>(tr, w, m, k, KV, st);            \
    case 10: return dequant<MODE, 10>(tr, w, m, k, KV, st);          \
    default: return dequant<MODE, 0>(tr, w, m, k, KV, st);           \
  }
  if (mode == 0) QPT_K2(kSum2)
  if (mode == 1) QPT_K2(kDualmad)
#undef QPT_K2
  return (int)cudaErrorInvalidValue;
}

// tr: canonical (m/16*k/16, 8*KV) words; mode 0 = 1mad, 1 = 2mad.
extern "C" int tcq1_dequant(const void* tr, void* w, int m, int k, int KV,
                            int mode, void* stream) {
  if (bad_args(m, k, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QPT_K3(MODE)                                                 \
  switch (KV) {                                                      \
    case 2: return dequant<MODE, 2>(tr, w, m, k, KV, st);            \
    case 3: return dequant<MODE, 3>(tr, w, m, k, KV, st);            \
    case 4: return dequant<MODE, 4>(tr, w, m, k, KV, st);            \
    case 5: return dequant<MODE, 5>(tr, w, m, k, KV, st);            \
    default: return dequant<MODE, 0>(tr, w, m, k, KV, st);           \
  }
  if (mode == 0) QPT_K3(k1mad)
  if (mode == 1) QPT_K3(k2mad)
#undef QPT_K3
  return (int)cudaErrorInvalidValue;
}
