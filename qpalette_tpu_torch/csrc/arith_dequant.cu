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
// so the bf16 writes, and how whole the written lines are.  Both write
// each row of a 16 x 64 block of W_hat (4 k-tiles of an m-tile: a group)
// as 16-byte stores.
//
// K3 (V=1) walks the groups of dequant.cuh: a persistent grid, each warp
// streaming its groups through its own ring of bulk copies.  State s =
// 16*col + row covers one weight, so a row's columns lie 16 states apart
// and consecutive states are consecutive rows of one column.  Its lanes
// decode columns and transpose: lane (g, c) cuts states s and s+1 (rows
// 2c, 2c+1 of column 8*(g/2) + 2j + g%2 of a 32-column pair of tiles) from
// one funnel shift, packs their two bf16 weights, and movmatrix.trans over
// the warp hands it row g, columns 8c + 2j, +1; after j = 0..3 it holds 8
// contiguous columns of one row, a 16-byte store.  Its window offsets are
// constants a lane (an instance a KV, 1 to 16), and the weight goes to
// float32 without a conversion instruction (v1_weight).
//
// K2 (V=2) keeps its first kernel: a capped grid of blocks, each warp
// copying one group's words to shared memory at a time; lane l decodes the
// four states of 8 columns of row 4*rg + l/8 of tile (l/2)%4, each from
// its own window.  (On an H100 it was 0.2-4.5% slower on K3's walk at the
// 215's sum2 shapes, 6144x4096 KV 8 and 4096x14336 KV 6 among them, though
// faster at 4096x4096 and tcq2mix's dualmad shapes: PERF.md, section 6.)
// The palette's KVs have an instance each; every other KV from 1 to 16
// runs the instance KV = 0, which reads the KV of its launch.

#include "arith.cuh"
#include "dequant.cuh"

using namespace qpt;

namespace {

constexpr int kDequantBlocks = 2112;  // K2: two waves of 8 per SM
constexpr int kMaxKV = 16;            // the 16-bit state's largest step

__device__ __forceinline__ uint32_t bf16_bits(int w) {
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(__fmul_rn((float)w, kMadInv)));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an 8x8 b16 matrix transposed across the warp: lane (g, c) holds row g,
// columns 2c, 2c+1 of it before and of its transpose after
__device__ __forceinline__ uint32_t movm_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(d)
               : "r"(a));
  return d;
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

// K2 (V=2).  KV_ = 0: the instance of every KV outside the palette's,
// read from kv.
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
          int a[2];  // pair t = c0/2 + p: columns c0 + 2p, c0 + 2p + 1
          state_weights<MODE>(
              state_of<KV_, W_>(wt, 16 * (c0 / 2 + p) + row, kv, W), a);
          e[p] = bf16_bits(a[0]) | (bf16_bits(a[1]) << 16);
        }
        *reinterpret_cast<uint4*>(w + (size_t)(mt * 16 + row) * k +
                                  (j0 + tl) * 16 + c0) =
            make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
    __syncwarp();  // wsm is overwritten by the warp's next group
  }
}

// K3's weight of the window in bits [0, 16) of u: the unsigned byte sum of
// the hash - 510, made a float32 without a conversion instruction (dp4a
// adds the sum to the bits of 1.5 * 2^23 - 510, whose ulp is 1, and the
// subtraction of 1.5 * 2^23 is exact), times 1/147.8... in float32
template <int MODE>
__device__ __forceinline__ float v1_weight(uint32_t u) {
  const uint32_t h = v1_hash<MODE>(u & 0xffffu);
  const float x =
      __uint_as_float(__dp4a(h, 0x01010101u, 0x4B400000u - kV1Bias));
  return __fmul_rn(__fsub_rn(x, 12582912.0f), kMadInv);
}

// K3's lane (g, c) = (lane / 4, lane % 4): in rows 8h.. of a pair of tiles
// (32 columns), for j = 0..3, states s and s+1 = 16*col + 8h + 2c (+1),
// col = 8*((g/2)%2) + g%2 + 2j of tile g/4 of the pair.  The window of s
// is at bit KV*s, so j steps KV words at one shift: o[h] is the byte
// offset of its first word at j = 0, sh[h] its shift, and o3[h] the second
// word at j = 3, the only j whose windows wrap the tile's circular stream.
template <int KV>
struct V1Lane {
  uint32_t o[2], o3[2];
  int sh[2];

  __device__ __forceinline__ explicit V1Lane(int lane) {
    constexpr int W = 8 * KV;  // words a tile
    const int g = lane >> 2, c = lane & 3;
    const uint32_t tile = (uint32_t)(g >> 2) * 4 * W;
    const int col = 8 * ((g >> 1) & 1) + (g & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = KV * (16 * col + 8 * h + 2 * c);
      const int w0 = off >> 5, w3 = w0 + 3 * KV + 1;
      o[h] = tile + 4 * w0;
      o3[h] = tile + 4 * (w3 == W ? 0 : w3);
      sh[h] = off & 31;
    }
  }
};

// K3: the group's tiles at st (8*KV words each); wo = W_hat at row lane/4
// of the m-tile, column 8*(lane%4) of the group
template <int MODE, int KV>
__device__ __forceinline__ void v1_group(const uint8_t* st,
                                         const V1Lane<KV>& L, int ntile,
                                         __nv_bfloat16* wo, int k,
                                         int lane) {
  constexpr int kTile = 32 * KV;  // bytes a tile
  const int c = lane & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // tiles 2p, 2p+1: 32 columns
    if (2 * p >= ntile) break;
    const uint8_t* sp = st + 2 * p * kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 8h .. 8h+7
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a = dq_word(sp, L.o[h] + 4 * KV * j);
        const uint32_t b =
            dq_word(sp, j == 3 ? L.o3[h] : L.o[h] + 4 * KV * j + 4);
        const uint32_t f = __funnelshift_r(a, b, L.sh[h]);
        r[j] = movm_trans(
            bf16x2(v1_weight<MODE>(f), v1_weight<MODE>(f >> KV)));
      }
      if (2 * p + (c >> 1) < ntile)  // a last group's missing tile
        dq_store(wo + (size_t)8 * h * k + 32 * p,
                 make_uint4(r[0], r[1], r[2], r[3]));
    }
  }
}

// K3.  Dynamic shared memory: each warp's kDqSlots slots of a group's
// words, then their barriers.
template <int KV>
constexpr int kV1Slot = kDqTiles * 32 * KV;

template <int MODE, int KV>
__global__ void __launch_bounds__(kDqThreads)
v1_dequant_kernel(const uint8_t* __restrict__ tr,
                  __nv_bfloat16* __restrict__ w, int m, int k) {
  constexpr int kTile = 32 * KV, kSlot = kV1Slot<KV>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* ring = smem + warp * kDqSlots * kSlot;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kDqWarps * kDqSlots * kSlot) +
      warp * kDqSlots;
  const int kt = k >> 4, mtiles = m >> 4;
  DqCursor cur((kt + kDqTiles - 1) / kDqTiles), ahead = cur;
  const auto issue = [&](int slot) {  // lane 0: the group at `ahead`
    const int j0 = kDqTiles * ahead.q;
    bulk_load(ring + slot * kSlot, tr + ((size_t)ahead.mt * kt + j0) * kTile,
              min(kDqTiles, kt - j0) * kTile, bars + slot);
  };
  dq_init_bars(bars);
  for (int s = 0; s < kDqSlots; ++s, ahead.next())
    if (lane == 0 && ahead.mt < mtiles) issue(s);
  __syncwarp();

  const V1Lane<KV> L(lane);
  for (int it = 0; cur.mt < mtiles; ++it, cur.next()) {
    const int slot = it % kDqSlots, j0 = kDqTiles * cur.q;
    mbar_wait(bars + slot, (it / kDqSlots) & 1);
    v1_group<MODE, KV>(
        ring + slot * kSlot, L, min(kDqTiles, kt - j0),
        w + (size_t)(cur.mt * 16 + (lane >> 2)) * k + j0 * 16 + 8 * (lane & 3),
        k, lane);
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && ahead.mt < mtiles) issue(slot);
    ahead.next();
  }
}

// K2: a capped grid
template <int MODE, int KV>
int dequant2(const void* tr, void* w, int m, int k, int kv, cudaStream_t st) {
  const long long total = (long long)(m / 16) * ((k / 16 + 3) / 4);
  const long long need = (total + kWarps - 1) / kWarps;
  const int grid = (int)(need < kDequantBlocks ? need : kDequantBlocks);
  arith_dequant_kernel<MODE, KV><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(tr), static_cast<__nv_bfloat16*>(w), m,
      k, kv);
  return (int)cudaGetLastError();
}

// K3: the blocks that fit on the card, at most one warp a group
template <int MODE, int KV>
int dequant1(const void* tr, void* w, int m, int k, cudaStream_t st) {
  constexpr int smem =
      kDqWarps * kDqSlots * (kV1Slot<KV> + (int)sizeof(uint64_t));
  static int fit[64] = {};  // blocks that fit on the card, by device
  const long long groups =
      (long long)(m / 16) * ((k / 16 + kDqTiles - 1) / kDqTiles);
  int grid = 0;
  const cudaError_t e = dq_grid((const void*)v1_dequant_kernel<MODE, KV>,
                                smem, (groups + kDqWarps - 1) / kDqWarps,
                                fit, grid);
  if (e != cudaSuccess) return (int)e;
  v1_dequant_kernel<MODE, KV><<<grid, kDqThreads, smem, st>>>(
      static_cast<const uint8_t*>(tr), static_cast<__nv_bfloat16*>(w), m, k);
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
    case 4: return dequant2<MODE, 4>(tr, w, m, k, KV, st);           \
    case 5: return dequant2<MODE, 5>(tr, w, m, k, KV, st);           \
    case 6: return dequant2<MODE, 6>(tr, w, m, k, KV, st);           \
    case 7: return dequant2<MODE, 7>(tr, w, m, k, KV, st);           \
    case 8: return dequant2<MODE, 8>(tr, w, m, k, KV, st);           \
    case 9: return dequant2<MODE, 9>(tr, w, m, k, KV, st);           \
    case 10: return dequant2<MODE, 10>(tr, w, m, k, KV, st);         \
    default: return dequant2<MODE, 0>(tr, w, m, k, KV, st);          \
  }
  if (mode == 0) QPT_K2(kSum2)
  if (mode == 1) QPT_K2(kDualmad)
#undef QPT_K2
  return (int)cudaErrorInvalidValue;
}

// tr: canonical (m/16*k/16, 8*KV) words; mode 0 = 1mad, 1 = 2mad.  Every
// KV from 1 to 16 has an instance.
extern "C" int tcq1_dequant(const void* tr, void* w, int m, int k, int KV,
                            int mode, void* stream) {
  if (bad_args(m, k, KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QPT_K3(MODE)                                                 \
  switch (KV) {                                                      \
    case 1: return dequant1<MODE, 1>(tr, w, m, k, st);               \
    case 2: return dequant1<MODE, 2>(tr, w, m, k, st);               \
    case 3: return dequant1<MODE, 3>(tr, w, m, k, st);               \
    case 4: return dequant1<MODE, 4>(tr, w, m, k, st);               \
    case 5: return dequant1<MODE, 5>(tr, w, m, k, st);               \
    case 6: return dequant1<MODE, 6>(tr, w, m, k, st);               \
    case 7: return dequant1<MODE, 7>(tr, w, m, k, st);               \
    case 8: return dequant1<MODE, 8>(tr, w, m, k, st);               \
    case 9: return dequant1<MODE, 9>(tr, w, m, k, st);               \
    case 10: return dequant1<MODE, 10>(tr, w, m, k, st);             \
    case 11: return dequant1<MODE, 11>(tr, w, m, k, st);             \
    case 12: return dequant1<MODE, 12>(tr, w, m, k, st);             \
    case 13: return dequant1<MODE, 13>(tr, w, m, k, st);             \
    case 14: return dequant1<MODE, 14>(tr, w, m, k, st);             \
    case 15: return dequant1<MODE, 15>(tr, w, m, k, st);             \
    default: return dequant1<MODE, 16>(tr, w, m, k, st);             \
  }
  if (mode == 0) QPT_K3(k1mad)
  if (mode == 1) QPT_K3(k2mad)
#undef QPT_K3
  return (int)cudaErrorInvalidValue;
}
