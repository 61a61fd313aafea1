// The tensor-core decode GEMV of the arithmetic trellis (K1 at N <= 8 rows
// of x): the body that tcq2_gemv.cu's v2_gemv_kernel (V=2 modes) and
// tcq1_gemv.cu's v1_gemv_kernel (V=1 modes) share.  y = x @ W_hat^T in
// float32, no Wscale, both variants: a8 (x quantized to int8 per
// 512-column chunk, one absmax scale a chunk over all N rows) and exact (x
// rounded to bf16).
//
// A tile policy TILE gives what differs between the tile orders:
//   kKV, kWords      KV and the 32-bit words of a tile
//   kWarps, kBlocks  warps a block (a block is one m-tile) and blocks an SM
//   kBias            0, or V=1's 510: its MMAs take the unsigned byte sum
//                    of a hash, and the weight is that sum - 510
//   kXAhead          exact: tiles whose x words are loaded before the
//                    slot's barrier wait (a divisor of 16)
//   map(g, c)        lane (g, c)'s view of a tile: its words and shifts
//   xcol(c), kXStep  the lane's x columns of a tile: two pairs, at xcol(c)
//                    and xcol(c) + kXStep (its B operand)
//   a8(...)          one tile's int8 MMAs against the lane's x word
//   exact(...)       one tile's f32-accumulating MMAs against bf16 x
// Both tile orders put fragment rows g and g+8 at tile rows 2g and 2g+1,
// and C element (row, n) of every MMA at the same lane and register, so
// the x buffer, the descale and the epilogue are the same.
//
// The body:
//  - The stream of hopper.cuh, in slots of 16 tiles: a warp owns whole
//    slots of one m-tile's k range and streams them through its own double
//    buffer of cp.async.bulk copies.  A block is one m-tile; its warps'
//    fragments are summed in a fixed order through shared memory: no
//    atomics, and two launches give the same bits.
//  - x for a8: each warp computes the scales of the chunks its k-range
//    touches (over the whole chunk and all rows) while its first slots
//    stream; per slot it quantizes the slot's 256 columns x N rows into a
//    2 KB per-warp buffer, one word [q(p), q(p+1), q(p+s), q(p+s+1)] (p =
//    xcol(c), s = kXStep) a (tile, row, c) at 32*tile + 4*row + c, so that
//    lane (g, c) reads its word of a tile at a fixed offset (the stores hit
//    4 banks, once a slot); a lane's B registers are that word under byte
//    permutes.  No block barrier before the epilogue.
//  - a8 sums are exact in int32 and descaled into f32 at each chunk
//    boundary, as the plain version does its chunk sums.  With kBias, each
//    lane also adds up the q bytes of the x words it reads (one __dp4a a
//    tile on the word it holds for its MMAs); at the chunk boundary four
//    shuffles give each lane the sums of its two C columns' rows over the
//    warp's columns of the chunk, and the int32 fragment takes -kBias
//    times them once.  (A second pass over x in the scale prologue for
//    those sums measured 8% slower on Path A's V=1 shapes.)

#pragma once

#include "arith.cuh"
#include "hopper.cuh"

namespace qpt {

constexpr int kTcRows = 8;    // rows of x: the MMAs' n
constexpr int kTcTiles = 16;  // k-tiles a ring slot (one bulk copy)
constexpr int kSlotCols = kTcTiles * 16;  // a slot never straddles a chunk
static_assert(kChunk % kSlotCols == 0, "slots tile the chunks");

__device__ __forceinline__ float2 load_x2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// two adjacent x values as a bf16x2 word (the lower column in the low half)
__device__ __forceinline__ uint32_t x_bf16x2(const float* p) {
  const float2 v = load_x2(p);
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(v.y), "f"(v.x));
  return r;
}
__device__ __forceinline__ uint32_t x_bf16x2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Dynamic shared memory of a block: the warps' rings, their a8 x words (a
// slot's tiles x 8 rows x 4 words), chunk scales and slot barriers
template <class TILE, bool A8>
struct TcSmem {
  // chunks a warp's range touches at most: it holds at most
  // ceil(nslots / kWarps) slots of a k <= kChunk * kMaxChunks
  static constexpr int kWarpChunks = kMaxChunks / TILE::kWarps + 1;
  static constexpr int kRing =
      kSlots * Ring<TILE::kKV, kTcTiles, TILE::kWords>::kSlotBytes;
  static constexpr int kXq = A8 ? kTcTiles * 32 * 4 : 0;
  static constexpr int kXq0 = TILE::kWarps * kRing;
  static constexpr int kSx0 = kXq0 + TILE::kWarps * kXq;
  static constexpr int kBars0 = kSx0 + TILE::kWarps * kWarpChunks * 8;
  static constexpr int kBytes = kBars0 + TILE::kWarps * kSlots * 8;
};

template <class TILE, typename XT, bool A8>
__device__ __forceinline__ void tc_gemv(const XT* __restrict__ x,
                                        const uint8_t* __restrict__ tr,
                                        float* __restrict__ out, int N,
                                        int m, int k) {
  constexpr int KV = TILE::kKV, kW = TILE::kWarps;
  using R = Ring<KV, kTcTiles, TILE::kWords>;
  using L = TcSmem<TILE, A8>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  uint8_t* ring = smem + warp * L::kRing;
  uint32_t* xq = reinterpret_cast<uint32_t*>(smem + L::kXq0 + warp * L::kXq);
  float2* sx =
      reinterpret_cast<float2*>(smem + L::kSx0) + warp * L::kWarpChunks;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + L::kBars0) + warp * kSlots;

  // this warp's k-tiles of m-tile blockIdx.x, in whole slots
  const int kt = k >> 4;
  const int nsl = (kt + kTcTiles - 1) / kTcTiles;
  const int ta = min(kt, nsl * warp / kW * kTcTiles);
  const int tb = min(kt, nsl * (warp + 1) / kW * kTcTiles);
  const WarpJob job{tr + ((size_t)blockIdx.x * kt + ta) * R::kTileBytes,
                    tb - ta, 16 * ta};
  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue_first<KV, kTcTiles, TILE::kWords>(job, ring, bars);
  }

  // a8, while the first slots stream: the scale of each chunk the range
  // touches, and rows N..7 of the x buffer set to 0 once
  const int ch0 = job.col0 / kChunk;
  if constexpr (A8) if (job.nt > 0) {
    const int ch1 = (job.col0 + 16 * job.nt - 1) / kChunk;
    for (int ch = ch0; ch <= ch1; ++ch) {
      const int c0 = ch * kChunk, np = min(kChunk, k - c0) >> 1;
      float amax = 0.f;
      for (int n = 0; n < N; ++n) {
        const XT* xp = x + (size_t)n * k + c0;
        for (int p = lane; p < np; p += 32) {
          const float2 v = load_x2(xp + 2 * p);
          amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
        }
      }
      for (int o = 16; o; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-30f);
      if (lane == 0) sx[ch - ch0] = make_float2(s, __fdiv_rn(1.0f, s));
    }
    for (int i = lane; i < kTcTiles * 32; i += 32) xq[i] = 0u;
  }
  __syncwarp();

  const auto lm = TILE::map(g, c);
  const bool xrow = g < N;  // B columns n >= N stay 0
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int di[4] = {0, 0, 0, 0};  // a8: the current chunk's int32 fragment
  int ch = -1;
  float2 sc = make_float2(0.f, 0.f);  // a8: the current chunk's scale, 1/scale
  int qsum = 0;  // kBias: the sum of q in this lane's x words this chunk
  const auto descale = [&]() {
    if constexpr (TILE::kBias != 0) {
      // row g's sum over the warp's columns of the chunk (lanes 4g..4g+3),
      // then rows 2c and 2c+1 of this lane's C columns
      int s = qsum + __shfl_xor_sync(0xffffffffu, qsum, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int s0 = __shfl_sync(0xffffffffu, s, 8 * c);
      const int s1 = __shfl_sync(0xffffffffu, s, 8 * c + 4);
      di[0] -= TILE::kBias * s0;
      di[2] -= TILE::kBias * s0;
      di[1] -= TILE::kBias * s1;
      di[3] -= TILE::kBias * s1;
      qsum = 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r] = __fadd_rn(acc[r], __fmul_rn((float)di[r], sc.x));
      di[r] = 0;
    }
  };
  // two slots an iteration, so that each slot's shared-memory addresses
  // are fixed offsets from the ring
  const int nslot = (job.nt + kTcTiles - 1) / kTcTiles;
  for (int it0 = 0; it0 < nslot; it0 += kSlots) {
    const uint32_t parity = (it0 / kSlots) & 1;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int it = it0 + slot;
      if (it >= nslot) break;
      const uint8_t* st = ring + slot * R::kSlotBytes;
      const int col = job.col0 + it * kSlotCols;
      const int n = min(kTcTiles, job.nt - it * kTcTiles);
      if constexpr (A8) {
        if ((unsigned)col / kChunk != (unsigned)ch) {
          if (ch >= 0) descale();
          ch = (unsigned)col / kChunk;
          sc = sx[ch - ch0];
        }
        // lane (g, c) quantizes its columns of tiles t = g and g+8, each
        // row r into word t*32 + (r << 2) + c: the word that lane 4r + c
        // reads as xq[t*32 + lane]
#pragma unroll
        for (int h = 0; h < kTcTiles / 8; ++h) {
          const int t = g + 8 * h;
          if (t < n) {
            const XT* xp = x + col + 16 * t + TILE::xcol(c);
#pragma unroll 1
            for (int r = 0; r < N; ++r, xp += k) {
              const float2 v0 = load_x2(xp), v1 = load_x2(xp + TILE::kXStep);
              xq[t * 32 + (r << 2) + c] =
                  quant8(v0.x, sc.y) | quant8(v0.y, sc.y) << 8 |
                  quant8(v1.x, sc.y) << 16 | quant8(v1.y, sc.y) << 24;
            }
          }
        }
        __syncwarp();
        mbar_wait(bars + slot, parity);
        if (n == kTcTiles) {
#pragma unroll
          for (int j = 0; j < kTcTiles; ++j) {
            const uint32_t xw = xq[j * 32 + lane];
            TILE::a8(st + j * R::kTileBytes, lm, xw, di);
            if constexpr (TILE::kBias != 0)
              qsum = __dp4a((int)xw, 0x01010101, qsum);
          }
        } else {
#pragma unroll 1
          for (int j = 0; j < n; ++j) {
            const uint32_t xw = xq[j * 32 + lane];
            TILE::a8(st + j * R::kTileBytes, lm, xw, di);
            if constexpr (TILE::kBias != 0)
              qsum = __dp4a((int)xw, 0x01010101, qsum);
          }
        }
      } else {
        const XT* xp = x + (size_t)(xrow ? g : 0) * k + col + TILE::xcol(c);
        const auto xload = [&](int j) {
          return xrow ? make_uint2(x_bf16x2(xp + 16 * j),
                                   x_bf16x2(xp + 16 * j + TILE::kXStep))
                      : make_uint2(0u, 0u);
        };
        if (n == kTcTiles) {
          constexpr int kA = TILE::kXAhead;
#pragma unroll
          for (int h = 0; h < kTcTiles / kA; ++h) {
            uint2 b[kA];  // the first kA do not wait for the slot
#pragma unroll
            for (int j = 0; j < kA; ++j) b[j] = xload(kA * h + j);
            if (h == 0) mbar_wait(bars + slot, parity);
#pragma unroll
            for (int j = 0; j < kA; ++j)
              TILE::exact(st + (kA * h + j) * R::kTileBytes, lm, b[j], acc);
          }
        } else {
          mbar_wait(bars + slot, parity);
#pragma unroll 1
          for (int j = 0; j < n; ++j)
            TILE::exact(st + j * R::kTileBytes, lm, xload(j), acc);
        }
      }
      __syncwarp();  // every lane has read the slot and the x words
      if (lane == 0 && it + kSlots < nslot)
        issue_slot<KV, kTcTiles, TILE::kWords>(job, ring, bars, it + kSlots);
    }
  }
  if (A8 && ch >= 0) descale();

  // the warps' fragments, summed in warp order: C element (fragment row
  // fr, n) sits in lane 4*(fr%8) + n/2, register 2*(fr/8) + n%2, and
  // fragment row fr is tile row 2*(fr%8) + fr/8.  A warp's ring is free
  // once its loop is done, and holds its fragment.
  reinterpret_cast<float4*>(ring)[lane] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (tid < 16 * N) {
    const int row = tid & 15, nn = tid >> 4;
    const int src = 4 * (row >> 1) + (nn >> 1), comp = 2 * (row & 1) + (nn & 1);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      v += reinterpret_cast<const float*>(smem + w * L::kRing)[src * 4 + comp];
    out[(size_t)nn * m + blockIdx.x * 16 + row] = v * kMadInv;
  }
}

// Launch KERNEL (a __global__ wrapper of tc_gemv<TILE, XT, A8>) on m/16
// blocks; `ready` (one per instance) marks the devices on which it may
// take its shared memory.
template <class TILE, typename XT, bool A8, typename KERNEL>
int launch_tc(KERNEL kernel, unsigned long long& ready, const void* x,
              const void* tr, void* out, int N, int m, int k,
              cudaStream_t st) {
  constexpr int smem = TcSmem<TILE, A8>::kBytes;
  if (reinterpret_cast<uintptr_t>(x) % 8)  // x is read 4-8 bytes at a time
    return (int)cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((ready >> dev) & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= 1ull << dev;
  }
  kernel<<<m / 16, 32 * TILE::kWarps, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(tr),
      static_cast<float*>(out), N, m, k);
  return (int)cudaGetLastError();
}

}  // namespace qpt
