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
// What bounds it: each weight is read once as KV/2 bits of packed trellis,
// so the least time is the trellis bytes over device memory rate.  What
// holds it from that on an H100 is the SM's shared-memory pipe and each
// launch's fixed cost, not memory: a tile (128 states) needs 128 table
// gathers and 128 windows cut from its words whatever the layout.  The
// earlier design paid ~5 shared-memory reads a decoded pair (two words, a
// gather that lands ~3 lanes on one bank, two x values) plus 2*N FMAs, and
// kept one 512-column chunk a block in flight behind two barriers.  Design:
//  - Tensor cores.  A 16x16 tile is the A operand of one
//    mma.m16n8k16.bf16 (f32 accumulate); N <= 8 rows of x are its B
//    operand, so N = 1..8 cost the same.  Lane l (g = l/4, c = l%4)
//    decodes states s0 = 8g + 2c, s0+1, s0+64, s0+65: a decoded state is
//    a bf16x2 word of columns (2t, 2t+1) of one row, already an A register
//    (a0 = s0, a2 = s0+1 on row g; a1, a3 on row g+8).  Fragment column
//    2c+j is tile column 4c+j and 8+2c+j is 4c+2+j, so the B registers are
//    the four contiguous bf16 x[g][4c..4c+3]: one 8-byte load.
//  - Fewer shared-memory accesses.  s0 and s0+1 lie within KV+16 <= 26
//    bits, so one funnel shift of two words yields both windows; s0+64
//    sits exactly 2*KV words further at the same shift.  A tile costs a
//    lane 4 word reads, 4 table gathers and one x load, and the warp one
//    MMA (~37 instructions a tile).  The table (32 KB, static shared
//    memory) holds 2^(13-S) copies of each bf16x2 entry, copy j at word
//    i*copies + j, and lane l reads copy l % copies: at S = 9 a gather puts
//    at most 2 lanes on a bank, and the byte offset of an entry is bits
//    [15-S, 15) of h under one mask.  (On an H100, 64 KB with 32 copies was
//    no faster: it halves the blocks an SM holds and doubles the staging;
//    16 KB, with more lanes on a bank, was slower.)
//  - A pipelined trellis stream.  A warp owns a contiguous range of one
//    m-tile's k-tiles (contiguous bytes) and streams it through its own
//    double buffer: two slots of 8 tiles, each slot one 1-D TMA bulk copy
//    (cp.async.bulk) completing on the slot's mbarrier.  The warp decodes
//    one slot while the next streams; no block barrier inside the loop.
//    The small ring fits 4 blocks (32 warps) an SM.  (On an H100, rings of
//    4 slots were slower: every warp's 4 copies at launch queue behind each
//    other, and a warp whose first slot comes last ends the call late.)
//  - Work for 132 SMs.  A block is one m-tile; its 8 warps split k; where
//    m/16 blocks cannot fill the card (k/v: 64 m-tiles), a cluster of up
//    to 8 blocks splits k further.  The partial 16x8 sums are added in a
//    fixed order through (distributed) shared memory: one launch, no
//    atomics, bit-equal results run to run.  Where k needs no split, the
//    launch has no cluster attribute and ends on a block barrier, which
//    is cheaper than a cluster barrier's release fence.
// tcomb runs both halves in one launch: the first half of a cluster's
// warps take the KV1 tiles (columns [0, k/2)), the rest the KV2 tiles, each
// warp's range inside one half and read from that half's canonical array.
//
// Dequant: the trellis -> bf16 W_hat (m, k), natural order.  What bounds
// it: 2 bytes written per weight against KV/16 bytes read, so the bf16
// writes, and how whole the written lines are.  Design: the walk of
// dequant.cuh (a persistent grid; each warp streams 16 x 64 blocks of W_hat
// through its own ring of bulk copies, tcomb's from the array of their
// half), so a block stages the table once: the GEMV's 32 KB table with
// 2^(13-S) copies of each entry, lane l reading copy l % copies.  Lane l
// decodes the 4 states of tile (l/2)%4 that cover 8 columns of row
// 4*rg + l/8 from two funnel shifts, so the 8 lanes of a row write its 128
// contiguous bytes as 16-byte stores.  (On an H100, one tile per warp
// writing 32-byte row pieces took 3-4x as long.)  The dequant takes every
// KV from 1 to 16 and every pair of them: the palette's KV and (KV, KV+1)
// have an instance each (KV a compile-time constant), any other runs the
// instance KV = 0, which reads the KVs of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace qpt;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;               // GEMV activation rows
constexpr int kMaxTlutBits = 11;
constexpr int kMaxKV = 16;                // the dequant's largest KV
constexpr int kTabBits = 15;     // the GEMV's table: 32 KB static shared
constexpr int kRingBytes = kSlots * kStageTiles * 16 * 10;  // KV <= 10
constexpr int kGemvBlocksPerSM = 4;
constexpr int kMaxCluster = 8;
constexpr int kMinWarpTiles = 16;  // a cluster split keeps 2 slots a warp

__device__ __forceinline__ uint32_t pack_bf16x2(float2 v) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  return lo | (hi << 16);
}

// The table of the GEMV and the dequant, staged by a block of kBlock
// threads: 2^rb copies of each bf16x2 entry (rb = 13 - S), copy j of entry
// e at word e*2^rb + j; S <= 11, so rb >= 2 and a thread stores whole
// 16-byte groups of copies.  A thread's loads of the table are all in
// flight before its stores.
template <int kBlock>
__device__ __forceinline__ void stage_table(const float2* __restrict__ tlut,
                                            int S, uint8_t* tab, int tid) {
  const int rb = kTabBits - 2 - S;
  constexpr int kPer = (1 << (kTabBits - 4)) / kBlock;
  float2 v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) v[r] = tlut[(tid + r * kBlock) >> (rb - 2)];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const uint32_t p = pack_bf16x2(v[r]);
    reinterpret_cast<uint4*>(tab)[tid + r * kBlock] = make_uint4(p, p, p, p);
  }
}

// --- GEMV -------------------------------------------------------------------

// The decoded pair of the state whose 16-bit window is bits [0, 16) of f:
// bits < 16 of h = f*(f+1) depend on those bits only.  tmask keeps the
// table index, bits [15-S, 15) of h: with 2^(15-S) bytes of copies an
// entry, they are the entry's byte offset as they stand.  lcb is this
// lane's copy (bytes).
__device__ __forceinline__ uint32_t lut_pair(uint32_t f, const uint8_t* tab,
                                             uint32_t tmask, uint32_t lcb) {
  const uint32_t h = f * (f + 1u);
  const uint32_t off = (h & tmask) | lcb;
  return *reinterpret_cast<const uint32_t*>(tab + off) ^ (h & 0x8000u);
}

// One 16x16 tile (words at wt in shared memory) against x columns at b.
template <int KV>
__device__ __forceinline__ void tile_mma(const uint8_t* wt, const LaneMap& lm,
                                         const uint8_t* tab, uint32_t tmask,
                                         uint32_t lcb, uint2 b,
                                         float (&d)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  mma_bf16(d, lut_pair(f0, tab, tmask, lcb), lut_pair(f1, tab, tmask, lcb),
           lut_pair(f0 >> KV, tab, tmask, lcb),
           lut_pair(f1 >> KV, tab, tmask, lcb), b);
}

// The warp streams its tiles through its ring and accumulates the 16x8 C
// fragment d.  The first kSlots slots were issued before the table was
// staged; a slot is refilled with the one kSlots further once decoded.
template <int KV>
__device__ __forceinline__ void warp_gemv(
    const WarpJob& job, uint8_t* ring, uint64_t* bars, const uint8_t* tab,
    uint32_t tmask, uint32_t lcb, const __nv_bfloat16* __restrict__ x, int N,
    int k, float (&d)[4]) {
  using R = Ring<KV>;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const LaneMap lm = lane_map<KV>(8 * g + 2 * (lane & 3));
  const bool xrow = g < N;  // B columns n >= N stay 0
  const __nv_bfloat16* xp =
      x + (size_t)(xrow ? g : 0) * k + job.col0 + 4 * (lane & 3);
  const auto xload = [&](int col) {
    return xrow ? __ldg(reinterpret_cast<const uint2*>(xp + col))
                : make_uint2(0u, 0u);
  };
  const int nslot = (job.nt + kStageTiles - 1) / kStageTiles;
  for (int it = 0; it < nslot; ++it) {
    const int slot = it % kSlots;
    const uint32_t parity = (it / kSlots) & 1;
    const uint8_t* st = ring + slot * R::kSlotBytes;
    const int c0 = it * kStageTiles * 16;
    const int n = min(kStageTiles, job.nt - it * kStageTiles);
    if (n == kStageTiles) {
      uint2 b[kStageTiles];  // x does not wait for the slot
#pragma unroll
      for (int j = 0; j < kStageTiles; ++j) b[j] = xload(c0 + 16 * j);
      mbar_wait(bars + slot, parity);
#pragma unroll
      for (int j = 0; j < kStageTiles; ++j)
        tile_mma<KV>(st + j * R::kTileBytes, lm, tab, tmask, lcb, b[j], d);
    } else {
      mbar_wait(bars + slot, parity);
      for (int j = 0; j < n; ++j)
        tile_mma<KV>(st + j * R::kTileBytes, lm, tab, tmask, lcb,
                     xload(c0 + 16 * j), d);
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && it + kSlots < nslot)
      issue_slot<KV>(job, ring, bars, it + kSlots);
  }
}

// dynamic shared memory: the warps' rings, then their slots' barriers
constexpr size_t kGemvSmem =
    (size_t)kWarps * kRingBytes + kWarps * kSlots * sizeof(uint64_t);

// tcq: KV1 == KV2 and kt2 == 0; tcomb: KV1 tiles on columns [0, 16*kt1),
// KV2 tiles on [16*kt1, k).  Grid: a cluster of cs blocks an m-tile (cs =
// 1: one block); block rank r takes warps r*kWarps.. of the k split.
template <int KV1, int KV2>
__global__ void __launch_bounds__(kThreads, kGemvBlocksPerSM)
lut_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ tr1,
                const uint8_t* __restrict__ tr2,
                const float2* __restrict__ tlut, int S,
                float* __restrict__ out, int N, int m, int k, int kt1,
                int kt2) {
  __shared__ __align__(128) uint8_t tab[1 << kTabBits];
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* ring = smem + warp * kRingBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kWarps * kRingBytes) +
      warp * kSlots;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int mt = blockIdx.x / cs;
  const int gw = rank * kWarps + warp, wc = cs * kWarps;
  // this warp's k-tiles: tcq splits k over all wc warps; tcomb gives the
  // first wc/2 warps the KV1 half and the rest the KV2 half
  const bool second = kt2 > 0 && gw >= wc / 2;
  const int nw = kt2 > 0 ? wc / 2 : wc, i = second ? gw - wc / 2 : gw;
  const int kth = second ? kt2 : kt1;
  // whole slots a warp, so only a half's last warp decodes a partial slot
  const int nsl = (kth + kStageTiles - 1) / kStageTiles;
  const int ta = min(kth, nsl * i / nw * kStageTiles);
  const int tb = min(kth, nsl * (i + 1) / nw * kStageTiles);
  const WarpJob job =
      second ? WarpJob{tr2 + ((size_t)mt * kt2 + ta) * 16 * KV2, tb - ta,
                       16 * (kt1 + ta)}
             : WarpJob{tr1 + ((size_t)mt * kt1 + ta) * 16 * KV1, tb - ta,
                       16 * ta};

  if (lane == 0) {  // the first slots stream while the table is staged
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (second)
      issue_first<KV2>(job, ring, bars);
    else
      issue_first<KV1>(job, ring, bars);
  }

  stage_table<kThreads>(tlut, S, tab, tid);
  __syncthreads();

  const uint32_t tmask = ((1u << S) - 1u) << (kTabBits - S);
  const uint32_t lcb = (uint32_t)(lane & ((1 << (kTabBits - 2 - S)) - 1))
                       << 2;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (KV1 == KV2) {
    warp_gemv<KV1>(job, ring, bars, tab, tmask, lcb, x, N, k, d);
  } else {
    if (second)
      warp_gemv<KV2>(job, ring, bars, tab, tmask, lcb, x, N, k, d);
    else
      warp_gemv<KV1>(job, ring, bars, tab, tmask, lcb, x, N, k, d);
  }

  // the cluster's wc fragments, summed in warp order by rank 0: C element
  // (row, n) sits in lane 4*(row%8) + n/2, register 2*(row/8) + n%2.  A
  // warp's ring is free once its loop is done, and holds its fragment.
  reinterpret_cast<float4*>(ring)[lane] =
      make_float4(d[0], d[1], d[2], d[3]);
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();  // no cluster-wide release fence

  if (rank == 0 && tid < 16 * N) {
    const int row = tid & 15, n = tid >> 4;
    const int src = 4 * (row & 7) + (n >> 1), comp = 2 * (row >> 3) + (n & 1);
    float v = 0.f;
    for (int b = 0; b < cs; ++b) {
      const float* rr =
          reinterpret_cast<const float*>(cluster.map_shared_rank(smem, b));
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v += rr[(w * kRingBytes) / 4 + src * 4 + comp];
    }
    out[(size_t)n * m + mt * 16 + row] = v;
  }
  if (cs > 1) cluster.sync();  // every block's sums live until rank 0 read them
}

// --- dequant ----------------------------------------------------------------

// ring slot bytes of the instance (KV1_, KV2_): a group of the larger KV
template <int KV1_, int KV2_>
constexpr int kLutSlot =
    kDqTiles * 16 * (KV1_ == 0 ? kMaxKV : KV1_ > KV2_ ? KV1_ : KV2_);

// Lane l of a group: rows 4*rg + l/8 (rg = 0..3) of tile (l/2)%4, columns
// 8*(l%2) .. +8, i.e. states 8*row + 4*(l%2) + i, i = 0..3, cut from two
// funnel shifts (i = 0, 1 and i = 2, 3).  rg steps 32 states, KV words at
// one shift: a and b are the byte offsets of the two windows' first words
// at rg = 0, sa and sb their shifts, a3 and b3 their second words at rg =
// 3, the only rg whose windows wrap the tile's circular stream.
struct LutLane {
  uint32_t a, b, a3, b3;
  int sa, sb;
};

__device__ __forceinline__ LutLane lut_lane(int lane, int KV) {
  const int W = 4 * KV;  // words a tile
  const uint32_t tile = (uint32_t)((lane >> 1) & 3) * 4 * W;
  const int offa = KV * (8 * (lane >> 3) + 4 * (lane & 1)),
            offb = offa + 2 * KV;
  const int wa = offa >> 5, wb = offb >> 5;
  const int wa3 = wa + 3 * KV + 1, wb3 = wb + 3 * KV + 1;
  return {tile + 4 * wa, tile + 4 * wb, tile + 4 * (wa3 == W ? 0 : wa3),
          tile + 4 * (wb3 == W ? 0 : wb3), offa & 31, offb & 31};
}

// The group's tiles at st; wo = W_hat at row l/8 of the m-tile, the lane's
// first column of the group.
template <int KV_>
__device__ __forceinline__ void lut_group(const uint8_t* st, const LutLane& L,
                                          int kv, const uint8_t* tab,
                                          uint32_t tmask, uint32_t lcb,
                                          int ntile, __nv_bfloat16* wo, int k,
                                          int lane) {
  const int KV = KV_ ? KV_ : kv;
  if (((lane >> 1) & 3) >= ntile) return;  // a last group's missing tile
#pragma unroll
  for (int rg = 0; rg < 4; ++rg) {
    const uint32_t d = 4 * KV * rg;
    const uint32_t fa = __funnelshift_r(
        dq_word(st, L.a + d), dq_word(st, rg == 3 ? L.a3 : L.a + d + 4),
        L.sa);
    const uint32_t fb = __funnelshift_r(
        dq_word(st, L.b + d), dq_word(st, rg == 3 ? L.b3 : L.b + d + 4),
        L.sb);
    dq_store(wo + (size_t)4 * rg * k,
             make_uint4(lut_pair(fa, tab, tmask, lcb),
                        lut_pair(fa >> KV, tab, tmask, lcb),
                        lut_pair(fb, tab, tmask, lcb),
                        lut_pair(fb >> KV, tab, tmask, lcb)));
  }
}

// tcq: KV1 == KV2 and kt2 == 0; tcomb: the KV1 tiles (trellis1) on columns
// [0, 16*kt1), the KV2 tiles (trellis2) on [16*kt1, k).  A tile-row's
// groups: ceil(kt1/4) of the first half, then ceil(kt2/4) of the second.
// KV1_ = KV2_ = 0: the instance of the KVs outside the palette's, read
// from kv1 and kv2.  Dynamic shared memory: each warp's kDqSlots slots,
// then their barriers.
template <int KV1_, int KV2_>
__global__ void __launch_bounds__(kDqThreads)
lut_ring_kernel(const uint8_t* __restrict__ tr1,
                const uint8_t* __restrict__ tr2,
                const float2* __restrict__ tlut, int S,
                __nv_bfloat16* __restrict__ w, int m, int k, int kt1,
                int kt2, int kv1, int kv2) {
  constexpr int kSlot = kLutSlot<KV1_, KV2_>;
  __shared__ __align__(128) uint8_t tab[1 << kTabBits];
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* ring = smem + warp * kDqSlots * kSlot;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + kDqWarps * kDqSlots * kSlot) +
      warp * kDqSlots;
  const int KV1 = KV1_ ? KV1_ : kv1, KV2 = KV1_ ? KV2_ : kv2;
  const int g1 = (kt1 + kDqTiles - 1) / kDqTiles, mtiles = m >> 4;
  DqCursor cur(g1 + (kt2 + kDqTiles - 1) / kDqTiles), ahead = cur;
  const auto issue = [&](int slot) {  // lane 0: the group at `ahead`
    const bool second = ahead.q >= g1;
    const int j0 = kDqTiles * (second ? ahead.q - g1 : ahead.q);
    const int kt = second ? kt2 : kt1, tb = 16 * (second ? KV2 : KV1);
    bulk_load(ring + slot * kSlot,
              (second ? tr2 : tr1) + ((size_t)ahead.mt * kt + j0) * tb,
              min(kDqTiles, kt - j0) * tb, bars + slot);
  };
  dq_init_bars(bars);
  for (int s = 0; s < kDqSlots; ++s, ahead.next())
    if (lane == 0 && ahead.mt < mtiles) issue(s);
  stage_table<kDqThreads>(tlut, S, tab, tid);  // as the first groups stream
  __syncthreads();

  const uint32_t tmask = ((1u << S) - 1u) << (kTabBits - S);
  const uint32_t lcb = (uint32_t)(lane & ((1 << (kTabBits - 2 - S)) - 1))
                       << 2;
  const LutLane L1 = lut_lane(lane, KV1), L2 = lut_lane(lane, KV2);
  const int col = 16 * ((lane >> 1) & 3) + 8 * (lane & 1);
  for (int it = 0; cur.mt < mtiles; ++it, cur.next()) {
    const int slot = it % kDqSlots;
    const bool second = cur.q >= g1;
    const int j0 = kDqTiles * (second ? cur.q - g1 : cur.q);
    const int ntile = min(kDqTiles, (second ? kt2 : kt1) - j0);
    __nv_bfloat16* wo = w + (size_t)(cur.mt * 16 + (lane >> 3)) * k +
                        16 * ((second ? kt1 : 0) + j0) + col;
    const uint8_t* st = ring + slot * kSlot;
    mbar_wait(bars + slot, (it / kDqSlots) & 1);
    if constexpr (KV1_ != 0 && KV1_ == KV2_) {
      lut_group<KV1_>(st, L1, KV1, tab, tmask, lcb, ntile, wo, k, lane);
    } else {
      if (second)
        lut_group<KV2_>(st, L2, KV2, tab, tmask, lcb, ntile, wo, k, lane);
      else
        lut_group<KV1_>(st, L1, KV1, tab, tmask, lcb, ntile, wo, k, lane);
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && ahead.mt < mtiles) issue(slot);
    ahead.next();
  }
}

// SMs of the current device, read once per device
int sm_count(int dev) {
  static int count[64] = {};
  if (dev < 64 && count[dev]) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) count[dev] = n;
  return n;
}

template <int KV1, int KV2>
int gemv(const void* x, const void* tr1, const void* tr2, const void* tlut,
         int S, void* out, int N, int m, int k, int kt1, int kt2,
         cudaStream_t st) {
  constexpr size_t smem = kGemvSmem;
  if (reinterpret_cast<uintptr_t>(x) % 8)  // x is read 8 bytes at a time
    return (int)cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static unsigned long long ready = 0;  // devices that allow `smem` bytes
  if (dev >= 64 || !((ready >> dev) & 1)) {
    e = cudaFuncSetAttribute(lut_gemv_kernel<KV1, KV2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= 1ull << dev;
  }
  // split k over a cluster until the m-tiles' clusters cover the SMs, as
  // long as every warp keeps at least a slot of tiles
  const int mtiles = m / 16, kt = kt1 + kt2, nsm = sm_count(dev);
  int cs = 1;
  while (cs < kMaxCluster && mtiles * cs < nsm &&
         kt >= 2 * cs * kWarps * kMinWarpTiles)
    cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mtiles * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // a launch of single blocks is cheaper
  e = cudaLaunchKernelEx(&cfg, lut_gemv_kernel<KV1, KV2>,
                         static_cast<const __nv_bfloat16*>(x),
                         static_cast<const uint8_t*>(tr1),
                         static_cast<const uint8_t*>(tr2),
                         static_cast<const float2*>(tlut), S,
                         static_cast<float*>(out), N, m, k, kt1, kt2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int KV1, int KV2>
int dequant(const void* tr1, const void* tr2, const void* tlut, int S,
            void* w, int m, int k, int kt1, int kt2, int kv1, int kv2,
            cudaStream_t st) {
  constexpr int smem =
      kDqWarps * kDqSlots * (kLutSlot<KV1, KV2> + (int)sizeof(uint64_t));
  static int fit[64] = {};  // blocks that fit on the card, by device
  const long long groups = (long long)(m / 16) *
                           ((kt1 + kDqTiles - 1) / kDqTiles +
                            (kt2 + kDqTiles - 1) / kDqTiles);
  int grid = 0;
  const cudaError_t e =
      dq_grid((const void*)lut_ring_kernel<KV1, KV2>, smem,
              (groups + kDqWarps - 1) / kDqWarps, fit, grid);
  if (e != cudaSuccess) return (int)e;
  lut_ring_kernel<KV1, KV2><<<grid, kDqThreads, smem, st>>>(
      static_cast<const uint8_t*>(tr1), static_cast<const uint8_t*>(tr2),
      static_cast<const float2*>(tlut), S, static_cast<__nv_bfloat16*>(w),
      m, k, kt1, kt2, kv1, kv2);
  return (int)cudaGetLastError();
}

bool bad_kv(int kv) { return kv < 1 || kv > kMaxKV; }

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

// w: (m, k) bfloat16, 16-byte aligned, W_hat in natural order; the
// dequant takes 1 <= KV <= 16 (tcomb: any two).
extern "C" int tcq_lut_dequant(const void* trellis, const void* tlut, int S,
                               void* w, int m, int k, int KV, void* stream) {
  if (bad_args(m, k, S) || bad_kv(KV)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 3 || KV > 10)  // no instance of its own
    return dequant<0, 0>(trellis, trellis, tlut, S, w, m, k, k / 16, 0, KV,
                         KV, st);
  QPT_TCQ_CASES(dequant, trellis, trellis, tlut, S, w, m, k, k / 16, 0, KV,
                KV, st)
}

extern "C" int tcomb_lut_dequant(const void* trellis1, const void* trellis2,
                                 const void* tlut, int S, void* w, int m,
                                 int k, int KV1, int KV2, void* stream) {
  if (bad_args(m, k, S) || k % 32 || bad_kv(KV1) || bad_kv(KV2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV2 != KV1 + 1 || KV1 < 3 || KV1 > 9)  // no instance of its own
    return dequant<0, 0>(trellis1, trellis2, tlut, S, w, m, k, k / 32,
                         k / 32, KV1, KV2, st);
  QPT_TCOMB_CASES(dequant, trellis1, trellis2, tlut, S, w, m, k, k / 32,
                  k / 32, KV1, KV2, st)
}
