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
// writes, and how whole the written lines are.  Design: a capped grid of
// blocks (the table is loaded once per block); each warp takes 4 adjacent
// tiles of one m-tile at a time, a 16 x 64 block of W_hat, and its 8 lanes
// of a row write that row's 128 contiguous bytes as 16-byte stores.  (On an
// H100, one tile per warp writing 32-byte row pieces took 3-4x as long.)
//
// The dequant's table is one copy (its reads are not its bound); a
// Hopper weight layout is later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;               // GEMV activation rows
constexpr int kMaxTlutBits = 11;
constexpr int kDequantBlocks = 2112;      // two waves of 8 per SM
constexpr int kTabBits = 15;     // the GEMV's table: 32 KB static shared
constexpr int kStageTiles = 8;   // k-tiles a ring slot (one bulk copy)
constexpr int kSlots = 2;        // a warp decodes one slot, the other streams
constexpr int kRingBytes = kSlots * kStageTiles * 16 * 10;  // KV <= 10
constexpr int kGemvBlocksPerSM = 4;
constexpr int kMaxCluster = 8;
constexpr int kMinWarpTiles = 16;  // a cluster split keeps 2 slots a warp

__device__ __forceinline__ uint32_t pack_bf16x2(float2 v) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  return lo | (hi << 16);
}

// (2^S, 2) float32 table -> 2^S bf16x2 words in shared memory
__device__ __forceinline__ void load_table(const float2* __restrict__ tlut,
                                           int S, uint32_t* tab) {
  for (int i = threadIdx.x; i < (1 << S); i += blockDim.x)
    tab[i] = pack_bf16x2(tlut[i]);
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

// --- GEMV -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// lane 0 of a warp: arm the slot's barrier for `bytes` and start the copy
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n\t"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"(smem_addr(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

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

// This lane's view of a tile: byte offsets of its four words and the shift
// of its windows (see the note at the top).
struct LaneMap {
  uint32_t o0, o1, o2, o3;
  int sh;
};

template <int KV>
__device__ __forceinline__ LaneMap lane_map(int lane) {
  constexpr int W = 4 * KV;
  const int off = KV * (8 * (lane >> 2) + 2 * (lane & 3));
  const int w0 = off >> 5, w2 = w0 + 2 * KV;
  const int w3 = (w2 + 1 == W) ? 0 : w2 + 1;  // the stream is circular
  return {4u * w0, 4u * (w0 + 1), 4u * w2, 4u * w3, off & 31};
}

// One 16x16 tile (words at wt in shared memory) against x columns at b.
template <int KV>
__device__ __forceinline__ void tile_mma(const uint8_t* wt, const LaneMap& lm,
                                         const uint8_t* tab, uint32_t tmask,
                                         uint32_t lcb, uint2 b,
                                         float (&d)[4]) {
  const auto word = [&](uint32_t o) {
    return *reinterpret_cast<const uint32_t*>(wt + o);
  };
  const uint32_t f0 = __funnelshift_r(word(lm.o0), word(lm.o1), lm.sh);
  const uint32_t f1 = __funnelshift_r(word(lm.o2), word(lm.o3), lm.sh);
  mma_bf16(d, lut_pair(f0, tab, tmask, lcb), lut_pair(f1, tab, tmask, lcb),
           lut_pair(f0 >> KV, tab, tmask, lcb),
           lut_pair(f1 >> KV, tab, tmask, lcb), b);
}

// A warp's share of the work: nt k-tiles of one m-tile starting at src
// (bytes in device memory) and at x column col0.
struct WarpJob {
  const uint8_t* src;
  int nt, col0;
};

// A warp's ring for KV: kSlots slots of kStageTiles tiles
template <int KV>
struct Ring {
  static constexpr int kTileBytes = 16 * KV;
  static constexpr int kSlotBytes = kStageTiles * kTileBytes;
};

template <int KV>
__device__ __forceinline__ void issue_slot(const WarpJob& job, uint8_t* ring,
                                           uint64_t* bars, int it) {
  using R = Ring<KV>;
  const int slot = it % kSlots;
  const int n = min(kStageTiles, job.nt - it * kStageTiles);
  bulk_load(ring + slot * R::kSlotBytes,
            job.src + (size_t)it * R::kSlotBytes, n * R::kTileBytes,
            bars + slot);
}

template <int KV>
__device__ __forceinline__ void issue_first(const WarpJob& job, uint8_t* ring,
                                            uint64_t* bars) {
  const int nslot = (job.nt + kStageTiles - 1) / kStageTiles;
  for (int it = 0; it < min(kSlots, nslot); ++it)
    issue_slot<KV>(job, ring, bars, it);
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
  const LaneMap lm = lane_map<KV>(lane);
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

  // 2^rb copies of each entry, copy j of entry e at word e*2^rb + j; S <=
  // 11, so rb >= 2 and a thread stores whole 16-byte groups of copies.  A
  // thread's loads of the table are all in flight before its stores.
  const int rb = kTabBits - 2 - S;
  constexpr int kPer = (1 << (kTabBits - 4)) / kThreads;
  float2 v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) v[r] = tlut[(tid + r * kThreads) >> (rb - 2)];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const uint32_t p = pack_bf16x2(v[r]);
    reinterpret_cast<uint4*>(tab)[tid + r * kThreads] = make_uint4(p, p, p, p);
  }
  __syncthreads();

  const uint32_t tmask = ((1u << S) - 1u) << (kTabBits - S);
  const uint32_t lcb = (uint32_t)(lane & ((1 << rb) - 1)) << 2;
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
