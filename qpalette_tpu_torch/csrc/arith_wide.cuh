// K1 above 8 rows of x (9 <= N <= 256), in every mode: y = x @ W_hat^T in
// float32, no Wscale, both variants (a8: x quantized to int8 per
// 512-column chunk, one absmax scale a chunk over all N rows; exact: x
// rounded to bf16).  Replaces qpalette_tpu/kernels/fused.py::_arith_kernel
// at prefill and zero-shot rows (reached through _arith_decode_matmul from
// tcq2_decode_matmul and tcq1_decode_matmul), where the TPU kernel decodes
// a block of W once and takes it to all N rows in one MXU product.  One
// body, wide_gemv_kernel, serves both tile orders (it was v2_wide_kernel
// while it served only V=2's): tcq2_gemv.cu launches it for sum2 and
// dualmad, tcq1_gemv.cu for 1mad and 2mad.
//
// What bounds it: 2*N*m*k operations against the packed trellis (KV/V/8
// bytes a weight), x and the f32 y, each moved once.  The operations run
// on int8 tensor cores for a8 and, for exact, on bf16 ones in sum2 (its
// integer weights in [-256, 254] bf16 holds exactly) and tf32 ones in the
// other modes (dualmad's weights in [-512, 508], V=1's in [-510, 510]:
// bf16 does not hold the odd ones beyond +-256, tf32 holds every one):
// exact sum2 is bound by its operations from N ~ 32 on, the other exact
// modes from N ~ 16, the rest by bytes below that.  Design:
//  - One decode a tile.  A warp owns one 16-row m-tile and every row of x
//    its block takes (NT n-tiles of 8 rows): it decodes a tile once into
//    its A registers and issues the tile's MMAs on every n-tile against
//    them, with no branch between them.  What depends on the tile order
//    and the mode is the tile policy TILE (as arith_tc.cuh's body takes
//    V2Tile / V1Tile): kV, kWords (words a tile), map(g, c) (the lane's
//    view of a tile, its own type), decode and mma, kMost (n-tiles a row
//    group at most).  V=2 (WideTile below): lane (g, c) holds states
//    16c+2g, +1, +64, +65, v2_gemv_kernel's map; V=1 (tcq1_gemv.cu's
//    WideTile1): states 64c+2g + {0, 1, 16, 17, 32, 33, 48, 49}, four pairs,
//    v1_gemv_kernel's map.  The MMAs a tile:
//      sum2 a8      4 A registers, the hash words as they stand; one
//                   mma.m16n8k32.s8 an n-tile
//      sum2 exact   4 bf16x2 weight pairs; one mma.m16n8k16.bf16
//      dualmad a8   8: u*kMad1A (h1) and u*kMad2A (h2) of the four
//                   windows; two mma.m16n8k32.s8 into one int32
//                   fragment, h1 against the x word's byte permutes
//                   0x0000 / 0x2222, h2 against 0x1111 / 0x3333
//      dualmad      8 tf32 weights (dual_weight: w0 of the four states,
//      exact        then w1); two mma.m16n8k8.tf32, one a column parity,
//                   against the x word's bf16 halves moved into the high
//                   half (a bf16 value as tf32 is its bits << 16: 4 ALU
//                   ops an n-tile, against the 8 more bytes of shared
//                   memory an n-tile that x written as tf32 would take)
//      1mad, 2mad   8: the hashes of the four pairs as u8 A registers of
//      a8           two mma.m16n8k32 (u8 x s8) into one int32 fragment,
//                   against the x word's byte permutes 0x0000 / 0x1111
//                   (columns 4c, 4c+1) and 0x2222 / 0x3333 (4c+2, 4c+3)
//      1mad, 2mad   8 tf32 weights (v1_weight); two mma.m16n8k8.tf32, one
//      exact        a column pair, on the x words' bf16 halves
//    exact sum2 takes all N <= 256 rows in one block (NT <= 32, 128 f32
//    accumulators a lane); a8 holds an int32 and an f32 fragment an
//    n-tile, so its blocks take at most 16 n-tiles (128 rows) and a call
//    above 128 rows splits them over blockIdx.y, decoding each tile once
//    per row group.  The other modes' 8 A registers leave room for 24
//    n-tiles (exact) and 12 (a8) under the register cap (kMost).
//    Instances at NT = 2, 4, 8, 12, 16, 24, 32 keep the MMAs on n-tiles
//    past N few.
//  - x staged once a block.  A block is 8 consumer warps on 8 adjacent
//    m-tiles (x is read m/128 times a call, not m/16) and one producer warp.
//    A prologue kernel (wide_x_kernel, one a tile order) writes x once
//    into a workspace in B-fragment order: exact as bf16x2 words, lane (g,
//    c)'s pair for an (n-tile, k-tile) being the words of columns (p, p+1)
//    and (p+s, p+s+1) of row 8j+g, p = xcol(c) and s the step (V=2: p =
//    2c, s = 8; V=1: p = 4c, s = 2); a8 as one word [q(p), q(p+1),
//    q(p+s), q(p+s+1)] per lane (the B registers are its byte permutes, as
//    in the N <= 8 kernels), after the chunk scales (absmax over all N
//    rows, written first).  The words of a block's rows and 8 k-tiles are
//    contiguous, so the producer copies each step's x with one
//    cp.async.bulk into a ring of kStages slots: full / empty mbarriers, no
//    block barrier in the loop.  A lane reads its B registers of an
//    n-tile with one conflict-free 8-byte (exact) or 4-byte (a8) load.
//    Each warp streams its m-tile's trellis through its own ring of bulk
//    copies, in the same 8-tile steps.
//  - Work for 132 SMs.  Where the m-groups (and row groups) of a call give
//    fewer blocks than the SMs hold, a cluster of up to 8 blocks splits k
//    (in whole steps, so a step never straddles a 512-column chunk); the
//    partial fragments are summed in rank order through distributed shared
//    memory, each rank writing a share of the outputs: no atomics, and two
//    launches give the same bits.
//  - a8: each warp's int32 fragments are exact within a chunk (|w| <= 512,
//    |q| <= 127: at most 512*512*127 < 2^25; V=1's byte sums, at most
//    1020*127*512 < 2^27) and are descaled into its f32 fragments at each
//    chunk boundary, as v2_gemv_kernel does.
//  - V=1 a8: the MMAs sum (unsigned byte sum) * q, and the weight is that
//    byte sum - 510, so each fragment takes -510 * sum(q) over exactly the
//    columns whose products went into it.  A cluster splits k in steps, so
//    a rank may hold part of a chunk: the prologue writes -510 * sum(q) of
//    each x row and 8-tile step into the workspace (after the scales), and
//    a warp adds its n-tiles' two rows of it to the int32 fragments at
//    each step (one 8-byte load an n-tile a step).
//
// What holds sum2 on an H100 (14-19% of the bound over a zero-shot
// forward's calls): at 16 rows the decode's issue, ~36 instructions a tile
// a warp for 2 MMAs, as in the N <= 8 kernels; at 256 rows the 256 bytes
// of x read from shared memory an MMA, with one 9-warp block an SM.  Tried
// and slower: a branch around each MMA for the n-tiles past N (2x at 64
// rows), no cluster split, clusters sized for the fill of the last wave.
// What holds 1mad on an H100 (a Path A forward's o and down calls at 13-21%
// of the bound exact, 4-13% a8): instruction issue and its stalls, no one
// unit.  At 64 rows a warp issues ~120 instructions a tile for 16 MMAs
// (exact; 2mad ~132; a8 ~102, a third of them the x word's byte
// permutes): issue ~29% busy, the tf32 pipe ~17%.  a8 holds an int32 and
// an f32 fragment an n-tile, so from 33 rows it runs one 9-warp block an
// SM, and above 96 rows it decodes each tile once a row group of 12.
//
// A call is two launches: the prologue, then the GEMV (arith.py counts
// both).  The workspace is the caller's: kWideScaleBytes, then (V=1 a8)
// the row sums, then x padded to whole n-tiles, one byte (a8) or two
// (exact) a value.

#pragma once

#include <cooperative_groups.h>

#include "arith_tc.cuh"

namespace qpt {

__device__ __forceinline__ uint32_t sum2_hash(uint32_t f) {
  return (f & 0xffffu) * kMad1A + kMad1B;
}

// the state's weights (sb0+sb1, sb2+sb3) as one bf16x2 A register
__device__ __forceinline__ uint32_t sum2_bf16x2(uint32_t f) {
  const int h = (int)sum2_hash(f);
  const float w0 = (float)__dp4a(h, 0x00000101, 0);
  const float w1 = (float)__dp4a(h, 0x01010000, 0);
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(w1), "f"(w0));
  return r;
}

// The decode step of a sum2 tile at wt: lane (g, c)'s four A registers
// (states s0, s0+1, s0+64, s0+65 of lm), the hash words for a8 (the s8 A
// registers of mma.m16n8k32 as they stand) ...
template <int KV>
__device__ __forceinline__ void sum2_a8_regs(const uint8_t* wt,
                                             const LaneMap& lm,
                                             uint32_t (&a)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  a[0] = sum2_hash(f0);
  a[1] = sum2_hash(f0 >> KV);
  a[2] = sum2_hash(f1);
  a[3] = sum2_hash(f1 >> KV);
}

// ... and the bf16x2 weight pairs for exact (mma.m16n8k16.bf16)
template <int KV>
__device__ __forceinline__ void sum2_exact_regs(const uint8_t* wt,
                                                const LaneMap& lm,
                                                uint32_t (&a)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  a[0] = sum2_bf16x2(f0);
  a[1] = sum2_bf16x2(f0 >> KV);
  a[2] = sum2_bf16x2(f1);
  a[3] = sum2_bf16x2(f1 >> KV);
}

// The MMA step of sum2 a8: one n-tile's B registers, the lane's x word
// [q(2c), q(2c+1), q(8+2c), q(9+2c)] under byte permutes, against the A
// registers of a tile (exact takes its two bf16x2 x words as they stand)
__device__ __forceinline__ void sum2_a8_mma(int (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t xw) {
  mma_s8(d, a[0], a[1], a[2], a[3], __byte_perm(xw, 0, 0x1100),
         __byte_perm(xw, 0, 0x3322));
}

// dualmad: the signed byte sum of the hash h as an f32 (tf32) A register:
// __dp4a adds the sum to the bits of 1.5*2^23, the FADD takes that away
// (a plain int-to-float conversion spills at the register cap in one
// instance of v2_gemv_kernel)
__device__ __forceinline__ uint32_t dual_weight(uint32_t h) {
  const int v = __dp4a((int)h, 0x01010101, 0x4b400000);
  return __float_as_uint(__fsub_rn(__int_as_float(v), 12582912.0f));
}

// The V=2 tile policy of wide_gemv_kernel (and of v2_gemv_kernel's a8
// dualmad tiles): the lane's view of a tile (v2_gemv_kernel's lane map), a
// tile's decode step (kRegs A registers a lane) and its MMA step on one
// n-tile against the lane's x words (a8: one word w, exact: b)
template <int MODE, int KV, bool A8>
struct WideTile {
  static_assert(MODE == kSum2 || MODE == kDualmad, "the V=2 modes");
  static constexpr int kKV = KV, kV = 2, kWords = 4 * KV;
  static constexpr bool kA8 = A8;
  static constexpr int kRegs = MODE == kSum2 ? 4 : 8;
  // n-tiles a row group at most: exact one group of all 32 (sum2), a8
  // 16.  dualmad's 4 more A registers spill its exact 32-n-tile and a8
  // 16-n-tile instances at the register cap of one 9-warp block an SM
  // (168), so it takes 24 and 12: exact above 192 rows and a8 above 96
  // decode each tile once a row group, twice or thrice
  static constexpr int kMost = MODE == kSum2 ? (A8 ? 16 : 32)
                                             : (A8 ? 12 : 24);

  static __device__ __forceinline__ LaneMap map(int g, int c) {
    return lane_map<KV>(16 * c + 2 * g);
  }

  static __device__ __forceinline__ void decode(const uint8_t* wt,
                                                const LaneMap& lm,
                                                uint32_t (&a)[kRegs]) {
    if constexpr (MODE == kSum2) {
      if constexpr (A8)
        sum2_a8_regs<KV>(wt, lm, a);
      else
        sum2_exact_regs<KV>(wt, lm, a);
    } else {
      uint32_t f0, f1;
      lane_windows(wt, lm, f0, f1);
      const uint32_t u[4] = {f0 & 0xffffu, (f0 >> KV) & 0xffffu,
                             f1 & 0xffffu, (f1 >> KV) & 0xffffu};
#pragma unroll
      for (int h = 0; h < 2; ++h)  // h1's registers, then h2's
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t v = u[r] * (h ? kMad2A : kMad1A);
          a[4 * h + r] = A8 ? v : dual_weight(v);
        }
    }
  }

  // a8: into the chunk's int32 fragment
  static __device__ __forceinline__ void mma(int (&d)[4],
                                             const uint32_t (&a)[kRegs],
                                             uint32_t w) {
    if constexpr (MODE == kSum2) {
      sum2_a8_mma(d, a, w);
    } else {
      mma_s8(d, a[0], a[1], a[2], a[3], __byte_perm(w, 0, 0x0000),
             __byte_perm(w, 0, 0x2222));
      mma_s8(d, a[4], a[5], a[6], a[7], __byte_perm(w, 0, 0x1111),
             __byte_perm(w, 0, 0x3333));
    }
  }

  // exact: into the f32 fragment; a bf16 value as tf32 is its bits in
  // the high half of the word
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[kRegs],
                                             uint2 b) {
    if constexpr (MODE == kSum2) {
      mma_bf16(d, a[0], a[1], a[2], a[3], b);
    } else {
      mma_tf32(d, a[0], a[1], a[2], a[3], b.x << 16, b.y << 16);
      mma_tf32(d, a[4], a[5], a[6], a[7], b.x & 0xffff0000u,
               b.y & 0xffff0000u);
    }
  }
};

constexpr int kWideWarps = 8;  // consumer warps a block, one m-tile each
constexpr int kWideThreads = 32 * (kWideWarps + 1);  // + the x producer
constexpr int kWideTiles = kStageTiles;  // k-tiles a step (ring and x slot)
constexpr int kWideMaxCluster = 8;
// the workspace: a8's (scale, 1/scale) per chunk, then (V=1 a8) the row
// sums, then the x words
constexpr int kWideScaleBytes = kMaxChunks * 8;
static_assert(kChunk % (16 * kWideTiles) == 0, "steps tile the chunks");

__host__ __device__ constexpr int wide_words(bool a8) { return a8 ? 1 : 2; }

// Bytes of the workspace's V=1 a8 row sums (none for V=2 or exact): one
// int32 -510 * sum(q) a (step, row), rows padded to whole n-tiles
template <int V, bool A8>
__host__ __device__ constexpr int wide_qsum_bytes(int N, int k) {
  return V == 1 && A8 ? 4 * 8 * ((N + 7) >> 3) * (((k >> 4) + 7) >> 3) : 0;
}

// Byte offset in the workspace's words of lane 0's words for n-tile nt at
// k-tile t, for NT n-tiles a row group: group y = nt / NT holds k-tile
// major runs of its n-tiles, ntg of them (NT but in the last group), each
// 32 lanes x wide_words(a8) words
__device__ __forceinline__ size_t wide_x_offset(int nt, int t, int NT,
                                                int ntot, int kt, bool a8) {
  const int y = nt / NT, j = nt - y * NT, ntg = min(NT, ntot - y * NT);
  return ((size_t)y * kt * NT + (size_t)t * ntg + j) * 128 * wide_words(a8);
}

__device__ __forceinline__ void mbar_init_n(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

// Dynamic shared memory of a block: kStages x slots (after the loop, the
// warps' partial fragments), the warps' trellis rings of kStages slots of
// TILE's tiles, their barriers, then the x slots' full and empty barriers
template <class TILE, int NT>
struct WideSmem {
  static constexpr bool A8 = TILE::kA8;
  // steps in flight: a step is short at few n-tiles, so more of them hide
  // the copies' latency; exact NT >= 24 fits three
  static constexpr int kStages = NT >= 24 ? 3 : 4;
  static constexpr int kTN = 128 * wide_words(A8);  // x an (n-tile, tile)
  static constexpr int kXSlot = kWideTiles * NT * kTN;
  static constexpr int kPart = kWideWarps * NT * 32 * 16;
  static constexpr int kX = kStages * kXSlot;
  static constexpr int kBuf = kX > kPart ? kX : kPart;
  static constexpr int kRing =
      kStages * Ring<TILE::kKV, kWideTiles, TILE::kWords>::kSlotBytes;
  static constexpr int kRings0 = kBuf;
  static constexpr int kBars0 = kRings0 + kWideWarps * kRing;
  static constexpr int kBytes = kBars0 + (kWideWarps + 2) * kStages * 8;
  static_assert(kBytes <= 232448, "a block's shared memory");
  // registers: up to 16 accumulators a lane leave room for three blocks an
  // SM, up to 64 (exact) or 32 (a8, which spills at 64) for two
  static constexpr int kAcc = 4 * NT * (A8 ? 2 : 1);
  static constexpr int kMinBlocks =
      kAcc <= 16 ? 3 : kAcc <= (A8 ? 32 : 64) ? 2 : 1;
};

// Blocks an SM of an instance: WideSmem's, but one for 8 A registers
// (dualmad, V=1) exact at 16 n-tiles, whose 4 more A registers spill at
// two blocks' cap (96), and for V=1 exact at 12 (its lane map's and four
// windows' registers spill 8-12 bytes there)
template <class TILE, int NT>
__host__ __device__ constexpr int wide_min_blocks() {
  return TILE::kRegs > 4 && !TILE::kA8 &&
                 (NT == 16 || (TILE::kV == 1 && NT == 12))
             ? 1
             : WideSmem<TILE, NT>::kMinBlocks;
}

// slot it % S of a warp's trellis ring: its 8 k-tiles it*8.. of job
template <int KV, int W, int S>
__device__ __forceinline__ void wide_ring_issue(const WarpJob& job,
                                                uint8_t* ring, uint64_t* bars,
                                                int it) {
  using R = Ring<KV, kWideTiles, W>;
  const int n = min(kWideTiles, job.nt - it * kWideTiles);
  bulk_load(ring + (it % S) * R::kSlotBytes,
            job.src + (size_t)it * R::kSlotBytes, n * R::kTileBytes,
            bars + it % S);
}

// The prologue: x (N, k) -> the workspace, in tile order V's B-fragment
// order (lane c's columns p, p+1, p+s, p+s+1 of a k-tile: V=2 p = 2c, s =
// 8; V=1 p = 4c, s = 2).  Grid: (chunks, n-tiles), a block an (n-tile,
// chunk); a8 blocks first take their chunk's absmax over all N rows
// (every block of the chunk alike), 8 loads in flight a thread; V=1 a8
// blocks then write -510 * sum(q) of each of their rows a step.
template <typename XT, bool A8, int V>
__global__ void __launch_bounds__(256)
wide_x_kernel(const XT* __restrict__ x, uint8_t* __restrict__ ws, int N,
              int k, int NT) {
  constexpr int kP = 4 / V, kS = V == 2 ? 8 : 2;  // p = kP * c, s = kS
  __shared__ float red[8];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChunk, cw = min(kChunk, k - c0);
  const int kt = k >> 4, ntot = (N + 7) >> 3, nt = blockIdx.y;
  float inv = 0.f;
  if constexpr (A8) {
    const int q = cw >> 2;  // 4-value groups a row of the chunk
    float amax = 0.f;
#pragma unroll 8
    for (int i = tid; i < N * q; i += 256) {
      const int n = i / q;
      const XT* xp = x + (size_t)n * k + c0 + 4 * (i - n * q);
      const float2 a = load_x2(xp), b = load_x2(xp + 2);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                               fmaxf(fabsf(b.x), fabsf(b.y))));
    }
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if ((tid & 31) == 0) red[tid >> 5] = amax;
    __syncthreads();
    amax = red[0];
    for (int w = 1; w < 8; ++w) amax = fmaxf(amax, red[w]);
    const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-30f);
    inv = __fdiv_rn(1.0f, s);
    if (nt == 0 && tid == 0)
      reinterpret_cast<float2*>(ws)[blockIdx.x] = make_float2(s, inv);
  }
  uint8_t* words = ws + kWideScaleBytes + wide_qsum_bytes<V, A8>(N, k);
  // a8: one item a (row, k-tile), its 4 lanes' words (c = 0..3); exact:
  // one a (row, k-tile, half h), the 4 words of lanes 2h and 2h+1.  Row
  // g is the fastest index after h, so that a warp's stores fill whole
  // runs of the n-tile's words.
  constexpr int kH = A8 ? 1 : 2;
  const int items = 8 * (cw >> 4) * kH;
  int qs = 0;  // V=1 a8: the sum of this thread's q (one item at most)
#pragma unroll 2
  for (int i = tid; i < items; i += 256) {
    const int h = A8 ? 0 : i & 1, g = (i / kH) & 7;
    const int t = (c0 >> 4) + i / (8 * kH), n = 8 * nt + g;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);  // rows N.. of the last n-tile
    if (n < N) {
      const XT* xp = x + (size_t)n * k + 16 * t;
      if constexpr (A8) {
        uint32_t q[16];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float2 f = load_x2(xp + 2 * p);
          q[2 * p] = quant8(f.x, inv);
          q[2 * p + 1] = quant8(f.y, inv);
        }
        uint32_t w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[c] = q[kP * c] | q[kP * c + 1] << 8 | q[kP * c + kS] << 16 |
                 q[kP * c + kS + 1] << 24;
        v = make_uint4(w[0], w[1], w[2], w[3]);
        if constexpr (V == 1) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            qs = __dp4a((int)w[c], 0x01010101, qs);  // signed bytes
        }
      } else {
        // lane 2h: columns p, p+1 and p+s, p+s+1 at p = 2*kP*h; lane 2h+1
        // at p + kP
        xp += 2 * kP * h;
        v = make_uint4(x_bf16x2(xp), x_bf16x2(xp + kS), x_bf16x2(xp + kP),
                       x_bf16x2(xp + kP + kS));
      }
    }
    const size_t off = wide_x_offset(nt, t, NT, ntot, kt, A8) +
                       (size_t)(4 * g + 2 * h) * 4 * wide_words(A8);
    *reinterpret_cast<uint4*>(words + off) = v;
  }
  if constexpr (V == 1 && A8) {
    // thread i held (row i % 8, k-tile i / 8 of the chunk): each warp's
    // sum over its 4 k-tiles, then a step's two warps
    __shared__ int qred[8][8];
    qs += __shfl_xor_sync(0xffffffffu, qs, 8);
    qs += __shfl_xor_sync(0xffffffffu, qs, 16);
    if ((tid & 31) < 8) qred[tid >> 5][tid & 7] = qs;
    __syncthreads();
    const int sl = tid >> 3, g = tid & 7;  // the chunk's step sl, row g
    if (tid < 32 && 8 * sl < (cw >> 4))
      reinterpret_cast<int*>(ws + kWideScaleBytes)
          [((c0 >> 7) + sl) * 8 * ntot + 8 * nt + g] =
              -kV1Bias * (qred[2 * sl][g] + qred[2 * sl + 1][g]);
  }
}

// Grid: (m-groups of 8 m-tiles x cs, row groups of NT n-tiles); a cluster
// of cs blocks (cs = 1: none) splits one m-group's k in whole steps.
template <class TILE, int NT>
__global__ void __launch_bounds__(kWideThreads, wide_min_blocks<TILE, NT>())
wide_gemv_kernel(const uint8_t* __restrict__ ws,
                 const uint8_t* __restrict__ tr, float* __restrict__ out,
                 int N, int m, int k) {
  constexpr int KV = TILE::kKV, W = TILE::kWords;
  constexpr bool A8 = TILE::kA8;
  using L = WideSmem<TILE, NT>;
  using R = Ring<KV, kWideTiles, W>;
  constexpr int kTN = L::kTN, S = L::kStages;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = k >> 4, mtiles = m >> 4, ntot = (N + 7) >> 3;
  const int mg = blockIdx.x / cs, y = blockIdx.y;
  const int nact = min(kWideWarps, mtiles - mg * kWideWarps);
  const int ntg = min(NT, ntot - y * NT);
  // this block's k-tiles [ta, tb): steps s0 .. s0 + nsteps of the m-group
  const int nst = (kt + kWideTiles - 1) / kWideTiles;
  const int s0 = nst * rank / cs, nsteps = nst * (rank + 1) / cs - s0;
  const int ta = s0 * kWideTiles;
  const int tb = min(kt, (s0 + nsteps) * kWideTiles);
  const uint8_t* xsrc = ws + kWideScaleBytes +
                        wide_qsum_bytes<TILE::kV, A8>(N, k) +
                        wide_x_offset(y * NT, ta, NT, ntot, kt, A8);
  uint64_t* rbars = reinterpret_cast<uint64_t*>(smem + L::kBars0);
  uint64_t* xfull = rbars + kWideWarps * S;
  uint64_t* xempty = xfull + S;
  const auto issue_x = [&](int s) {  // step s's x into slot s % S
    const int n = min(kWideTiles, tb - ta - s * kWideTiles);
    bulk_load(smem + (s % S) * L::kXSlot,
              xsrc + (size_t)s * kWideTiles * ntg * kTN, n * ntg * kTN,
              xfull + s % S);
  };

  const bool consumer = warp < nact;
  const WarpJob job{tr + ((size_t)(mg * kWideWarps + warp) * kt + ta) *
                             R::kTileBytes,
                    tb - ta, 16 * ta};
  uint8_t* ring = smem + L::kRings0 + warp * L::kRing;
  uint64_t* bars = rbars + warp * S;
  if (tid == kWideWarps * 32) {
    for (int b = 0; b < S; ++b) {
      mbar_init(xfull + b);
      mbar_init_n(xempty + b, nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < min(S, nsteps); ++s) issue_x(s);
  } else if (consumer && lane == 0) {
    for (int b = 0; b < S; ++b) mbar_init(bars + b);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < min(S, nsteps); ++s)
      wide_ring_issue<KV, W, S>(job, ring, bars, s);
  }
  __syncthreads();  // every barrier is initialized before a wait or arrive

  float acc[NT][4];
  int di[A8 ? NT : 1][4];  // a8: the current chunk's int32 fragments
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[j][r] = 0.f;
      if constexpr (A8) di[j][r] = 0;
    }
  float sc = 0.f;  // a8: the current chunk's scale
  const auto descale = [&]() {
    if constexpr (A8) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[j][r] = __fadd_rn(acc[j][r], __fmul_rn((float)di[j][r], sc));
          di[j][r] = 0;
        }
    }
  };

  if (warp == kWideWarps) {
    // the producer: step s refills slot s % S once every consumer has
    // read step s - S from it
    if (lane == 0)
      for (int s = S; s < nsteps; ++s) {
        mbar_wait(xempty + s % S, (s / S - 1) & 1);
        issue_x(s);
      }
  } else if (consumer) {
    const auto lm = TILE::map(lane >> 2, lane & 3);
    const float2* scales = reinterpret_cast<const float2*>(ws);
    int ch = -1;
    for (int s = 0; s < nsteps; ++s) {
      const int b = s % S;
      const uint32_t parity = (s / S) & 1;
      const int n = min(kWideTiles, tb - ta - s * kWideTiles);
      if constexpr (A8) {
        const int chunk = (ta + s * kWideTiles) / (kChunk / 16);
        if (chunk != ch) {
          if (ch >= 0) descale();
          ch = chunk;
          sc = __ldg(&scales[ch].x);
        }
        if constexpr (TILE::kV == 1) {
          // -510 * sum(q) of the step's columns, for the two x rows of
          // each n-tile's C columns in this lane (2c, 2c+1: registers 0
          // and 2, 1 and 3)
          const int2* qb =
              reinterpret_cast<const int2*>(ws + kWideScaleBytes) +
              ((s0 + s) * 8 * ntot + y * NT * 8) / 2 + (lane & 3);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int2 b = __ldg(qb + 4 * j);
            di[j][0] += b.x;
            di[j][2] += b.x;
            di[j][1] += b.y;
            di[j][3] += b.y;
          }
        }
      }
      mbar_wait(xfull + b, parity);
      mbar_wait(bars + b, parity);
      const uint8_t* st = ring + b * R::kSlotBytes;
      const uint8_t* xs = smem + b * L::kXSlot + lane * 4 * wide_words(A8);
      // tile t of the step: one decode, then all NT n-tiles with no branch
      // (in a row group of ntg < NT, n-tile j >= ntg reads other words of
      // the slot, t*ntg + j < 8*NT, into fragments that are never stored:
      // cheaper than a branch an MMA)
      const auto tile = [&](int t) {
        uint32_t a[TILE::kRegs];
        const uint8_t* xt = xs + t * ntg * kTN;
        TILE::decode(st + t * R::kTileBytes, lm, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (A8)
            TILE::mma(di[j], a,
                      *reinterpret_cast<const uint32_t*>(xt + j * kTN));
          else
            TILE::mma(acc[j], a,
                      *reinterpret_cast<const uint2*>(xt + j * kTN));
        }
      };
      if (n == kWideTiles) {  // a whole step, unrolled
#pragma unroll
        for (int t = 0; t < kWideTiles; ++t) tile(t);
      } else {
#pragma unroll 1
        for (int t = 0; t < n; ++t) tile(t);
      }
      __syncwarp();  // every lane has read the step's slots
      if (lane == 0) {
        mbar_arrive(xempty + b);
        if (s + S < nsteps)
          wide_ring_issue<KV, W, S>(job, ring, bars, s + S);
      }
    }
    if (A8 && ch >= 0) descale();
  }

  // The partial fragments, summed over the cluster in rank order.  C
  // element (row, n) of n-tile j sits in lane 4*(row%8) + n/2, register
  // 2*(row/8) + n%2, and fragment row fr is tile row 2*(fr%8) + fr/8, so
  // lane (g, c)'s float4 is rows 2g, 2g+1 of x rows 2c (x, z), 2c+1 (y, w).
  __syncthreads();  // every x slot is read: the buffer takes the fragments
  float4* part = reinterpret_cast<float4*>(smem);
  if (consumer) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < ntg)
        part[(warp * NT + j) * 32 + lane] =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();  // no cluster-wide release fence
  const int items = nact * ntg * 32;
  const int i1 = items * (rank + 1) / cs;
  for (int i = items * rank / cs + tid; i < i1; i += kWideThreads) {
    const int w = i / (ntg * 32), j = (i >> 5) - w * ntg, l = i & 31;
    const int idx = (w * NT + j) * 32 + l;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < cs; ++b) {
      const float4 p = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(smem, b))[idx];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const int row = (mg * kWideWarps + w) * 16 + 2 * (l >> 2);
    const int xr = (y * NT + j) * 8 + 2 * (l & 3);
    if (xr < N)
      *reinterpret_cast<float2*>(out + (size_t)xr * m + row) =
          make_float2(v.x * kMadInv, v.z * kMadInv);
    if (xr + 1 < N)
      *reinterpret_cast<float2*>(out + (size_t)(xr + 1) * m + row) =
          make_float2(v.y * kMadInv, v.w * kMadInv);
  }
  if (cs > 1) cluster.sync();  // every block's sums live until all are read
}

// The launch functions are static: each library built from a source that
// includes this header keeps its own launch state (the SM count, the
// shared-memory attribute set once a device) when two builds are loaded
// into one process, as a function-local static of an inline function or
// template with external linkage would not.

// SMs of the current device, read once per device
static int wide_sm_count(int dev) {
  static int count[64] = {};
  if (dev < 64 && count[dev]) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) count[dev] = n;
  return n;
}

template <class TILE, int NT>
static int launch_wide(const void* x, int x_bf16, const void* tr, void* out,
                       void* ws, int N, int m, int k, cudaStream_t st) {
  constexpr bool A8 = TILE::kA8;
  using L = WideSmem<TILE, NT>;
  const auto kernel = wide_gemv_kernel<TILE, NT>;
  static unsigned long long ready = 0;  // devices that allow L::kBytes
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((ready >> dev) & 1)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= 1ull << dev;
  }
  const int ntot = (N + 7) / 8, rg = (ntot + NT - 1) / NT;
  const dim3 pgrid((k + kChunk - 1) / kChunk, ntot);
  if (x_bf16)
    wide_x_kernel<__nv_bfloat16, A8, TILE::kV><<<pgrid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(ws), N,
        k, NT);
  else
    wide_x_kernel<float, A8, TILE::kV><<<pgrid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<uint8_t*>(ws), N, k, NT);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // split k over a cluster until the blocks fill the SMs, as long as every
  // block keeps a step a stage
  const int mgroups = (m / 16 + kWideWarps - 1) / kWideWarps;
  const int nst = (k / 16 + kWideTiles - 1) / kWideTiles;
  const int nsm = wide_sm_count(dev) * wide_min_blocks<TILE, NT>();
  int cs = 1;
  while (cs < kWideMaxCluster && mgroups * rg * cs < nsm &&
         nst >= 2 * L::kStages * cs)
    cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mgroups * cs, rg);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // a launch of single blocks is cheaper
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(ws),
                         static_cast<const uint8_t*>(tr),
                         static_cast<float*>(out), N, m, k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instance of a call: the fewest n-tiles a warp that hold an even
// share of its rows in the fewest row groups of at most TILE::kMost
// n-tiles
template <class TILE>
static int wide_rows(const void* x, int x_bf16, const void* tr, void* out,
                     void* ws, int N, int m, int k, cudaStream_t st) {
  constexpr int most = TILE::kMost;
  const int ntot = (N + 7) / 8;
  const int rg = (ntot + most - 1) / most, share = (ntot + rg - 1) / rg;
#define QPT_WIDE_NT(NT_) \
  launch_wide<TILE, NT_>(x, x_bf16, tr, out, ws, N, m, k, st)
  if (share <= 2) return QPT_WIDE_NT(2);
  if (share <= 4) return QPT_WIDE_NT(4);
  if (share <= 8) return QPT_WIDE_NT(8);
  if constexpr (most == 12) {
    return QPT_WIDE_NT(12);
  } else {
    if (share <= 12) return QPT_WIDE_NT(12);
    if constexpr (most >= 32)
      if (share > 24) return QPT_WIDE_NT(32);
    if constexpr (most >= 24)
      if (share > 16) return QPT_WIDE_NT(24);
    return QPT_WIDE_NT(16);
  }
#undef QPT_WIDE_NT
}

// A call under the tile policy TILE<MODE, KV, A8> (WideTile: sum2 or
// dualmad; WideTile1: 1mad or 2mad); x: (N, k) float32 or bfloat16, 8 < N
// <= 256, 8-byte aligned; ws: kWideScaleBytes + wide_qsum_bytes + 8 *
// ceil(N / 8) * k * wide_words(a8) bytes, 16-byte aligned
template <template <int, int, bool> class TILE, int MODE, int KV>
static int wide_gemv(const void* x, int x_bf16, const void* tr, void* out,
                     void* ws, int N, int m, int k, int a8, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(x) % 8 ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorMisalignedAddress;
  return a8 ? wide_rows<TILE<MODE, KV, true>>(x, x_bf16, tr, out, ws, N, m,
                                              k, st)
            : wide_rows<TILE<MODE, KV, false>>(x, x_bf16, tr, out, ws, N, m,
                                               k, st);
}

}  // namespace qpt
