// SQ/VQ row-pack decode for Hopper (sm_90a), plain C interface.
//
// Three kernels on one decoder, each computing what a TPU kernel of
// qpalette_tpu/kernels/fused.py computes, on the port's canonical row-pack:
//
//   vq_gemv     replaces _vq_kernel          (vq_decode_matmul): at vec 1
//               and 2 vq_gemv_kernel, at vec 4 vq4_gemv_kernel
//   vq_dequant  replaces _vq_dequant_kernel  (vq_dequant)
//
// The row-pack holds (m, W + 1) 32-bit words, W = P*bits/32 and P = k/vec
// indices a row: index p is the bits-bit window at bit p*bits of its row,
// LSB-first; it straddles two words whenever (p*bits mod 32) + bits > 32,
// and the trailing pad word keeps the last window's second word inside
// the row.  Index p selects row idx of the (2^bits, vec) float32 codebook,
// whose vec values land on columns p*vec .. p*vec + vec - 1 of W_hat.  All
// kernels round the codebook to bf16 once per block, into shared memory, as
// the TPU kernels round every decoded value to bf16.  Since P is a multiple
// of 128 and W = 4*bits*(P/128), the row stride W + 1 is 1 mod 4 words.
//
// GEMV (N <= 8 rows of bf16 x): y = x @ W_hat^T in float32, no Wscale.
// What bounds it: each weight is read once as bits/vec bits of row-pack, so
// at bs=1 the row-pack bytes streamed from device memory; on the SMs, the
// instructions that cut an index out of its words and the shared-memory
// table reads.  Design: a tensor-core GEMV.  A warp computes a 16-row
// m-tile against up to 8 rows of x with mma.m16n8k16.bf16: the decoded
// weights are the A operand, x the B operand (B columns n >= N are zero and
// their C columns are never stored).
//  - A chunk is 128 positions of a row, 4*bits words.  Lane (g, c) takes
//    the contiguous run of positions 32c .. 32c+31 of rows g and g+8 of the
//    m-tile: exactly `bits` whole words of each row.  The k order inside an
//    MMA is free as long as A and B agree: MMA j of a chunk takes, at k slots
//    (2c, 2c+1) and (2c+8, 2c+9), run positions 2j and 2j+1 (vec 2: one
//    bf16x2 entry each), 4j, 4j+1 and 4j+2, 4j+3 (vec 1), or position j
//    (vec 4: its entry's two bf16x2 words, values 0, 1 and 2, 3), so its B
//    is x row g at the run's columns 4j .. 4j+3: 8 bytes, two MMAs a
//    16-byte load.  Every window's word and shift is a compile-time constant; a
//    window across two words is one funnel shift; the pad word is never read.
//  - The stream: the rows are only 4-byte aligned, so a warp copies the
//    16-byte pieces that hold its 16 rows' next chunks (cp.async, 16 bytes a
//    lane, coalesced) into one of the two stages of its ring in shared
//    memory while it multiplies the other stage; lanes read their runs from
//    there.  Only the pack's last rows take a copy size that stops at the
//    pack's end.  vq_gemv_kernel's stages hold two chunks (one at vec 2,
//    bits 9-12), vq4_gemv_kernel's one.
//  - The table holds 32-bit entries in 32 copies, entry e's copy r at word
//    32e + r: lane l reads copy l, its own bank, so the reads never
//    conflict, and an index costs a shift, a LOP3 (mask, OR the lane's byte
//    offset) and one LDS.  vec 2: the bf16x2 of a codebook row.  vec 1 at
//    bits <= 4: a pair table of 2^(2 bits) entries, indexed by the window of
//    two adjacent positions, each the bf16x2 of two weights.  vec 1 at bits
//    5-8: bf16 entries, two reads and a PRMT an A register.  The table is at
//    most 32 KB (8 KB at bits 6, vec 2), so vec 2 at bits 9-12 keeps 16, 8,
//    4 and 2 copies (lane l reads copy l mod copies), and lanes that share a
//    copy can conflict.
//  - Work split: a capped grid of blocks of 8 warps walks the m-tiles (the
//    table is built once a block, while the first stage streams); in an
//    m-tile the warps split its chunks into 8 contiguous ranges, and their C
//    fragments are summed in warp order through shared memory: no atomics,
//    so two launches give the same bits, and a row's sum order depends on
//    k alone (a slice of the rows gives the same bits).  Rows past m read
//    row m - 1 and are never stored.
//
// vq4_gemv_kernel (vec 4, ldlq_4_4 .. ldlq_4_12: 1-3 bits a weight) keeps
// that design with its own constants, chosen on an H100 at Path F's o and
// down (chip_variants.py time vq; PERF.md).  A vec-4 chunk is 512 columns,
// so at o (k = 4096) a warp has one chunk a tile and at down (14336) three
// or four.  What bounds it at bits 8: its multiply, not the stream.  Each
// decoded weight is read from the table as 2 bytes of shared memory
// against 2 bits of row-pack, so the table reads alone take ~80% of the
// stream's time at the card's peaks; on the H100 the multiply (table
// reads, index arithmetic, x reads, MMAs) runs at about 2 TB/s of row-pack
// where the stream alone runs at about 2.6.  What the design does about
// it: 16 copies of each 8-byte entry (one ld.shared.v2 for two A
// registers; 16 is the fewest at which a warp's read takes the least two
// wavefronts, and 8 were 25% slower); stages of one chunk, so that a warp
// starts on its first chunk sooner (deeper rings put an SM's whole share
// in flight at once and were slower: the multiply then waits for nearly
// all of it); MMA j into accumulator j % kVq4Acc, which halves the MMAs'
// dependent chain; x read only by the lanes of its rows n < N.
//
// Dequant: the row-pack -> bf16 W_hat (m, k), natural order.  What bounds
// it: 2 bytes written per weight against bits/(8*vec) read, so the bf16
// writes.  Design: a capped grid of blocks (the table, one bf16 or bf16x2
// entry a codebook row, is loaded once per block); each warp takes 256
// columns of one row at a time, lane l the 8 columns l*8 .. l*8 + 7 (8, 4
// or 2 positions),
// written as one 16-byte store: 512 contiguous bytes a warp.
//
// A row stride padded to 16 bytes, which would let TMA or 16-byte loads
// stream the row-pack, and a tensor-core product fused with the dequant are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;    // GEMV activation rows
constexpr int kAlignPos = 128; // P must be a multiple of this
constexpr int kDequantBlocks = 2112;  // two waves of 8 per SM

template <int VEC>
using Entry = typename std::conditional<
    VEC == 1, uint16_t,
    typename std::conditional<VEC == 2, uint32_t, uint2>::type>::type;

// (2^BITS, VEC) float32 codebook -> bf16 entries in shared memory
template <int BITS, int VEC>
__device__ __forceinline__ void load_table(const float* __restrict__ lut,
                                           Entry<VEC>* tab) {
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x) {
    if constexpr (VEC == 1) {
      tab[i] = __bfloat16_as_ushort(__float2bfloat16_rn(lut[i]));
    } else if constexpr (VEC == 4) {
      const float4 v = reinterpret_cast<const float4*>(lut)[i];
      const auto bf = [](float f) {
        return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
      };
      tab[i] = make_uint2(bf(v.x) | bf(v.y) << 16, bf(v.z) | bf(v.w) << 16);
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

// --- the tensor-core GEMV --------------------------------------------------

constexpr int kTabBytes = 1 << 15;  // the GEMV's largest table
constexpr int kGemvWarps = 8;       // warps a block: they split a tile's k
constexpr int kGemvThreads = 32 * kGemvWarps;

// vq_gemv_kernel's view of a (bits, vec) pair, vec 1 or 2
template <int BITS, int VEC>
struct VqGemv {
  static constexpr bool kPair = VEC == 1 && BITS <= 4;  // a read, two weights
  static constexpr int kWin = kPair ? 2 * BITS : BITS;  // bits a read's window
  static constexpr int kEntries = 1 << kWin;
  static constexpr int kEntryShift = 2;  // log2 entry bytes
  // copies of an entry: 32, or as many as fit in kTabBytes
  static constexpr int kTabBits = 15 - kEntryShift;  // entries kTabBytes holds
  static constexpr int kCopyBits = kTabBits - kWin < 5 ? kTabBits - kWin : 5;
  // entry e at byte e << kShift
  static constexpr int kShift = kEntryShift + kCopyBits;
  static constexpr int kCols = kAlignPos * VEC;  // x columns a chunk
  static constexpr int kMmas = kCols / 16;       // MMAs a chunk
  static constexpr int kLaneCols = kCols / 4;    // a lane's x columns of it
  static_assert((kEntries << kShift) <= kTabBytes, "table size");
};

// entry e of the table: the codebook rounded to bf16 (vec 2: row e as
// bf16x2; the pair table: rows e % 2^BITS and e >> BITS; else row e in the
// low half)
template <int BITS, int VEC>
__device__ __forceinline__ uint32_t table_entry(const float* __restrict__ lut,
                                                int e) {
  const auto bf = [](float v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  };
  if constexpr (VEC == 2) {
    const float2 v = reinterpret_cast<const float2*>(lut)[e];
    return bf(v.x) | bf(v.y) << 16;
  } else if constexpr (VqGemv<BITS, VEC>::kPair) {
    return bf(lut[e & ((1 << BITS) - 1)]) | bf(lut[e >> BITS]) << 16;
  } else {
    return bf(lut[e]);
  }
}

// The table entry of the window at bit o of a lane's run w, read from the
// lane's copy (tab: the table's shared-memory address, the same in every
// lane; lo: the copy's byte offset).  o, and so the word and the shifts,
// is a compile-time constant once the caller's loops are unrolled.
template <class T, int NW>
__device__ __forceinline__ uint32_t lookup(const uint32_t (&w)[NW], int o,
                                           uint32_t tab, uint32_t lo) {
  constexpr int kW = T::kWin, kS = T::kShift;
  const int i = o >> 5, sh = o & 31;
  uint32_t v;  // the window at bits [kS, kS + kW)
  if (sh + kW > 32)  // then sh > 32 - kW >= 20 > kS
    v = __funnelshift_r(w[i], w[i + 1 < NW ? i + 1 : i], sh - kS);
  else if (sh >= kS)
    v = w[i] >> (sh - kS);
  else
    v = w[i] << (kS - sh);
  uint32_t e;
  asm volatile("ld.shared.u32 %0, [%1];"
               : "=r"(e)
               : "r"(((v & (((1u << kW) - 1u) << kS)) | lo) + tab));
  return e;
}

// A register of MMA j from the run w of one row: k slots (2c, 2c+1) for
// hi = 0, (2c+8, 2c+9) for hi = 1
template <class T, int BITS, int VEC>
__device__ __forceinline__ uint32_t a_reg(const uint32_t (&w)[BITS], int j,
                                          int hi, uint32_t tab, uint32_t lo) {
  if constexpr (VEC == 2) {
    return lookup<T>(w, (2 * j + hi) * BITS, tab, lo);
  } else {
    const int q = 4 * j + 2 * hi;
    if constexpr (T::kPair) return lookup<T>(w, q * BITS, tab, lo);
    return __byte_perm(lookup<T>(w, q * BITS, tab, lo),
                       lookup<T>(w, (q + 1) * BITS, tab, lo), 0x5410);
  }
}

// Build the table: a thread loads its entries (all in flight at once) and
// stores each entry's copies, 16 bytes at a time from a lane-rotated
// start so that a warp's stores spread over the banks.
template <int BITS, int VEC>
__device__ __forceinline__ void build_table(const float* __restrict__ lut,
                                            uint32_t* tab) {
  using T = VqGemv<BITS, VEC>;
  constexpr int kCopies = 1 << T::kCopyBits;
  constexpr int kPer = (T::kEntries + kGemvThreads - 1) / kGemvThreads;
  const int tid = threadIdx.x;
  uint32_t ent[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if (tid + r * kGemvThreads < T::kEntries)
      ent[r] = table_entry<BITS, VEC>(lut, tid + r * kGemvThreads);
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = tid + r * kGemvThreads;
    if (e >= T::kEntries) break;
    if constexpr (kCopies == 2) {
      reinterpret_cast<uint2*>(tab)[e] = make_uint2(ent[r], ent[r]);
    } else {
      uint4* dst = reinterpret_cast<uint4*>(tab) + e * (kCopies / 4);
#pragma unroll
      for (int q = 0; q < kCopies / 4; ++q)
        dst[(q + tid) & (kCopies / 4 - 1)] =
            make_uint4(ent[r], ent[r], ent[r], ent[r]);
    }
  }
}

// A warp's ring in shared memory: two stages of CHUNKS chunks.  A row's
// 16*CHUNKS*BITS bytes of a stage start 4*(row & 3) bytes past a 16-byte
// boundary of the row-pack (the row stride is 1 mod 4 words, the pack
// 16-byte aligned): the CHUNKS*BITS + 1 pieces of 16 bytes from that
// boundary hold them, and are copied whole (cp.async, 16 bytes a lane) to
// the row's place in the stage, a stride of ring_row_words apart.
constexpr int run_conflicts(int bits, int s) {  // of the lanes' run reads
  int worst = 0;
  for (int i = 0; i < bits; ++i)
    for (int b = 0; b < 32; ++b) {
      int n = 0;
      for (int g = 0; g < 8; ++g)
        for (int c = 0; c < 4; ++c)
          n += (s * g + (g & 3) + bits * c + i) % 32 == b;
      worst = n > worst ? n : worst;
    }
  return worst;
}

constexpr int ring_row_words(int bits, int pieces) {  // least conflicted
  int best = 4 * pieces;
  for (int s = best + 4; s <= best + 28; s += 4)
    if (run_conflicts(bits, s) < run_conflicts(bits, best)) best = s;
  return best;
}

constexpr int ring_stage_bytes(int bits, int chunks) {  // 16 rows
  return 64 * ring_row_words(bits, chunks * bits + 1);
}

template <int BITS, int CHUNKS>
struct VqRing {
  static constexpr int kChunks = CHUNKS;             // chunks a stage
  static constexpr int kPieces = CHUNKS * BITS + 1;  // 16-byte pieces a row
  static constexpr int kRowBytes = 4 * ring_row_words(BITS, kPieces);
  static constexpr int kStageBytes = ring_stage_bytes(BITS, CHUNKS);
  static constexpr int kStages = 2;  // one multiplied, one streaming
  static constexpr int kCopies = (16 * kPieces + 31) / 32;  // a lane's
  static constexpr int kBytes = kStages * kStageBytes;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
// bytes < 16: the rest of the 16 is zero-filled, nothing past src + bytes
// is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Dynamic shared memory of a block: the table, the warps' C fragments
// (two buffers), the warps' rings: of two-chunk stages where two blocks
// still fit an SM, else of one-chunk stages (vec 2 at bits 9-12)
template <int BITS, int VEC>
struct VqSmem {
  static constexpr int kTab = VqGemv<BITS, VEC>::kEntries
                              << VqGemv<BITS, VEC>::kShift;
  static constexpr int kRed = kTab;
  static constexpr int kRing0 = kRed + 2 * kGemvWarps * 32 * 16;
  static constexpr int kChunks =
      kRing0 + kGemvWarps * 2 * ring_stage_bytes(BITS, 2) <= 113 * 1024 ? 2
                                                                     : 1;
  using Ring = VqRing<BITS, kChunks>;
  static constexpr int kBytes = kRing0 + kGemvWarps * Ring::kBytes;
};

template <int BITS, int VEC>
__global__ void __launch_bounds__(kGemvThreads, 2)
vq_gemv_kernel(const __nv_bfloat16* __restrict__ x,
               const uint32_t* __restrict__ qw, const float* __restrict__ lut,
               float* __restrict__ out, int N, int m, int k, int ldw) {
  using T = VqGemv<BITS, VEC>;
  using L = VqSmem<BITS, VEC>;
  using R = typename L::Ring;
  extern __shared__ __align__(16) uint8_t smem[];
  float4* red = reinterpret_cast<float4*>(smem + L::kRed);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int mtiles = (m + 15) >> 4, nc = k / T::kCols;
  const int c0 = nc * warp / kGemvWarps, c1 = nc * (warp + 1) / kGemvWarps;
  const uint32_t ring = qpt::smem_addr(smem + L::kRing0 + warp * R::kBytes);
  const auto* pack = reinterpret_cast<const uint8_t*>(qw);
  const long long pack_bytes = 4ll * m * ldw;

  // this lane's pieces of a stage: piece u = 32t + lane is piece u %
  // kPieces of row u / kPieces; for the m-tile being issued, its byte
  // offset from the tile's first row
  const auto ok = [&](int t) { return 32 * t + lane < 16 * R::kPieces; };
  uint32_t dst[R::kCopies], src[R::kCopies];
#pragma unroll
  for (int t = 0; t < R::kCopies; ++t) {
    const int u = 32 * t + lane;
    dst[t] = u / R::kPieces * R::kRowBytes + 16 * (u % R::kPieces);
  }
  const uint8_t* tile = pack;  // the first row of the m-tile being issued
  const auto issue_tile = [&](int mt) {
    tile = pack + 64ll * mt * ldw;
#pragma unroll
    for (int t = 0; t < R::kCopies; ++t) {
      const int u = 32 * t + lane;
      const int row = min(16 * mt + u / R::kPieces, m - 1);
      src[t] = 4 * (row - 16 * mt) * ldw - 4 * (row & 3) +
               16 * (u % R::kPieces);
    }
  };
  int imt = blockIdx.x, ich = c0;  // the next stage to issue: its first chunk
  if (c0 < c1) issue_tile(imt);
  const auto issue = [&](int slot) {  // one commit group a call
    if (c0 < c1 && imt < mtiles) {
      const uint32_t st = ring + slot * R::kStageBytes;
      const int off = ich * 16 * BITS;
      if (imt < mtiles - 1 || ich + R::kChunks < nc) {
#pragma unroll
        for (int t = 0; t < R::kCopies; ++t)
          if (ok(t)) cp_async16(st + dst[t], tile + (src[t] + off));
      } else {  // the pack's last rows: read nothing past its end
#pragma unroll
        for (int t = 0; t < R::kCopies; ++t) {
          const uint8_t* p = tile + (src[t] + off);
          const long long left = pack + pack_bytes - p;
          if (ok(t))
            cp_async16(st + dst[t], p,
                       left < 0 ? 0u : left < 16 ? (uint32_t)left : 16u);
        }
      }
      ich += R::kChunks;
      if (ich >= c1) {
        ich = c0;
        imt += gridDim.x;
        if (imt < mtiles) issue_tile(imt);
      }
    }
    cp_async_commit();
  };
  issue(0);  // the first stage streams while the table is built
  build_table<BITS, VEC>(lut, reinterpret_cast<uint32_t*>(smem));
  __syncthreads();
  const uint32_t ta = qpt::smem_addr(smem);
  const uint32_t lo = (lane & ((1 << T::kCopyBits) - 1)) << T::kEntryShift;
  const bool xrow = g < N;  // B columns n >= N stay 0
  const __nv_bfloat16* xp = x + (size_t)(xrow ? g : 0) * k + c * T::kLaneCols;
  uint4 xv[T::kMmas / 2] = {};
  float acc[4];
  // one chunk: its runs from the stage at st (rows g and g+8, words
  // c*BITS ..), multiplied against x's columns of chunk ch
  const auto chunk = [&](uint32_t st, const uint32_t (&run)[2], int ch) {
    uint32_t w[2][BITS];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BITS; ++i)
        asm volatile("ld.shared.u32 %0, [%1];"
                     : "=r"(w[h][i])
                     : "r"(st + run[h] + 4 * i));
    if (xrow) {
#pragma unroll
      for (int j = 0; j < T::kMmas / 2; ++j)
        xv[j] =
            __ldg(reinterpret_cast<const uint4*>(xp + ch * T::kCols) + j);
    }
#pragma unroll
    for (int j = 0; j < T::kMmas; ++j)
      qpt::mma_bf16(acc, a_reg<T, BITS, VEC>(w[0], j, 0, ta, lo),
                    a_reg<T, BITS, VEC>(w[1], j, 0, ta, lo),
                    a_reg<T, BITS, VEC>(w[0], j, 1, ta, lo),
                    a_reg<T, BITS, VEC>(w[1], j, 1, ta, lo),
                    j & 1 ? make_uint2(xv[j / 2].z, xv[j / 2].w)
                          : make_uint2(xv[j / 2].x, xv[j / 2].y));
  };
  int slot = 0;
  for (int mt = blockIdx.x, buf = 0; mt < mtiles;
       mt += gridDim.x, buf ^= 1) {
    uint32_t run[2];  // lane (g, c)'s run of a stage's first chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = min(16 * mt + g + 8 * h, m - 1);
      run[h] = (g + 8 * h) * R::kRowBytes + 4 * (row & 3) + 4 * c * BITS;
    }
    const uint32_t run1[2] = {run[0] + 16 * BITS, run[1] + 16 * BITS};
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = 0.f;
    for (int ch = c0; ch < c1; ch += R::kChunks) {
      cp_async_wait_all();  // this lane's copies of the stage
      __syncwarp();         // and every lane's have landed
      const uint32_t st = ring + slot * R::kStageBytes;
      slot ^= 1;
      issue(slot);  // into the slot the previous stage was read from
      chunk(st, run, ch);
      if (R::kChunks == 2 && ch + 1 < c1) chunk(st, run1, ch + 1);
    }
    // C element (row, n) sits in lane 4*(row%8) + n/2, register
    // 2*(row/8) + n%2; the two buffers let the next m-tile's fragments be
    // written while this one's are read
    red[(buf * kGemvWarps + warp) * 32 + lane] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (tid < 16 * N) {
      const int row = tid & 15, n = tid >> 4;
      const int src_lane = 4 * (row & 7) + (n >> 1);
      const int comp = 2 * (row >> 3) + (n & 1);
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGemvWarps; ++wi)
        v += reinterpret_cast<const float*>(
            &red[(buf * kGemvWarps + wi) * 32 + src_lane])[comp];
      if (16 * mt + row < m) out[(size_t)n * m + 16 * mt + row] = v;
    }
  }
  cp_async_wait_all();
}

// --- the vec-4 GEMV ---------------------------------------------------------

constexpr int kVq4Acc = 2;  // a warp's independent accumulators
constexpr int kVq4MaxCopyBits = 4;  // 16 copies: the 2-wavefront minimum

// vq4_gemv_kernel's view of a bits: 8-byte entries (the bf16x2 of values
// 0, 1 and of 2, 3), entry e's copy r at byte 8 * ((e << kCopyBits) + r);
// a ring of two one-chunk stages a warp
template <int BITS>
struct Vq4 {
  static constexpr int kWin = BITS;
  static constexpr int kCopyBits =
      12 - BITS < kVq4MaxCopyBits ? 12 - BITS : kVq4MaxCopyBits;
  static constexpr int kShift = 3 + kCopyBits;  // entry e at byte e << kShift
  static constexpr int kTab = (1 << BITS) << kShift;
  static constexpr int kCols = kAlignPos * 4;  // x columns a chunk: 512
  static constexpr int kMmas = kCols / 16;     // 32, one a run position
  static constexpr int kLaneCols = kCols / 4;
  using Ring = VqRing<BITS, 1>;
  static constexpr int kRed = kTab;  // the warps' C fragments, two buffers
  static constexpr int kRing0 = kRed + 2 * kGemvWarps * 32 * 16;
  static constexpr int kBytes = kRing0 + kGemvWarps * Ring::kBytes;
  static_assert(kTab <= 1 << 15, "table size");
};

// the two words of the table entry of the window at bit o of a lane's run
// w (tab: the table's shared-memory address; lo: the lane's copy's byte
// offset); o is a compile-time constant once the caller's loops unroll
template <class T, int NW>
__device__ __forceinline__ uint2 vq4_lookup(const uint32_t (&w)[NW], int o,
                                            uint32_t tab, uint32_t lo) {
  constexpr int kW = T::kWin, kS = T::kShift;
  const int i = o >> 5, sh = o & 31;
  uint32_t v;  // the window at bits [kS, kS + kW)
  if (sh + kW > 32)  // then sh > 32 - kW >= 20 > kS
    v = __funnelshift_r(w[i], w[i + 1 < NW ? i + 1 : i], sh - kS);
  else if (sh >= kS)
    v = w[i] >> (sh - kS);
  else
    v = w[i] << (kS - sh);
  uint2 e;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(e.x), "=r"(e.y)
               : "r"(((v & (((1u << kW) - 1u) << kS)) | lo) + tab));
  return e;
}

// Build the table: a thread loads its entries (all in flight at once) and
// stores each entry's copies, 16 bytes (two copies) a store where there are
// two or more, from a lane-rotated start
template <int BITS>
__device__ __forceinline__ void vq4_table(const float* __restrict__ lut,
                                          uint8_t* tab) {
  using T = Vq4<BITS>;
  constexpr int kCopies = 1 << T::kCopyBits;
  constexpr int kPer = ((1 << BITS) + kGemvThreads - 1) / kGemvThreads;
  const int tid = threadIdx.x;
  const auto bf = [](float f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
  };
  uint2 ent[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if (tid + r * kGemvThreads < (1 << BITS)) {
      const float4 v =
          reinterpret_cast<const float4*>(lut)[tid + r * kGemvThreads];
      ent[r] = make_uint2(bf(v.x) | bf(v.y) << 16, bf(v.z) | bf(v.w) << 16);
    }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = tid + r * kGemvThreads;
    if (e >= (1 << BITS)) break;
    if constexpr (kCopies == 1) {
      reinterpret_cast<uint2*>(tab)[e] = ent[r];
    } else {
      uint4* dst = reinterpret_cast<uint4*>(tab) + e * (kCopies / 2);
#pragma unroll
      for (int q = 0; q < kCopies / 2; ++q)
        dst[(q + tid) & (kCopies / 2 - 1)] =
            make_uint4(ent[r].x, ent[r].y, ent[r].x, ent[r].y);
    }
  }
}

// K8 at vec 4 (the design in the note at the top).  A capped grid of blocks
// of 8 warps walks the m-tiles; in an m-tile warp w takes the chunks
// [nc*w/8, nc*(w+1)/8) of every row (none where nc < 8).  A warp
// streams its chunks, one a stage, through a ring of two stages (cp.async:
// one stage in flight while the other is multiplied), on into the next
// tile's.  Lane (g, c) takes the run of positions 32c .. 32c+31 of rows g
// and g+8 of a chunk, `bits` whole words of each row, and MMA j of the
// chunk run position j: its entry's two words are the row's k slots (2c,
// 2c+1) and (2c+8, 2c+9), so B is x row g at the run's columns 4j .. 4j+3.
// MMA j adds into accumulator j % kVq4Acc; a warp's accumulators are
// summed in order, then the 8 warps' C fragments in warp order through
// shared memory: every output element's sum order depends on k alone.
template <int BITS>
__global__ void __launch_bounds__(kGemvThreads, 2)
vq4_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint32_t* __restrict__ qw,
                const float* __restrict__ lut, float* __restrict__ out,
                int N, int m, int k, int ldw) {
  using T = Vq4<BITS>;
  using R = typename T::Ring;
  extern __shared__ __align__(16) uint8_t smem[];
  float4* red = reinterpret_cast<float4*>(smem + T::kRed);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int mtiles = (m + 15) >> 4, nc = k / T::kCols;
  const int c0 = nc * warp / kGemvWarps, c1 = nc * (warp + 1) / kGemvWarps;
  const uint32_t ring = qpt::smem_addr(smem + T::kRing0 + warp * R::kBytes);
  const auto* pack = reinterpret_cast<const uint8_t*>(qw);
  const long long pack_bytes = 4ll * m * ldw;

  // this lane's pieces of a stage: piece u = 32t + lane is piece u %
  // kPieces of row u / kPieces; for the m-tile being issued, its byte
  // offset from the tile's first row
  const auto ok = [&](int t) { return 32 * t + lane < 16 * R::kPieces; };
  uint32_t dst[R::kCopies], src[R::kCopies];
#pragma unroll
  for (int t = 0; t < R::kCopies; ++t) {
    const int u = 32 * t + lane;
    dst[t] = u / R::kPieces * R::kRowBytes + 16 * (u % R::kPieces);
  }
  const uint8_t* tile = pack;  // the first row of the m-tile being issued
  const auto issue_tile = [&](int mt) {
    tile = pack + 64ll * mt * ldw;
#pragma unroll
    for (int t = 0; t < R::kCopies; ++t) {
      const int u = 32 * t + lane;
      const int row = min(16 * mt + u / R::kPieces, m - 1);
      src[t] = 4 * (row - 16 * mt) * ldw - 4 * (row & 3) +
               16 * (u % R::kPieces);
    }
  };
  int imt = blockIdx.x, ich = c0;  // the next stage to issue
  if (c0 < c1) issue_tile(imt);
  const auto issue = [&](int slot) {  // one commit group a call
    if (c0 < c1 && imt < mtiles) {
      const uint32_t st = ring + slot * R::kStageBytes;
      const int off = ich * 16 * BITS;
      if (imt < mtiles - 1 || ich + 1 < nc) {
#pragma unroll
        for (int t = 0; t < R::kCopies; ++t)
          if (ok(t)) cp_async16(st + dst[t], tile + (src[t] + off));
      } else {  // the pack's last rows: read nothing past its end
#pragma unroll
        for (int t = 0; t < R::kCopies; ++t) {
          const uint8_t* p = tile + (src[t] + off);
          const long long left = pack + pack_bytes - p;
          if (ok(t))
            cp_async16(st + dst[t], p,
                       left < 0 ? 0u : left < 16 ? (uint32_t)left : 16u);
        }
      }
      if (++ich == c1) {
        ich = c0;
        imt += gridDim.x;
        if (imt < mtiles) issue_tile(imt);
      }
    }
    cp_async_commit();
  };
  issue(0);  // the first stage streams while the table is built
  vq4_table<BITS>(lut, smem);
  __syncthreads();
  const uint32_t ta = qpt::smem_addr(smem);
  const uint32_t lo = (lane & ((1 << T::kCopyBits) - 1)) << 3;
  const bool xrow = g < N;  // B columns n >= N stay 0
  const __nv_bfloat16* xp = x + (size_t)(xrow ? g : 0) * k + c * T::kLaneCols;
  int slot = 0;
  for (int mt = blockIdx.x, buf = 0; mt < mtiles;
       mt += gridDim.x, buf ^= 1) {
    uint32_t run[2];  // lane (g, c)'s run in a stage (rows g and g+8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = min(16 * mt + g + 8 * h, m - 1);
      run[h] = (g + 8 * h) * R::kRowBytes + 4 * (row & 3) + 4 * c * BITS;
    }
    float acc[kVq4Acc][4] = {};
    for (int ch = c0; ch < c1; ++ch) {
      cp_async_wait_all();  // this lane's copies of the stage
      __syncwarp();         // and every lane's have landed
      const uint32_t st = ring + slot * R::kStageBytes;
      slot ^= 1;
      issue(slot);  // into the slot the previous stage was read from
      uint32_t w[2][BITS];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < BITS; ++i)
          asm volatile("ld.shared.u32 %0, [%1];"
                       : "=r"(w[h][i])
                       : "r"(st + run[h] + 4 * i));
      // 16 bytes of x a pair of MMAs
#pragma unroll
      for (int j = 0; j < T::kMmas / 2; ++j) {
        const uint4 xj =
            xrow ? __ldg(reinterpret_cast<const uint4*>(xp + ch * T::kCols) +
                         j)
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 r0 = vq4_lookup<T>(w[0], (2 * j + h) * BITS, ta, lo);
          const uint2 r1 = vq4_lookup<T>(w[1], (2 * j + h) * BITS, ta, lo);
          qpt::mma_bf16(acc[(2 * j + h) % kVq4Acc], r0.x, r1.x, r0.y, r1.y,
                        h ? make_uint2(xj.z, xj.w) : make_uint2(xj.x, xj.y));
        }
      }
    }
#pragma unroll
    for (int a = 1; a < kVq4Acc; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][r] += acc[a][r];
    // C element (row, n) sits in lane 4*(row%8) + n/2, register
    // 2*(row/8) + n%2; the two buffers let the next m-tile's fragments be
    // written while this one's are read
    red[(buf * kGemvWarps + warp) * 32 + lane] =
        make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    __syncthreads();
    if (tid < 16 * N) {
      const int row = tid & 15, n = tid >> 4;
      const int src_lane = 4 * (row & 7) + (n >> 1);
      const int comp = 2 * (row >> 3) + (n & 1);
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGemvWarps; ++wi)
        v += reinterpret_cast<const float*>(
            &red[(buf * kGemvWarps + wi) * 32 + src_lane])[comp];
      if (16 * mt + row < m) out[(size_t)n * m + 16 * mt + row] = v;
    }
  }
  cp_async_wait_all();
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
    if (col0 >= k) continue;  // k is a multiple of 8: whole lanes only
    const uint32_t* rw = qw + (size_t)row * ldw;
    const int p0 = col0 / VEC;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (VEC == 4) {
        const uint2 e = tab[index_at<BITS>(rw, p0 + q / 2)];
        v[q] = q & 1 ? e.y : e.x;
      } else if constexpr (VEC == 1) {
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
  constexpr int smem = VqSmem<BITS, VEC>::kBytes;
  static unsigned long long ready = 0;  // devices it may take smem on
  static int per_sm = 0;  // blocks of this instance an SM holds
  const auto kernel = vq_gemv_kernel<BITS, VEC>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !((ready >> dev) & 1))) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kGemvThreads, smem);
    if (e == cudaSuccess && dev < 64) ready |= 1ull << dev;
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int mtiles = (m + 15) / 16;
  const int grid = mtiles < per_sm * sms ? mtiles : per_sm * sms;
  kernel<<<grid, kGemvThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(lut), static_cast<float*>(out), N, m, k, ldw);
  return (int)cudaGetLastError();
}

template <int BITS>
int gemv4(const void* x, const void* qw, const void* lut, void* out, int N,
          int m, int k, int ldw, cudaStream_t st) {
  constexpr int smem = Vq4<BITS>::kBytes;
  static unsigned long long ready = 0;  // devices it may take smem on
  static int per_sm = 0;  // blocks of this instance an SM holds
  const auto kernel = vq4_gemv_kernel<BITS>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !((ready >> dev) & 1))) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kGemvThreads, smem);
    if (e == cudaSuccess && dev < 64) ready |= 1ull << dev;
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int mtiles = (m + 15) / 16;
  const int grid = mtiles < per_sm * sms ? mtiles : per_sm * sms;
  kernel<<<grid, kGemvThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(lut), static_cast<float*>(out), N, m, k, ldw);
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

template <int BITS>
int dequant4(const void* qw, const void* lut, void* w, int m, int k, int ldw,
             cudaStream_t st) {
  return dequant<BITS, 4>(qw, lut, w, m, k, ldw, st);
}

// words a row, pad word included; 0 for shapes the kernel does not take:
// the GEMV wants P a multiple of kAlignPos, the dequant k a multiple of 8
// (a lane's 16-byte store)
int row_words(int m, int k, int bits, int vec, bool gemv) {
  if (m <= 0 || k <= 0 || (vec != 1 && vec != 2 && vec != 4) || k % vec)
    return 0;
  const int P = k / vec;
  if (gemv ? P % kAlignPos : k % 8) return 0;
  return (P * bits + 31) / 32 + 1;
}

}  // namespace

// The 26 (bits, vec) pairs of the ldlq palette: vec 1 with bits 2..8, vec 2
// with bits 3..12 (FN<BITS, VEC>), vec 4 with bits 4..12 (FN4<BITS>).
#define QPT_VQ_CASES(FN, FN4, ...)                       \
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
    case 64 + 4: return FN4<4>(__VA_ARGS__);             \
    case 64 + 5: return FN4<5>(__VA_ARGS__);             \
    case 64 + 6: return FN4<6>(__VA_ARGS__);             \
    case 64 + 7: return FN4<7>(__VA_ARGS__);             \
    case 64 + 8: return FN4<8>(__VA_ARGS__);             \
    case 64 + 9: return FN4<9>(__VA_ARGS__);             \
    case 64 + 10: return FN4<10>(__VA_ARGS__);           \
    case 64 + 11: return FN4<11>(__VA_ARGS__);           \
    case 64 + 12: return FN4<12>(__VA_ARGS__);           \
    default: return (int)cudaErrorInvalidValue;          \
  }

// x: (N, k) bfloat16, 1 <= N <= 8; qweight: the canonical row-pack
// (m, P*bits/32 + 1) words, P = k/vec a multiple of 128; lut: (2^bits,
// vec) float32, 8-byte aligned (16 at vec 4); out: (N, m) float32.  Each function
// launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int vq_gemv(const void* x, const void* qweight, const void* lut,
                       void* out, int N, int m, int k, int bits, int vec,
                       void* stream) {
  const int ldw = row_words(m, k, bits, vec, true);
  if (!ldw || N < 1 || N > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QPT_VQ_CASES(gemv, gemv4, x, qweight, lut, out, N, m, k, ldw, st)
}

// w: (m, k) bfloat16, 16-byte aligned, W_hat in natural order.  The
// dequant takes every bits from 1 to 12 at vec 1, 2 and 4: the palette's
// 26 pairs and the 10 below, which have no GEMV.
extern "C" int vq_dequant(const void* qweight, const void* lut, void* w,
                          int m, int k, int bits, int vec, void* stream) {
  const int ldw = row_words(m, k, bits, vec, false);
  if (!ldw) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec * 16 + bits) {
    case 16 + 1: return dequant<1, 1>(qweight, lut, w, m, k, ldw, st);
    case 16 + 9: return dequant<9, 1>(qweight, lut, w, m, k, ldw, st);
    case 16 + 10: return dequant<10, 1>(qweight, lut, w, m, k, ldw, st);
    case 16 + 11: return dequant<11, 1>(qweight, lut, w, m, k, ldw, st);
    case 16 + 12: return dequant<12, 1>(qweight, lut, w, m, k, ldw, st);
    case 32 + 1: return dequant<1, 2>(qweight, lut, w, m, k, ldw, st);
    case 32 + 2: return dequant<2, 2>(qweight, lut, w, m, k, ldw, st);
    case 64 + 1: return dequant<1, 4>(qweight, lut, w, m, k, ldw, st);
    case 64 + 2: return dequant<2, 4>(qweight, lut, w, m, k, ldw, st);
    case 64 + 3: return dequant<3, 4>(qweight, lut, w, m, k, ldw, st);
    default: break;
  }
  QPT_VQ_CASES(dequant, dequant4, qweight, lut, w, m, k, ldw, st)
}
