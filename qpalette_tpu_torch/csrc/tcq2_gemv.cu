// K1 in the V=2 modes: sum2 (tcq2s) and dualmad (tcq2), KV 4..10.  Both
// modes at N <= 8 rows run v2_gemv_kernel below; both at N > 8 run the
// template of arith.cuh.
//
// v2_gemv_kernel: y = x @ W_hat^T in float32 for N <= 8 rows of x, no
// Wscale.  Replaces qpalette_tpu/kernels/fused.py::_arith_kernel in sum2
// and dualmad modes (reached through _arith_decode_matmul from
// tcq2_decode_matmul) for decode, both variants: a8 (x quantized to int8
// per 512-column chunk, one absmax scale a chunk over all N rows) and
// exact (x rounded to bf16).
//
// What bounds it: every weight is read once as KV/2 bits of packed
// trellis, so the least time is the trellis bytes over device memory
// rate.  What held the template from that on an H100: two block barriers
// per 512-column chunk with 2-5 KB of words in flight a block, an absmax
// prologue over every chunk before the first trellis load, and ~50
// instructions a tile (four __dp4a a lane).  Design:
//  - Tensor cores.  In the V=2 paired-K-major tile order, state s = 16t +
//    row covers columns (2t, 2t+1) of row.  Lane l (g = l/4, c = l%4)
//    decodes states s0 = 16c + 2g, s0+1, s0+64, s0+65: rows 2g and 2g+1
//    of pairs c and c+4, fragment rows g and g+8 (the epilogue un-permutes
//    them).  One funnel shift of two words gives s0 and s0+1, another
//    s0+64 and s0+65 (hopper.cuh): 4 word reads and 2 funnel shifts a
//    tile.
//  - The modes differ only in how a state's 16-bit window u gives its
//    weights w0 (column 2t) and w1 (column 2t+1), so only the tile
//    function depends on the mode (sb = signed bytes):
//      sum2:    h = u*34038481 + 76625530; w0 = sb0+sb1, w1 = sb2+sb3
//      dualmad: h1 = u*34038481, h2 = u*264435761; wi = sb sum of hi
//  - a8: a hash word's four signed bytes are an A register of an
//    mma.m16n8k32.s8 as they stand (a0 = s0, a1 = s0+1, a2 = s0+64, a3 =
//    s0+65); B repeats x bytes so that the product is w*q.  sum2, one MMA:
//    B words [q(2p), q(2p), q(2p+1), q(2p+1)] of x row g for pairs p = c,
//    c+4.  dualmad, two MMAs: h1 against [q(2p)]*4, h2 against
//    [q(2p+1)]*4.  Exact in int32: |w| <= 512 and |q| <= 127, so a
//    512-column chunk's partial is at most 512*512*127 < 2^25.  At each
//    chunk boundary the warp adds (float)C * scale into an f32 fragment,
//    as the template does for its chunk sums.
//  - exact, sum2: w0 and w1 lie in [-256, 254], which bf16 holds exactly;
//    a state's pair is one bf16x2 A register of one mma.m16n8k16.bf16 in
//    natural column order, against bf16 x; each product is exact in f32.
//  - exact, dualmad: its weights lie in [-512, 508], and bf16 (8
//    significant bits) does not hold 254 of those 1021 integers: the odd
//    ones beyond +-256, ~4% of the weights of random words, would round,
//    errors of 1e-4 to 1e-3 of max|y| over a 4096-wide row.  tf32 holds
//    every integer up to 2^11 and every bf16 value, so dualmad takes two
//    mma.m16n8k8.tf32 a tile, one per column parity: register r of lane
//    (g, c) is fragment row g + 8*(r&1) at k = c + 4*(r>>1), w0 of the
//    four states (MMA 1) or w1 (MMA 2), against x columns 2c and 2c+8
//    (MMA 1) or 2c+1 and 2c+9 (MMA 2); each product is exact in f32.
//  - x for a8: each warp computes the scales of the chunks its k-range
//    touches (over the whole chunk and all rows) while its first slots
//    stream; per slot it quantizes the slot's 256 columns x N rows into a
//    2 KB per-warp buffer, one word [q(2c), q(2c+1), q(8+2c), q(9+2c)] a
//    (tile, row, c) at 32*tile + 4*row + c, so that lane (g, c) reads its
//    word of a tile at a fixed offset (the stores hit 4 banks, once a
//    slot); a lane's B words are that one word under byte permutes (two
//    for sum2, four for dualmad).  No block barrier before the epilogue.
//  - The stream of hopper.cuh, in slots of 16 tiles: a warp owns whole
//    slots of one m-tile's k range and streams them through its own
//    double buffer of cp.async.bulk copies.  A block is one m-tile (every
//    Llama-3.1-8B shape has >= 256, so no cluster); its 8 warps'
//    fragments are summed in a fixed order through shared memory: no
//    atomics, and two launches give the same bits.
//
// What holds it on an H100 (a 215 decode step's sum2 calls at 25-55% of
// their bound): ~14 SM cycles a tile at full occupancy, set by the
// integer instructions a warp issues (the decode's funnel shifts, masks,
// IMADs and byte permutes, and each slot's quantization, barrier wait and
// address arithmetic), not by the trellis bytes.  Tried and slower:
// 3-slot rings; 8-tile slots (more instructions a tile around each slot);
// quantizing a whole chunk of x at once (a stall at every chunk); 1, 2 or
// 4 warps a block (fewer warps for the small-m shapes); 3, 5 or 6 blocks
// an SM.

#include "arith.cuh"
#include "hopper.cuh"

using namespace qpt;

namespace {

constexpr int kV2MaxRows = 8;
constexpr int kV2BlocksPerSM = 4;
constexpr int kV2Tiles = 16;  // k-tiles a ring slot (one bulk copy)
constexpr int kSlotCols = kV2Tiles * 16;  // a slot never straddles a chunk
static_assert(kChunk % kSlotCols == 0, "slots tile the chunks");
// chunks a warp's range touches at most: it holds at most
// ceil(nslots / kWarps) slots of a k <= kChunk * kMaxChunks
constexpr int kWarpChunks = kMaxChunks / kWarps + 1;

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

// dualmad: the signed byte sum of the hash h as an f32 (tf32) A register:
// __dp4a adds the sum to the bits of 1.5*2^23, the FADD takes that away
// (a plain int-to-float conversion spills at the register cap in one
// instance)
__device__ __forceinline__ uint32_t dual_weight(uint32_t h) {
  const int v = __dp4a((int)h, 0x01010101, 0x4b400000);
  return __float_as_uint(__fsub_rn(__int_as_float(v), 12582912.0f));
}

// a8: one tile against the quantized x word xw of this lane's row and c
template <int MODE, int KV>
__device__ __forceinline__ void tile_s8(const uint8_t* wt, const LaneMap& lm,
                                        uint32_t xw, int (&d)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  if constexpr (MODE == kSum2) {
    mma_s8(d, sum2_hash(f0), sum2_hash(f0 >> KV), sum2_hash(f1),
           sum2_hash(f1 >> KV), __byte_perm(xw, 0, 0x1100),
           __byte_perm(xw, 0, 0x3322));
  } else {
    const uint32_t u0 = f0 & 0xffffu, u1 = (f0 >> KV) & 0xffffu;
    const uint32_t u2 = f1 & 0xffffu, u3 = (f1 >> KV) & 0xffffu;
    mma_s8(d, u0 * kMad1A, u1 * kMad1A, u2 * kMad1A, u3 * kMad1A,
           __byte_perm(xw, 0, 0x0000), __byte_perm(xw, 0, 0x2222));
    mma_s8(d, u0 * kMad2A, u1 * kMad2A, u2 * kMad2A, u3 * kMad2A,
           __byte_perm(xw, 0, 0x1111), __byte_perm(xw, 0, 0x3333));
  }
}

// exact: one tile against bf16 x columns (2c, 2c+1) and (8+2c, 9+2c), each
// pair a bf16x2 word with the lower column in the low half
template <int MODE, int KV>
__device__ __forceinline__ void tile_exact(const uint8_t* wt,
                                           const LaneMap& lm, uint2 b,
                                           float (&d)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  if constexpr (MODE == kSum2) {
    mma_bf16(d, sum2_bf16x2(f0), sum2_bf16x2(f0 >> KV), sum2_bf16x2(f1),
             sum2_bf16x2(f1 >> KV), b);
  } else {
    const uint32_t u0 = f0 & 0xffffu, u1 = (f0 >> KV) & 0xffffu;
    const uint32_t u2 = f1 & 0xffffu, u3 = (f1 >> KV) & 0xffffu;
    // a bf16 value as tf32 is its bits in the high half of the word
    mma_tf32(d, dual_weight(u0 * kMad1A), dual_weight(u1 * kMad1A),
             dual_weight(u2 * kMad1A), dual_weight(u3 * kMad1A), b.x << 16,
             b.y << 16);
    mma_tf32(d, dual_weight(u0 * kMad2A), dual_weight(u1 * kMad2A),
             dual_weight(u2 * kMad2A), dual_weight(u3 * kMad2A),
             b.x & 0xffff0000u, b.y & 0xffff0000u);
  }
}

// Dynamic shared memory of a block: the warps' rings, their a8 x words (a
// slot's tiles x 8 rows x 4 words), chunk scales and slot barriers
template <int KV, bool A8>
struct V2Smem {
  static constexpr int kRing = kSlots * Ring<KV, kV2Tiles>::kSlotBytes;
  static constexpr int kXq = A8 ? kV2Tiles * 32 * 4 : 0;
  static constexpr int kXq0 = kWarps * kRing;
  static constexpr int kSx0 = kXq0 + kWarps * kXq;
  static constexpr int kBars0 = kSx0 + kWarps * kWarpChunks * 8;
  static constexpr int kBytes = kBars0 + kWarps * kSlots * 8;
};

template <typename XT, int MODE, int KV, bool A8>
__global__ void __launch_bounds__(kThreads, kV2BlocksPerSM)
v2_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ tr,
                 float* __restrict__ out, int N, int m, int k) {
  using R = Ring<KV, kV2Tiles>;
  using L = V2Smem<KV, A8>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  uint8_t* ring = smem + warp * L::kRing;
  uint32_t* xq = reinterpret_cast<uint32_t*>(smem + L::kXq0 + warp * L::kXq);
  float2* sx = reinterpret_cast<float2*>(smem + L::kSx0) + warp * kWarpChunks;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + L::kBars0) + warp * kSlots;

  // this warp's k-tiles of m-tile blockIdx.x, in whole slots
  const int kt = k >> 4;
  const int nsl = (kt + kV2Tiles - 1) / kV2Tiles;
  const int ta = min(kt, nsl * warp / kWarps * kV2Tiles);
  const int tb = min(kt, nsl * (warp + 1) / kWarps * kV2Tiles);
  const WarpJob job{tr + ((size_t)blockIdx.x * kt + ta) * R::kTileBytes,
                    tb - ta, 16 * ta};
  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue_first<KV, kV2Tiles>(job, ring, bars);
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
    for (int i = lane; i < kV2Tiles * 32; i += 32) xq[i] = 0u;
  }
  __syncwarp();

  const LaneMap lm = lane_map<KV>(16 * c + 2 * g);
  const bool xrow = g < N;  // B columns n >= N stay 0
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int di[4] = {0, 0, 0, 0};  // a8: the current chunk's int32 fragment
  int ch = -1;
  float2 sc = make_float2(0.f, 0.f);  // a8: the current chunk's scale, 1/scale
  const auto descale = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r] = __fadd_rn(acc[r], __fmul_rn((float)di[r], sc.x));
      di[r] = 0;
    }
  };
  // two slots an iteration, so that each slot's shared-memory addresses
  // are fixed offsets from the ring
  const int nslot = (job.nt + kV2Tiles - 1) / kV2Tiles;
  for (int it0 = 0; it0 < nslot; it0 += kSlots) {
    const uint32_t parity = (it0 / kSlots) & 1;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int it = it0 + slot;
      if (it >= nslot) break;
      const uint8_t* st = ring + slot * R::kSlotBytes;
      const int col = job.col0 + it * kSlotCols;
      const int n = min(kV2Tiles, job.nt - it * kV2Tiles);
      if constexpr (A8) {
        if ((unsigned)col / kChunk != (unsigned)ch) {
          if (ch >= 0) descale();
          ch = (unsigned)col / kChunk;
          sc = sx[ch - ch0];
        }
        // lane (g, c) quantizes columns 2c, 2c+1, 8+2c, 9+2c of tiles t =
        // g and g+8, each row r into word t*32 + (r << 2) + c: the word
        // that lane 4r + c reads as xq[t*32 + lane]
#pragma unroll
        for (int h = 0; h < kV2Tiles / 8; ++h) {
          const int t = g + 8 * h;
          if (t < n) {
            const XT* xp = x + col + 16 * t + 2 * c;
#pragma unroll 1
            for (int r = 0; r < N; ++r, xp += k) {
              const float2 v0 = load_x2(xp), v1 = load_x2(xp + 8);
              xq[t * 32 + (r << 2) + c] =
                  quant8(v0.x, sc.y) | quant8(v0.y, sc.y) << 8 |
                  quant8(v1.x, sc.y) << 16 | quant8(v1.y, sc.y) << 24;
            }
          }
        }
        __syncwarp();
        mbar_wait(bars + slot, parity);
        if (n == kV2Tiles) {
#pragma unroll
          for (int j = 0; j < kV2Tiles; ++j)
            tile_s8<MODE, KV>(st + j * R::kTileBytes, lm,
                              xq[j * 32 + lane], di);
        } else {
#pragma unroll 1
          for (int j = 0; j < n; ++j)
            tile_s8<MODE, KV>(st + j * R::kTileBytes, lm,
                              xq[j * 32 + lane], di);
        }
      } else {
        const XT* xp = x + (size_t)(xrow ? g : 0) * k + col + 2 * c;
        const auto xload = [&](int j) {
          return xrow ? make_uint2(x_bf16x2(xp + 16 * j),
                                   x_bf16x2(xp + 16 * j + 8))
                      : make_uint2(0u, 0u);
        };
        if (n == kV2Tiles) {
#pragma unroll
          for (int h = 0; h < kV2Tiles / 8; ++h) {
            uint2 b[8];  // the first 8 do not wait for the slot
#pragma unroll
            for (int j = 0; j < 8; ++j) b[j] = xload(8 * h + j);
            if (h == 0) mbar_wait(bars + slot, parity);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              tile_exact<MODE, KV>(st + (8 * h + j) * R::kTileBytes, lm,
                                   b[j], acc);
          }
        } else {
          mbar_wait(bars + slot, parity);
#pragma unroll 1
          for (int j = 0; j < n; ++j)
            tile_exact<MODE, KV>(st + j * R::kTileBytes, lm, xload(j), acc);
        }
      }
      __syncwarp();  // every lane has read the slot and the x words
      if (lane == 0 && it + kSlots < nslot)
        issue_slot<KV, kV2Tiles>(job, ring, bars, it + kSlots);
    }
  }
  if (A8 && ch >= 0) descale();

  // the 8 warps' fragments, summed in warp order: C element (fragment row
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
    for (int w = 0; w < kWarps; ++w)
      v += reinterpret_cast<const float*>(smem + w * L::kRing)[src * 4 + comp];
    out[(size_t)nn * m + blockIdx.x * 16 + row] = v * kMadInv;
  }
}

template <typename XT, int MODE, int KV, bool A8>
int launch_v2(const void* x, const void* tr, void* out, int N, int m, int k,
              cudaStream_t st) {
  constexpr int smem = V2Smem<KV, A8>::kBytes;
  if (reinterpret_cast<uintptr_t>(x) % 8)  // x is read 4-8 bytes at a time
    return (int)cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static unsigned long long ready = 0;  // devices that allow `smem` bytes
  if (dev >= 64 || !((ready >> dev) & 1)) {
    e = cudaFuncSetAttribute(v2_gemv_kernel<XT, MODE, KV, A8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= 1ull << dev;
  }
  v2_gemv_kernel<XT, MODE, KV, A8><<<m / 16, kThreads, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(tr),
      static_cast<float*>(out), N, m, k);
  return (int)cudaGetLastError();
}

template <int MODE, int KV>
int v2_variants(const void* x, int x_bf16, const void* tr, void* out, int N,
                int m, int k, int a8, cudaStream_t st) {
  if (x_bf16)
    return a8 ? launch_v2<__nv_bfloat16, MODE, KV, true>(x, tr, out, N, m,
                                                         k, st)
              : launch_v2<__nv_bfloat16, MODE, KV, false>(x, tr, out, N, m,
                                                          k, st);
  return a8 ? launch_v2<float, MODE, KV, true>(x, tr, out, N, m, k, st)
            : launch_v2<float, MODE, KV, false>(x, tr, out, N, m, k, st);
}

}  // namespace

#define QPT_KV_CASES(CALL)                      \
  switch (KV) {                                 \
    case 4:  return CALL(4);                    \
    case 5:  return CALL(5);                    \
    case 6:  return CALL(6);                    \
    case 7:  return CALL(7);                    \
    case 8:  return CALL(8);                    \
    case 9:  return CALL(9);                    \
    case 10: return CALL(10);                   \
    default: return (int)cudaErrorInvalidValue; \
  }
#define QPT_SUM2(KV_) \
  v2_variants<kSum2, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_DUALMAD(KV_) \
  v2_variants<kDualmad, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_SUM2_WIDE(KV_) \
  gemv_variants<kSum2, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_DUALMAD_WIDE(KV_) \
  gemv_variants<kDualmad, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)

// x: (N, k) float32 (x_bf16 == 0) or bfloat16, 1 <= N <= 256, 8-byte
// aligned; tr: canonical (m/16*k/16, 4*KV) words, 16-byte aligned; out:
// (N, m) float32; mode 0 = sum2, 1 = dualmad.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernels do not take).
extern "C" int tcq2_gemv(const void* x, int x_bf16, const void* tr,
                         void* out, int N, int m, int k, int KV, int mode,
                         int a8, void* stream) {
  if (bad_gemv_args(N, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = N <= kV2MaxRows;
  if (mode == 0 && narrow) QPT_KV_CASES(QPT_SUM2)
  if (mode == 1 && narrow) QPT_KV_CASES(QPT_DUALMAD)
  if (mode == 0) QPT_KV_CASES(QPT_SUM2_WIDE)
  if (mode == 1) QPT_KV_CASES(QPT_DUALMAD_WIDE)
  return (int)cudaErrorInvalidValue;
}
