// K1 in the V=2 modes: sum2 (tcq2s) and dualmad (tcq2), KV 4..10.  sum2 at
// N <= 8 rows runs sum2_gemv_kernel below; dualmad at any N and sum2 at
// N > 8 run the template of arith.cuh.
//
// sum2_gemv_kernel: y = x @ W_hat^T in float32 for N <= 8 rows of x, no
// Wscale.  Replaces qpalette_tpu/kernels/fused.py::_arith_kernel in sum2
// mode (reached through _arith_decode_matmul from tcq2_decode_matmul) for
// decode, both variants: a8 (x quantized to int8 per 512-column chunk, one
// absmax scale a chunk over all N rows) and exact (x rounded to bf16).
//
// What bounds it: every weight is read once as KV/2 bits of packed
// trellis, so the least time is the trellis bytes over device memory
// rate.  What held the template from that on an H100: two block barriers
// per 512-column chunk with 2-5 KB of words in flight a block, an absmax
// prologue over every chunk before the first trellis load, and ~50
// instructions a tile (four __dp4a a lane).  Design:
//  - Tensor cores.  In sum2's paired-K-major tile order, state s = 16t +
//    row covers columns (2t, 2t+1) of row.  Lane l (g = l/4, c = l%4)
//    decodes states s0 = 16c + 2g, s0+1, s0+64, s0+65: rows 2g and 2g+1
//    of pairs c and c+4, fragment rows g and g+8 (the epilogue un-permutes
//    them).  One funnel shift of two words gives s0 and s0+1, another
//    s0+64 and s0+65 (hopper.cuh): 4 word reads and 2 funnel shifts a
//    tile.
//  - a8: the hash h = u*34038481 + 76625530 of a state, four signed bytes
//    [sb0, sb1, sb2, sb3], is an A register of one mma.m16n8k32.s8 as it
//    stands (a0 = s0, a1 = s0+1, a2 = s0+64, a3 = s0+65), against B words
//    [q(2p), q(2p), q(2p+1), q(2p+1)] of x row g for pairs p = c, c+4: the
//    product is w0*q(2p) + w1*q(2p+1) with w0 = sb0+sb1, w1 = sb2+sb3,
//    exact in int32 (|partial| <= 512*256*127 < 2^31 over a chunk).  At
//    each chunk boundary the warp adds (float)C * scale into an f32
//    fragment, as the template does for its chunk sums.
//  - exact: w0 and w1 lie in [-256, 254], which bf16 holds exactly; a
//    state's pair is one bf16x2 A register of one mma.m16n8k16.bf16 in
//    natural column order, against bf16 x; each product is exact in f32.
//  - x for a8: each warp computes the scales of the chunks its k-range
//    touches (over the whole chunk and all rows) while its first slots
//    stream; per slot it quantizes the slot's 256 columns x N rows into a
//    2 KB per-warp buffer, one word [q(2c), q(2c+1), q(8+2c), q(9+2c)] a
//    (tile, row, c) at 32*tile + 4*row + c, so that lane (g, c) reads its
//    word of a tile at a fixed offset (the stores hit 4 banks, once a
//    slot); a lane's two B words are that one word under two byte
//    permutes.  No block barrier before the epilogue.
//  - The stream of hopper.cuh, in slots of 16 tiles: a warp owns whole
//    slots of one m-tile's k range and streams them through its own
//    double buffer of cp.async.bulk copies.  A block is one m-tile (every
//    Llama-3.1-8B shape has >= 256, so no cluster); its 8 warps'
//    fragments are summed in a fixed order through shared memory: no
//    atomics, and two launches give the same bits.
//
// What holds it on an H100 (a 215 decode step's calls at 25-55% of their
// bound): ~14 SM cycles a tile at full occupancy, set by the integer
// instructions a warp issues (the decode's funnel shifts, masks, IMADs and
// byte permutes, and each slot's quantization, barrier wait and address
// arithmetic), not by the trellis bytes.  Tried and slower: 3-slot rings;
// 8-tile slots (more instructions a tile around each slot); quantizing a
// whole chunk of x at once (a stall at every chunk); 1, 2 or 4 warps a
// block (fewer warps for the small-m shapes); 3, 5 or 6 blocks an SM.

#include "arith.cuh"
#include "hopper.cuh"

using namespace qpt;

namespace {

constexpr int kSum2MaxRows = 8;
constexpr int kSum2BlocksPerSM = 4;
constexpr int kSum2Tiles = 16;  // k-tiles a ring slot (one bulk copy)
constexpr int kSlotCols = kSum2Tiles * 16;  // a slot never straddles a chunk
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

// a8: one tile against the quantized x word xw of this lane's row and c
template <int KV>
__device__ __forceinline__ void tile_s8(const uint8_t* wt, const LaneMap& lm,
                                        uint32_t xw, int (&d)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  mma_s8(d, sum2_hash(f0), sum2_hash(f0 >> KV), sum2_hash(f1),
         sum2_hash(f1 >> KV), __byte_perm(xw, 0, 0x1100),
         __byte_perm(xw, 0, 0x3322));
}

// exact: one tile against bf16 x columns (2c, 2c+1) and (8+2c, 9+2c)
template <int KV>
__device__ __forceinline__ void tile_bf16(const uint8_t* wt,
                                          const LaneMap& lm, uint2 b,
                                          float (&d)[4]) {
  uint32_t f0, f1;
  lane_windows(wt, lm, f0, f1);
  mma_bf16(d, sum2_bf16x2(f0), sum2_bf16x2(f0 >> KV), sum2_bf16x2(f1),
           sum2_bf16x2(f1 >> KV), b);
}

// Dynamic shared memory of a block: the warps' rings, their a8 x words (a
// slot's tiles x 8 rows x 4 words), chunk scales and slot barriers
template <int KV, bool A8>
struct Sum2Smem {
  static constexpr int kRing = kSlots * Ring<KV, kSum2Tiles>::kSlotBytes;
  static constexpr int kXq = A8 ? kSum2Tiles * 32 * 4 : 0;
  static constexpr int kXq0 = kWarps * kRing;
  static constexpr int kSx0 = kXq0 + kWarps * kXq;
  static constexpr int kBars0 = kSx0 + kWarps * kWarpChunks * 8;
  static constexpr int kBytes = kBars0 + kWarps * kSlots * 8;
};

template <typename XT, int KV, bool A8>
__global__ void __launch_bounds__(kThreads, kSum2BlocksPerSM)
sum2_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ tr,
                 float* __restrict__ out, int N, int m, int k) {
  using R = Ring<KV, kSum2Tiles>;
  using L = Sum2Smem<KV, A8>;
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
  const int nsl = (kt + kSum2Tiles - 1) / kSum2Tiles;
  const int ta = min(kt, nsl * warp / kWarps * kSum2Tiles);
  const int tb = min(kt, nsl * (warp + 1) / kWarps * kSum2Tiles);
  const WarpJob job{tr + ((size_t)blockIdx.x * kt + ta) * R::kTileBytes,
                    tb - ta, 16 * ta};
  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue_first<KV, kSum2Tiles>(job, ring, bars);
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
    for (int i = lane; i < kSum2Tiles * 32; i += 32) xq[i] = 0u;
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
  const int nslot = (job.nt + kSum2Tiles - 1) / kSum2Tiles;
  for (int it0 = 0; it0 < nslot; it0 += kSlots) {
    const uint32_t parity = (it0 / kSlots) & 1;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int it = it0 + slot;
      if (it >= nslot) break;
      const uint8_t* st = ring + slot * R::kSlotBytes;
      const int col = job.col0 + it * kSlotCols;
      const int n = min(kSum2Tiles, job.nt - it * kSum2Tiles);
      if constexpr (A8) {
        if ((unsigned)col / kChunk != (unsigned)ch) {
          if (ch >= 0) descale();
          ch = (unsigned)col / kChunk;
          sc = sx[ch - ch0];
        }
        // lane (g, c) quantizes tile g's columns 2c, 2c+1, 8+2c, 9+2c of
        // each row r into word g*32 + ((r ^ g) << 2 | c)
#pragma unroll
        for (int h = 0; h < kSum2Tiles / 8; ++h) {
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
        if (n == kSum2Tiles) {
#pragma unroll
          for (int j = 0; j < kSum2Tiles; ++j)
            tile_s8<KV>(st + j * R::kTileBytes, lm,
                        xq[j * 32 + lane], di);
        } else {
#pragma unroll 1
          for (int j = 0; j < n; ++j)
            tile_s8<KV>(st + j * R::kTileBytes, lm,
                        xq[j * 32 + lane], di);
        }
      } else {
        const XT* xp = x + (size_t)(xrow ? g : 0) * k + col + 2 * c;
        const auto xload = [&](int j) {
          return xrow ? make_uint2(x_bf16x2(xp + 16 * j),
                                   x_bf16x2(xp + 16 * j + 8))
                      : make_uint2(0u, 0u);
        };
        if (n == kSum2Tiles) {
#pragma unroll
          for (int h = 0; h < kSum2Tiles / 8; ++h) {
            uint2 b[8];  // the first 8 do not wait for the slot
#pragma unroll
            for (int j = 0; j < 8; ++j) b[j] = xload(8 * h + j);
            if (h == 0) mbar_wait(bars + slot, parity);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              tile_bf16<KV>(st + (8 * h + j) * R::kTileBytes, lm, b[j], acc);
          }
        } else {
          mbar_wait(bars + slot, parity);
#pragma unroll 1
          for (int j = 0; j < n; ++j)
            tile_bf16<KV>(st + j * R::kTileBytes, lm, xload(j), acc);
        }
      }
      __syncwarp();  // every lane has read the slot and the x words
      if (lane == 0 && it + kSlots < nslot)
        issue_slot<KV, kSum2Tiles>(job, ring, bars, it + kSlots);
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

template <typename XT, int KV, bool A8>
int launch_sum2(const void* x, const void* tr, void* out, int N, int m,
                int k, cudaStream_t st) {
  constexpr int smem = Sum2Smem<KV, A8>::kBytes;
  if (reinterpret_cast<uintptr_t>(x) % 8)  // x is read 4-8 bytes at a time
    return (int)cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static unsigned long long ready = 0;  // devices that allow `smem` bytes
  if (dev >= 64 || !((ready >> dev) & 1)) {
    e = cudaFuncSetAttribute(sum2_gemv_kernel<XT, KV, A8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= 1ull << dev;
  }
  sum2_gemv_kernel<XT, KV, A8><<<m / 16, kThreads, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(tr),
      static_cast<float*>(out), N, m, k);
  return (int)cudaGetLastError();
}

template <int KV>
int sum2_variants(const void* x, int x_bf16, const void* tr, void* out,
                  int N, int m, int k, int a8, cudaStream_t st) {
  if (x_bf16)
    return a8 ? launch_sum2<__nv_bfloat16, KV, true>(x, tr, out, N, m, k, st)
              : launch_sum2<__nv_bfloat16, KV, false>(x, tr, out, N, m, k,
                                                      st);
  return a8 ? launch_sum2<float, KV, true>(x, tr, out, N, m, k, st)
            : launch_sum2<float, KV, false>(x, tr, out, N, m, k, st);
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
  sum2_variants<KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_SUM2_WIDE(KV_) \
  gemv_variants<kSum2, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_DUALMAD(KV_) \
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
  if (mode == 0 && N <= kSum2MaxRows) QPT_KV_CASES(QPT_SUM2)
  if (mode == 0) QPT_KV_CASES(QPT_SUM2_WIDE)
  if (mode == 1) QPT_KV_CASES(QPT_DUALMAD)
  return (int)cudaErrorInvalidValue;
}
