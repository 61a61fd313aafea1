// K1 in the V=2 modes: sum2 (tcq2s) and dualmad (tcq2), KV 4..10.  Both
// modes at N <= 8 rows run v2_gemv_kernel below, and at 8 < N <= 256
// wide_gemv_kernel under the V=2 tile policy WideTile (arith_wide.cuh, its
// note there).
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
// rate.  What held the scalar kernel it replaced on an H100: two barriers
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
//    as the plain version does its chunk sums.
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
//  - The stream, the x buffer, the descale and the epilogue are
//    arith_tc.cuh's body, shared with the V=1 modes (tcq1_gemv.cu): 8 warps
//    a block, 4 blocks an SM (every Llama-3.1-8B V=2 shape has >= 256
//    m-tiles, so the block is not split further).
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

#include "arith_wide.cuh"

using namespace qpt;

namespace {

// The V=2 tile policy of arith_tc.cuh: lane (g, c) decodes states 16c+2g,
// +1, +64, +65 and reads x columns (2c, 2c+1) and (8+2c, 9+2c)
template <int MODE, int KV>
struct V2Tile {
  static constexpr int kKV = KV, kWords = 4 * KV, kXStep = 8, kBias = 0;
  static constexpr int kWarps = 8, kBlocks = 4, kXAhead = 8;
  static __device__ __forceinline__ LaneMap map(int g, int c) {
    return lane_map<KV>(16 * c + 2 * g);
  }
  static __device__ __forceinline__ int xcol(int c) { return 2 * c; }

  // a8: one tile against the quantized x word xw of this lane's row and c
  static __device__ __forceinline__ void a8(const uint8_t* wt,
                                            const LaneMap& lm, uint32_t xw,
                                            int (&d)[4]) {
    // the decode step, then the MMA step (arith_wide.cuh's tile policy)
    using W = WideTile<MODE, KV, true>;
    uint32_t a[W::kRegs];
    W::decode(wt, lm, a);
    W::mma(d, a, xw);
  }

  // exact: one tile against bf16 x columns (2c, 2c+1) and (8+2c, 9+2c),
  // each pair a bf16x2 word with the lower column in the low half
  static __device__ __forceinline__ void exact(const uint8_t* wt,
                                               const LaneMap& lm, uint2 b,
                                               float (&d)[4]) {
    // (not the wide tile policy's steps: decoding all 8 registers before
    // the MMAs changes the SASS of the exact dualmad instances)
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
};

template <typename XT, int MODE, int KV, bool A8>
__global__ void __launch_bounds__(32 * V2Tile<MODE, KV>::kWarps,
                                  V2Tile<MODE, KV>::kBlocks)
v2_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ tr,
               float* __restrict__ out, int N, int m, int k) {
  tc_gemv<V2Tile<MODE, KV>, XT, A8>(x, tr, out, N, m, k);
}

template <int MODE, int KV>
int v2_variants(const void* x, int x_bf16, const void* tr, void* out, int N,
                int m, int k, int a8, cudaStream_t st) {
  using T = V2Tile<MODE, KV>;
  static unsigned long long ready[4];  // per instance, as launch_tc asks
  if (x_bf16)
    return a8 ? launch_tc<T, __nv_bfloat16, true>(
                    v2_gemv_kernel<__nv_bfloat16, MODE, KV, true>, ready[0],
                    x, tr, out, N, m, k, st)
              : launch_tc<T, __nv_bfloat16, false>(
                    v2_gemv_kernel<__nv_bfloat16, MODE, KV, false>, ready[1],
                    x, tr, out, N, m, k, st);
  return a8 ? launch_tc<T, float, true>(v2_gemv_kernel<float, MODE, KV, true>,
                                        ready[2], x, tr, out, N, m, k, st)
            : launch_tc<T, float, false>(
                  v2_gemv_kernel<float, MODE, KV, false>, ready[3], x, tr,
                  out, N, m, k, st);
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
  wide_gemv<WideTile, kSum2, KV_>(x, x_bf16, tr, out, ws, N, m, k, a8, st)
#define QPT_DUALMAD_WIDE(KV_) \
  wide_gemv<WideTile, kDualmad, KV_>(x, x_bf16, tr, out, ws, N, m, k, a8, st)

// x: (N, k) float32 (x_bf16 == 0) or bfloat16, 1 <= N <= 256, 8-byte
// aligned; tr: canonical (m/16*k/16, 4*KV) words, 16-byte aligned; out:
// (N, m) float32; ws: at N > 8, wide_gemv's workspace, else unused; mode 0 =
// sum2, 1 = dualmad.  Launches on `stream` (at N > 8: two kernels) and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernels do not take).
extern "C" int tcq2_gemv(const void* x, int x_bf16, const void* tr,
                         void* out, void* ws, int N, int m, int k, int KV,
                         int mode, int a8, void* stream) {
  if (bad_gemv_args(N, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = N <= kTcRows;
  if (mode == 0 && narrow) QPT_KV_CASES(QPT_SUM2)
  if (mode == 1 && narrow) QPT_KV_CASES(QPT_DUALMAD)
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == 0) QPT_KV_CASES(QPT_SUM2_WIDE)
  if (mode == 1) QPT_KV_CASES(QPT_DUALMAD_WIDE)
  return (int)cudaErrorInvalidValue;
}
