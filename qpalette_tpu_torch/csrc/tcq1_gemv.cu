// K1 in the V=1 modes: 1mad and 2mad (tcq1), KV 2..5.  Both modes at N <= 8
// rows run v1_gemv_kernel below; both at 8 < N <= 256 run arith_wide.cuh's
// wide_gemv_kernel under the V=1 tile policy WideTile1 below.
//
// v1_gemv_kernel: y = x @ W_hat^T in float32 for N <= 8 rows of x, no
// Wscale.  Replaces qpalette_tpu/kernels/fused.py::_arith_kernel in 1mad
// and 2mad modes (reached through _arith_decode_matmul from
// tcq1_decode_matmul) for decode, both variants: a8 (x quantized to int8
// per 512-column chunk, one absmax scale a chunk over all N rows) and
// exact (x rounded to bf16).
//
// What bounds it: every weight is read once as KV bits of packed trellis,
// so the least time is the trellis bytes over device memory rate.  What
// held the scalar kernel it replaced on an H100: ~9-11 instructions a
// weight (a state's two word reads, wrap select, funnel shift and mask,
// its hash, a __dp4a and a shared-memory x read and IMAD); two block
// barriers per 512-column chunk with ~3 KB of words in flight a block; an
// absmax prologue over every chunk before the first trellis load; and
// Path A's V=1 shapes have 256 m-tiles, one block of 8 warps each.
// Design:
//  - Tensor cores.  In the K-major V=1 tile order state s = 16*col + row
//    holds the one weight (row, col) (arith.cuh).  Lane l (g = l/4, c =
//    l%4) takes fragment rows g and g+8 to tile rows 2g and 2g+1, as the
//    V=2 kernel does, and the k positions of its two MMAs a tile to
//    columns 4c, 4c+1 (MMA 1) and 4c+2, 4c+3 (MMA 2).  So it decodes
//    states s0 = 64c + 2g plus {0, 1, 16, 17} (MMA 1) and {32, 33, 48, 49}
//    (MMA 2): four adjacent pairs, each pair within KV+16 <= 21 bits, one
//    funnel shift of two words a pair: 8 word reads and 4 funnel shifts a
//    tile.  Pairs 0 and 2 sit KV words apart at one shift, pairs 1 and 3
//    likewise; for even KV pair 1 sits KV/2 words after pair 0 at the same
//    shift, for odd KV a half word off (another shift).  Only pair 3's
//    second word can wrap the tile's circular stream.
//  - a8: a state's hash word is an A register of an mma.m16n8k32 with
//    unsigned bytes in A, as they stand (MMA 1: a0..a3 = s0, s0+1, s0+16,
//    s0+17; MMA 2: s0+32, s0+33, s0+48, s0+49).  The lane's x word
//    [q(4c), q(4c+1), q(4c+2), q(4c+3)] of row g under byte permutes
//    0x0000, 0x1111 (MMA 1) and 0x2222, 0x3333 (MMA 2) is B, so the MMAs
//    give sum(unsigned byte sum * q).  The weight is that byte sum - 510,
//    and -510 * sum(q) depends on x alone: each lane adds up the q bytes
//    of the x words it holds (one __dp4a a tile), and at each chunk
//    boundary the warp's int32 fragment takes -510 times its rows' sums
//    over the warp's columns of the chunk (arith_tc.cuh's kBias), once a
//    chunk.  Exact in int32: |sum| <= 1020*127*512 < 2^27.  (Not the TPU
//    kernel's XOR 0x80808080 + 2*sum(x) epilogue: the port keeps the exact
//    integer weight.)
//  - exact: the weights lie in [-510, 510], which bf16 (8 significant
//    bits) does not hold; tf32 holds every integer up to 2^11 and every
//    bf16 value, so a tile takes two mma.m16n8k8.tf32, one per pair of
//    columns, registers as in a8 (register r of lane (g, c) is fragment
//    row g + 8*(r&1) at k = c + 4*(r>>1)), against x columns 4c and 4c+1
//    (MMA 1) or 4c+2 and 4c+3 (MMA 2); each product is exact in f32.  The
//    weight goes to f32 bits with an unsigned __dp4a onto the bits of
//    1.5*2^23 and one FSUB of 1.5*2^23 + 510.
//  - The stream, the x buffer, the descale and the epilogue are
//    arith_tc.cuh's body, shared with the V=2 modes (tcq2_gemv.cu).  The
//    grid: one block an m-tile, of 16 warps (2 blocks an SM), so the 256
//    m-tiles of Path A's o and down shapes keep 31 warps an SM busy.

#include "arith_wide.cuh"

using namespace qpt;

namespace {

// This lane's view of a V=1 tile of 8*KV words: byte offsets of the first
// words of pairs 0 (o0) and 1 (o1), the second word of pair 3 (o3, which
// may wrap), and the shifts of pairs 0/2 and 1/3
struct LaneMap1 {
  uint32_t o0, o1, o3;
  int sh0, sh1;
};

template <int KV>
__device__ __forceinline__ LaneMap1 lane_map1(int s0) {
  constexpr int W = 8 * KV;
  const int b0 = KV * s0;            // bit of state s0
  const int b1 = b0 + 16 * KV;       // of s0+16
  const int w3 = (b1 >> 5) + KV + 1;  // pair 3 (s0+48) is KV words on
  const uint32_t o0 = 4u * (b0 >> 5);
  const uint32_t o1 = KV % 2 ? 4u * (b1 >> 5) : o0 + 2 * KV;
  return {o0, o1, 4u * (w3 == W ? 0 : w3), b0 & 31,
          KV % 2 ? b1 & 31 : b0 & 31};
}

// The lane's four funnel-shifted words of the tile at wt (shared memory):
// f[p] holds states s0 + 16p (bits [0, 16)) and s0 + 16p + 1 (bits [KV,
// KV+16)).
template <int KV>
__device__ __forceinline__ void lane_windows1(const uint8_t* wt,
                                              const LaneMap1& lm,
                                              uint32_t (&f)[4]) {
  const auto word = [&](uint32_t o) {
    return *reinterpret_cast<const uint32_t*>(wt + o);
  };
  f[0] = __funnelshift_r(word(lm.o0), word(lm.o0 + 4), lm.sh0);
  f[1] = __funnelshift_r(word(lm.o1), word(lm.o1 + 4), lm.sh1);
  f[2] = __funnelshift_r(word(lm.o0 + 4 * KV), word(lm.o0 + 4 * KV + 4),
                         lm.sh0);
  f[3] = __funnelshift_r(word(lm.o1 + 4 * KV), word(lm.o3), lm.sh1);
}

// exact: the weight of hash h, unsigned byte sum - 510, as f32 (tf32) bits
__device__ __forceinline__ uint32_t v1_weight(uint32_t h) {
  const uint32_t v = __dp4a(h, 0x01010101u, 0x4b400000u);
  return __float_as_uint(__fsub_rn(__uint_as_float(v), 12583422.0f));
}

// The V=1 tile policy of arith_tc.cuh: lane (g, c) decodes states 64c+2g
// + {0, 1, 16, 17, 32, 33, 48, 49} and reads x columns 4c..4c+3
template <int MODE, int KV>
struct V1Tile {
  static constexpr int kKV = KV, kWords = 8 * KV, kXStep = 2, kBias = 510;
  // kXAhead 4: at 8, one instance (f32 x, 1mad, KV 2, exact) spilled 4
  // bytes at the 64-register cap; 4 is as fast
  static constexpr int kWarps = 16, kBlocks = 2, kXAhead = 4;
  static __device__ __forceinline__ LaneMap1 map(int g, int c) {
    return lane_map1<KV>(64 * c + 2 * g);
  }
  static __device__ __forceinline__ int xcol(int c) { return 4 * c; }
  // the hash of the first (i = 0) or second (i = 1) state of window f
  static __device__ __forceinline__ uint32_t hash(uint32_t f, int i) {
    return v1_hash<MODE>((i ? f >> KV : f) & 0xffffu);
  }

  // a8: one tile against the quantized x word xw of this lane's row and c
  static __device__ __forceinline__ void a8(const uint8_t* wt,
                                            const LaneMap1& lm, uint32_t xw,
                                            int (&d)[4]) {
    uint32_t f[4];
    lane_windows1<KV>(wt, lm, f);
    mma_u8s8(d, hash(f[0], 0), hash(f[0], 1), hash(f[1], 0), hash(f[1], 1),
             __byte_perm(xw, 0, 0x0000), __byte_perm(xw, 0, 0x1111));
    mma_u8s8(d, hash(f[2], 0), hash(f[2], 1), hash(f[3], 0), hash(f[3], 1),
             __byte_perm(xw, 0, 0x2222), __byte_perm(xw, 0, 0x3333));
  }

  // exact: one tile against bf16 x columns (4c, 4c+1) and (4c+2, 4c+3),
  // each pair a bf16x2 word with the lower column in the low half
  static __device__ __forceinline__ void exact(const uint8_t* wt,
                                               const LaneMap1& lm, uint2 b,
                                               float (&d)[4]) {
    uint32_t f[4];
    lane_windows1<KV>(wt, lm, f);
    // a bf16 value as tf32 is its bits in the high half of the word
    mma_tf32(d, v1_weight(hash(f[0], 0)), v1_weight(hash(f[0], 1)),
             v1_weight(hash(f[1], 0)), v1_weight(hash(f[1], 1)), b.x << 16,
             b.x & 0xffff0000u);
    mma_tf32(d, v1_weight(hash(f[2], 0)), v1_weight(hash(f[2], 1)),
             v1_weight(hash(f[3], 0)), v1_weight(hash(f[3], 1)), b.y << 16,
             b.y & 0xffff0000u);
  }
};

// The V=1 tile policy of wide_gemv_kernel (8 < N <= 256): V1Tile's lane
// map, x columns 4c..4c+3 of the n-tile's row g (the prologue's V=1
// order: p = 4c, s = 2), a tile decoded once into 8 A registers, pair p's
// states in registers 2p and 2p+1 as V1Tile's MMAs take them.  a8: the
// hashes as u8 A registers of two mma.m16n8k32 an n-tile against the x
// word's byte permutes 0x0000 / 0x1111 and 0x2222 / 0x3333 (the wide body
// adds -510 * sum(q) a step); exact: their weights as tf32 (v1_weight), two
// mma.m16n8k8 on the x words' bf16 halves.  8 A registers, as dualmad's:
// at most 24 n-tiles a row group (exact) and 12 (a8).
template <int MODE, int KV, bool A8>
struct WideTile1 {
  static constexpr int kKV = KV, kV = 1, kWords = 8 * KV, kRegs = 8;
  static constexpr bool kA8 = A8;
  static constexpr int kMost = A8 ? 12 : 24;
  using T = V1Tile<MODE, KV>;

  static __device__ __forceinline__ LaneMap1 map(int g, int c) {
    return T::map(g, c);
  }

  static __device__ __forceinline__ void decode(const uint8_t* wt,
                                                const LaneMap1& lm,
                                                uint32_t (&a)[kRegs]) {
    uint32_t f[4];
    lane_windows1<KV>(wt, lm, f);
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const uint32_t h = T::hash(f[r >> 1], r & 1);
      a[r] = A8 ? h : v1_weight(h);
    }
  }

  // a8: into the chunk's int32 fragment
  static __device__ __forceinline__ void mma(int (&d)[4],
                                             const uint32_t (&a)[kRegs],
                                             uint32_t w) {
    mma_u8s8(d, a[0], a[1], a[2], a[3], __byte_perm(w, 0, 0x0000),
             __byte_perm(w, 0, 0x1111));
    mma_u8s8(d, a[4], a[5], a[6], a[7], __byte_perm(w, 0, 0x2222),
             __byte_perm(w, 0, 0x3333));
  }

  // exact: into the f32 fragment; a bf16 value as tf32 is its bits in
  // the high half of the word
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[kRegs],
                                             uint2 b) {
    mma_tf32(d, a[0], a[1], a[2], a[3], b.x << 16, b.x & 0xffff0000u);
    mma_tf32(d, a[4], a[5], a[6], a[7], b.y << 16, b.y & 0xffff0000u);
  }
};

template <typename XT, int MODE, int KV, bool A8>
__global__ void __launch_bounds__(32 * V1Tile<MODE, KV>::kWarps,
                                  V1Tile<MODE, KV>::kBlocks)
v1_gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ tr,
               float* __restrict__ out, int N, int m, int k) {
  tc_gemv<V1Tile<MODE, KV>, XT, A8>(x, tr, out, N, m, k);
}

template <int MODE, int KV>
int v1_variants(const void* x, int x_bf16, const void* tr, void* out, int N,
                int m, int k, int a8, cudaStream_t st) {
  using T = V1Tile<MODE, KV>;
  static unsigned long long ready[4];  // per instance, as launch_tc asks
  if (x_bf16)
    return a8 ? launch_tc<T, __nv_bfloat16, true>(
                    v1_gemv_kernel<__nv_bfloat16, MODE, KV, true>, ready[0],
                    x, tr, out, N, m, k, st)
              : launch_tc<T, __nv_bfloat16, false>(
                    v1_gemv_kernel<__nv_bfloat16, MODE, KV, false>, ready[1],
                    x, tr, out, N, m, k, st);
  return a8 ? launch_tc<T, float, true>(v1_gemv_kernel<float, MODE, KV, true>,
                                        ready[2], x, tr, out, N, m, k, st)
            : launch_tc<T, float, false>(
                  v1_gemv_kernel<float, MODE, KV, false>, ready[3], x, tr,
                  out, N, m, k, st);
}

}  // namespace

#define QPT_V1_KV(CALL)                         \
  switch (KV) {                                 \
    case 2:  return CALL(2);                    \
    case 3:  return CALL(3);                    \
    case 4:  return CALL(4);                    \
    case 5:  return CALL(5);                    \
    default: return (int)cudaErrorInvalidValue; \
  }
#define QPT_1MAD(KV_) \
  v1_variants<k1mad, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_2MAD(KV_) \
  v1_variants<k2mad, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)
#define QPT_1MAD_WIDE(KV_) \
  wide_gemv<WideTile1, k1mad, KV_>(x, x_bf16, tr, out, ws, N, m, k, a8, st)
#define QPT_2MAD_WIDE(KV_) \
  wide_gemv<WideTile1, k2mad, KV_>(x, x_bf16, tr, out, ws, N, m, k, a8, st)

// x: (N, k) float32 (x_bf16 == 0) or bfloat16, 1 <= N <= 256, 8-byte
// aligned; tr: canonical (m/16*k/16, 8*KV) words, 16-byte aligned; out:
// (N, m) float32; ws: at N > 8, wide_gemv's workspace, else unused; mode 0
// = 1mad, 1 = 2mad.  Launches on `stream` (at N > 8: two kernels) and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernels do not take).
extern "C" int tcq1_gemv(const void* x, int x_bf16, const void* tr,
                         void* out, void* ws, int N, int m, int k, int KV,
                         int mode, int a8, void* stream) {
  if (bad_gemv_args(N, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = N <= kTcRows;
  if (mode == 0 && narrow) QPT_V1_KV(QPT_1MAD)
  if (mode == 1 && narrow) QPT_V1_KV(QPT_2MAD)
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == 0) QPT_V1_KV(QPT_1MAD_WIDE)
  if (mode == 1) QPT_V1_KV(QPT_2MAD_WIDE)
  return (int)cudaErrorInvalidValue;
}
