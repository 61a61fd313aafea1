// Hopper (sm_90a) building blocks shared by the tensor-core decode GEMVs
// (tcq_lut.cu's lut_gemv_kernel; arith_tc.cuh's body of tcq2_gemv.cu's
// v2_gemv_kernel and tcq1_gemv.cu's v1_gemv_kernel): the per-warp trellis
// stream and the warp-level MMAs.
//
// The stream: a warp owns a contiguous range of one m-tile's k-tiles
// (contiguous bytes of the canonical trellis) and streams it through its
// own double buffer: kSlots slots of T tiles (kStageTiles unless the
// kernel picks another), each slot one 1-D TMA bulk copy (cp.async.bulk)
// completing on the slot's mbarrier.  The warp decodes one slot while the
// next streams; a slot is refilled with the one kSlots further once every
// lane has read it.  No block barrier.
//
// A lane's view of a V=2 (or LUT) tile: the four words of its four states
// and the shift of their windows (tcq1_gemv.cu has the V=1 view).  Where a
// lane's states are s0, s0+1, s0+64 and s0+65 of a tile of 4*KV words, s0
// and s0+1 lie within KV+16 <= 26 bits, so one funnel shift of two words
// yields both windows; s0+64 sits exactly 2*KV words further at the same
// shift, its second word wrapping the tile's circular stream for the last
// states.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qpt {

constexpr int kStageTiles = 8;  // k-tiles a ring slot (one bulk copy)
constexpr int kSlots = 2;       // a warp decodes one slot, the other streams

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

// tf32 operands are f32 bit patterns whose low 13 bits the MMA ignores:
// every integer up to 2^11 and every bf16 value passes exactly
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// int8 x int8 -> int32; wraps on overflow, which the callers' chunking
// rules out
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// unsigned int8 A x signed int8 B -> int32, as mma_s8
__device__ __forceinline__ void mma_u8s8(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// This lane's view of a tile of 4*KV words whose first state is s0 (see
// the note at the top): byte offsets of its four words and the shift.
struct LaneMap {
  uint32_t o0, o1, o2, o3;
  int sh;
};

template <int KV>
__device__ __forceinline__ LaneMap lane_map(int s0) {
  constexpr int W = 4 * KV;
  const int off = KV * s0;
  const int w0 = off >> 5, w2 = w0 + 2 * KV;
  const int w3 = (w2 + 1 == W) ? 0 : w2 + 1;  // the stream is circular
  return {4u * w0, 4u * (w0 + 1), 4u * w2, 4u * w3, off & 31};
}

// The lane's two funnel-shifted words of the tile at wt (shared memory):
// f0 holds states s0 (bits [0, 16)) and s0+1 (bits [KV, KV+16)), f1 the
// states s0+64 and s0+65.
__device__ __forceinline__ void lane_windows(const uint8_t* wt,
                                             const LaneMap& lm, uint32_t& f0,
                                             uint32_t& f1) {
  const auto word = [&](uint32_t o) {
    return *reinterpret_cast<const uint32_t*>(wt + o);
  };
  f0 = __funnelshift_r(word(lm.o0), word(lm.o1), lm.sh);
  f1 = __funnelshift_r(word(lm.o2), word(lm.o3), lm.sh);
}

// A warp's share of the work: nt k-tiles of one m-tile starting at src
// (bytes in device memory) and at x column col0.
struct WarpJob {
  const uint8_t* src;
  int nt, col0;
};

// A warp's ring for KV: kSlots slots of T tiles of W words (4*KV for the
// V=2 and LUT tiles, 8*KV for the V=1 tiles)
template <int KV, int T = kStageTiles, int W = 4 * KV>
struct Ring {
  static constexpr int kTileBytes = 4 * W;
  static constexpr int kSlotBytes = T * kTileBytes;
};

template <int KV, int T = kStageTiles, int W = 4 * KV>
__device__ __forceinline__ void issue_slot(const WarpJob& job, uint8_t* ring,
                                           uint64_t* bars, int it) {
  using R = Ring<KV, T, W>;
  const int slot = it % kSlots;
  const int n = min(T, job.nt - it * T);
  bulk_load(ring + slot * R::kSlotBytes,
            job.src + (size_t)it * R::kSlotBytes, n * R::kTileBytes,
            bars + slot);
}

template <int KV, int T = kStageTiles, int W = 4 * KV>
__device__ __forceinline__ void issue_first(const WarpJob& job, uint8_t* ring,
                                            uint64_t* bars) {
  const int nslot = (job.nt + T - 1) / T;
  for (int it = 0; it < min(kSlots, nslot); ++it)
    issue_slot<KV, T, W>(job, ring, bars, it);
}

}  // namespace qpt
