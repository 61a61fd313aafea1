// The persistent, pipelined walk of the dequant kernels for Hopper (sm_90a):
// K2/K3 (arith_dequant.cu) and K6/K7 (tcq_lut.cu), trellis -> bf16 W_hat.
//
// A group is up to kDqTiles adjacent k-tiles of one m-tile, a 16 x 64
// block of W_hat whose packed words are contiguous (4*KV words a tile for
// the V=2 and LUT trellises, 8*KV at V=1: a multiple of 16 bytes at every
// KV, so one cp.async.bulk copy moves a group).  A persistent grid (the
// blocks of kDqWarps warps that fit on every SM, at most one warp a group)
// gives warp w of its nw warps the groups w, w + nw, w + 2nw, ... in
// tile-row-major order: which warp decodes a group changes with the grid,
// what it writes does not.  Each warp streams its groups through its own
// ring of kDqSlots slots, one bulk copy a group completing on the slot's
// mbarrier, so kDqSlots - 1 groups are in flight while it decodes one, and
// a slot is refilled with the group kDqSlots further once every lane has
// read it.  No block barrier inside the loop.
//
// Why (the earlier dequants on an H100 at 4096x4096): a capped grid of 2112
// blocks gave each warp one group, so each warp waited once for device
// memory, decoded, stored and exited, in two waves of short blocks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace qpt {

constexpr int kDqWarps = 8;  // warps a block
constexpr int kDqThreads = kDqWarps * 32;  // a block's threads
constexpr int kDqSlots = 4;  // ring slots a warp
constexpr int kDqTiles = 4;  // k-tiles a group

// A warp's place in the walk: group q (of gr a tile-row) of m-tile mt.
// next() steps by the grid's warps, so the walk divides only once.
struct DqCursor {
  int mt, q, dmt, dq, gr;

  __device__ __forceinline__ explicit DqCursor(int groups_a_row)
      : gr(groups_a_row) {
    const int g = blockIdx.x * kDqWarps + (threadIdx.x >> 5);
    const int nw = gridDim.x * kDqWarps;
    mt = g / gr;
    q = g - mt * gr;
    dmt = nw / gr;
    dq = nw - dmt * gr;
  }

  __device__ __forceinline__ void next() {
    mt += dmt;
    q += dq;
    if (q >= gr) {
      q -= gr;
      ++mt;
    }
  }
};

// lane 0: the warp's slot barriers, made visible to the bulk copies
__device__ __forceinline__ void dq_init_bars(uint64_t* bars) {
  if ((threadIdx.x & 31) == 0) {
    for (int s = 0; s < kDqSlots; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The blocks of `kernel` (kDqWarps warps, `smem` bytes of dynamic shared
// memory) that fit on the card, at most `need`: asked once per device
// (cache[dev], 0 until then), which also lifts the kernel's dynamic
// shared-memory limit to `smem`.
static inline cudaError_t dq_grid(const void* kernel, int smem,
                                  long long need, int (&cache)[64],
                                  int& grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int fit = dev < 64 ? cache[dev] : 0;
  if (!fit) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int nsm = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kDqThreads, (size_t)smem);
    if (e != cudaSuccess) return e;
    fit = nsm * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cache[dev] = fit;
  }
  grid = (int)(need < fit ? need : fit);
  return cudaSuccess;
}

// the 32-bit word at byte offset o of shared memory p
__device__ __forceinline__ uint32_t dq_word(const uint8_t* p, uint32_t o) {
  return *reinterpret_cast<const uint32_t*>(p + o);
}

// 16 bytes of W_hat (8 bf16 of one row) at p, stored evict-first
// (st.global.cs): on an H100 a plain store was 1-2% slower than the
// capped grid at the shapes whose W_hat outgrows L2 (14336x4096,
// 28672x4096), the streaming store faster at every shape timed.
__device__ __forceinline__ void dq_store(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

}  // namespace qpt
