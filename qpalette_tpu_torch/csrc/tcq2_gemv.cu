// K1 in the V=2 modes: sum2 (tcq2s) and dualmad (tcq2), KV 4..10.  The
// kernel and its design notes are in arith.cuh.

#include "arith.cuh"

using namespace qpt;

#define QPT_GEMV(MODE, KV_) \
  gemv_variants<MODE, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)

#define QPT_V2_KV(MODE)                         \
  switch (KV) {                                 \
    case 4:  return QPT_GEMV(MODE, 4);          \
    case 5:  return QPT_GEMV(MODE, 5);          \
    case 6:  return QPT_GEMV(MODE, 6);          \
    case 7:  return QPT_GEMV(MODE, 7);          \
    case 8:  return QPT_GEMV(MODE, 8);          \
    case 9:  return QPT_GEMV(MODE, 9);          \
    case 10: return QPT_GEMV(MODE, 10);         \
    default: return (int)cudaErrorInvalidValue; \
  }

// x: (N, k) float32 (x_bf16 == 0) or bfloat16, 1 <= N <= 256; tr: canonical
// (m/16*k/16, 4*KV) words, 16-byte aligned; out: (N, m) float32; mode 0 =
// sum2, 1 = dualmad.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tcq2_gemv(const void* x, int x_bf16, const void* tr,
                         void* out, int N, int m, int k, int KV, int mode,
                         int a8, void* stream) {
  if (bad_gemv_args(N, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) QPT_V2_KV(kSum2)
  if (mode == 1) QPT_V2_KV(kDualmad)
  return (int)cudaErrorInvalidValue;
}
