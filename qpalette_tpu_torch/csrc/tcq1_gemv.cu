// K1 in the V=1 modes: 1mad and 2mad (tcq1), KV 2..5.  The kernel and its
// design notes are in arith.cuh.

#include "arith.cuh"

using namespace qpt;

#define QPT_GEMV(MODE, KV_) \
  gemv_variants<MODE, KV_>(x, x_bf16, tr, out, N, m, k, a8, st)

#define QPT_V1_KV(MODE)                         \
  switch (KV) {                                 \
    case 2:  return QPT_GEMV(MODE, 2);          \
    case 3:  return QPT_GEMV(MODE, 3);          \
    case 4:  return QPT_GEMV(MODE, 4);          \
    case 5:  return QPT_GEMV(MODE, 5);          \
    default: return (int)cudaErrorInvalidValue; \
  }

// x: (N, k) float32 (x_bf16 == 0) or bfloat16, 1 <= N <= 256; tr: canonical
// (m/16*k/16, 8*KV) words, 16-byte aligned; out: (N, m) float32; mode 0 =
// 1mad, 1 = 2mad.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tcq1_gemv(const void* x, int x_bf16, const void* tr,
                         void* out, int N, int m, int k, int KV, int mode,
                         int a8, void* stream) {
  if (bad_gemv_args(N, m, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) QPT_V1_KV(k1mad)
  if (mode == 1) QPT_V1_KV(k2mad)
  return (int)cudaErrorInvalidValue;
}
