// int8 x int8 -> int32 GEMM, batched, for sm_90a: out[b] = x[b] @ W[b]^T
// with x[b] (M, K) and W[b] (N, K) row-major (K-major), exact int32.
//
// Replaces src/repro/kernels/int8_matmul.py: int8_matmul (the Pallas body
// _kernel). The mainloop, pipeline, split-K and epilogue are
// diff_gemm_sm90.cuh's; this file supplies its simplest producer of the A
// operand: the x chunk (64 rows x 64 K bytes) is staged with cp.async into
// the same swizzled 64-byte rows as W, and wgmma reads it from there as it
// is, through a descriptor (ActProducer::A_SMEM), so a -128 lane is exact.
// There is no Δ, no fragment build, no hi product, no vote and no class
// read (ActProducer::CLASSED is false), and the epilogue runs without
// y_prev.
//
// What bounds it: bytes at the path's DiT-XL/2 shapes (170-360 int8
// operations per byte moved against the H100's balance point of ~590), the
// int32 output the largest stream; at 36-288 output tiles of 64 x 128 the
// launch and the pipeline's fill cost as much as the bytes. Hence 64-row
// tiles (enough blocks for 132 SMs), two chunks of loads in flight behind
// the product, and K split over a cluster where the grid leaves SMs idle
// or the walk is long. W is K-major only (the wrapper lays a (K, N) weight
// out so first). M is a multiple of 64, N and K of 128 (kernels/ops.py
// pads to 128); batch strides are in elements. `splits` is 0 for the
// kernel's own K split (launch_splits) or a forced count.
#include "diff_gemm_sm90.cuh"

namespace {

using namespace ditto::sm90;

struct ActProducer {
  static constexpr bool CLASSED = false;
  static constexpr bool A_SMEM = true;
  static constexpr int A_BYTES = GM * GK;  // x: swizzled 64-byte rows

  __device__ static void load(uint8_t* st, const GemmArgs& a, int64_t b, int64_t m0,
                              int64_t k0, int /*cls*/) {
    const int8_t* x = a.a0 + b * a.sa0 + m0 * a.k + k0;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = threadIdx.x + it * GTHREADS;
      const int r = v >> 2, c = (v & 3) * 16;
      cp_async16(st + row64(r, c), x + r * a.k + c);
    }
  }
};

}  // namespace

extern "C" int ditto_int8_matmul(const void* x, const void* w, void* out, int64_t batch,
                                 int64_t m, int64_t n, int64_t k, int64_t sx, int64_t sw,
                                 int64_t so, int splits, void* stream) {
  GemmArgs a = {};
  a.a0 = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.out = static_cast<int32_t*>(out);
  a.m = m;
  a.n = n;
  a.k = k;
  a.sa0 = sx;
  a.sw = sw;
  a.so = so;
  a.splits = splits;
  return launch_diff_gemm<ActProducer>(a, batch, stream);
}

extern "C" const char* ditto_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
