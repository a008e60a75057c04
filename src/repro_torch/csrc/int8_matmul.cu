// int8 x int8 -> int32 GEMM, batched: out[b] = x[b] (M, K) @ W[b].
//
// W[b] is (K, N) row-major, or (N, K) row-major when w_t (the attention
// act path contracts Q against K rows without a transposed copy).
// M, N, K are multiples of 128 (kernels/ops.py pads); batch strides are in
// elements. Grid: (N/128, M/128, batch), one 128 x 128 output tile a block.
#include "tile_mma.cuh"

namespace {

using namespace ditto;

__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       int32_t* __restrict__ out, int64_t m, int64_t n, int64_t k,
                       int64_t sx, int64_t sw, int64_t so, bool w_t) {
  __shared__ __align__(16) int8_t As[BM][PITCH];
  __shared__ __align__(16) int8_t Bs[BN][PITCH];
  const int64_t b = blockIdx.z;
  const int64_t m0 = int64_t(blockIdx.y) * BM, n0 = int64_t(blockIdx.x) * BN;
  x += b * sx;
  w += b * sw;
  Frag acc;
  zero(acc);
  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    load_rows(As, x + m0 * k + k0, k);
    load_w(Bs, w, w_t, n, k, n0, k0);
    __syncthreads();
    mma_chunk(acc, As, Bs);
    __syncthreads();
  }
  store_tile(acc, out + b * so, nullptr, n, m0, n0);
}

}  // namespace

extern "C" int ditto_int8_matmul(const void* x, const void* w, void* out, int64_t batch,
                                 int64_t m, int64_t n, int64_t k, int64_t sx, int64_t sw,
                                 int64_t so, int w_t, void* stream) {
  const dim3 grid(unsigned(n / BN), unsigned(m / BM), unsigned(batch));
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), m, n, k, sx, sw, so, w_t != 0);
  return int(cudaGetLastError());
}

extern "C" const char* ditto_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
