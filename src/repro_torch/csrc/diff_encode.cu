// Encoding Unit, batched: one int32 class per 128 x 128 tile of
// delta = x_t - x_prev:
//   0 if max|delta| == 0,  1 if max|delta| <= low_max,  else 2.
// One block per tile (grid (K/128, M/128, batch)); each of the 256 threads
// reads four 16-byte vectors of both operands, the block reduces max|delta|
// by warp shuffle then shared memory. M and K are multiples of 128.
#include "lanes.cuh"

namespace {

using ditto::byte_s8;
using ditto::THREADS;

constexpr int TILE = ditto::TILE_K;  // class tiles are TILE x TILE

__device__ __forceinline__ int absdiff_max4(uint32_t a, uint32_t p, int acc) {
#pragma unroll
  for (int s = 0; s < 32; s += 8) acc = max(acc, abs(byte_s8(a, s) - byte_s8(p, s)));
  return acc;
}

__global__ void __launch_bounds__(THREADS)
    diff_encode_kernel(const int8_t* __restrict__ xt, const int8_t* __restrict__ xp,
                       int32_t* __restrict__ classes, int64_t k, int64_t sx, int64_t sc,
                       int low_max) {
  __shared__ int warp_max[THREADS / 32];
  const int64_t b = blockIdx.z;
  const int64_t off = b * sx + int64_t(blockIdx.y) * TILE * k + int64_t(blockIdx.x) * TILE;
  xt += off;
  xp += off;
  int amax = 0;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int v = threadIdx.x + it * THREADS;
    const int r = v >> 3, c = (v & 7) * 16;
    const uint4 a = *reinterpret_cast<const uint4*>(xt + r * k + c);
    const uint4 p = *reinterpret_cast<const uint4*>(xp + r * k + c);
    amax = absdiff_max4(a.x, p.x, amax);
    amax = absdiff_max4(a.y, p.y, amax);
    amax = absdiff_max4(a.z, p.z, amax);
    amax = absdiff_max4(a.w, p.w, amax);
  }
  amax = __reduce_max_sync(0xffffffffu, amax);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < THREADS / 32; ++i) amax = max(amax, warp_max[i]);
    classes[b * sc + int64_t(blockIdx.y) * (k / TILE) + blockIdx.x] =
        amax == 0 ? 0 : (amax <= low_max ? 1 : 2);
  }
}

}  // namespace

extern "C" int ditto_diff_encode(const void* xt, const void* xp, void* classes,
                                 int64_t batch, int64_t m, int64_t k, int64_t sx, int64_t sc,
                                 int low_max, void* stream) {
  const dim3 grid(unsigned(k / TILE), unsigned(m / TILE), unsigned(batch));
  diff_encode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xt), static_cast<const int8_t*>(xp),
      static_cast<int32_t*>(classes), k, sx, sc, low_max);
  return int(cudaGetLastError());
}
