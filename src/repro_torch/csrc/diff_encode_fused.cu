// Encoding Unit with the delta cache, batched: one pass over (x_t, x_prev)
// gives, per 128 x 128 tile of delta = x_t - x_prev,
//   classes  one int32: 0 if max|delta| == 0, 1 if <= low_max, else 2;
//   dc       (M, K/2) int8: delta's low nibbles, two int4 K lanes a byte
//            (int4_pack.cuh layout), written only where the class >= 1;
//   dh       (M, K) int8: (delta - lo) / 16, so delta = lo + 16 * dh
//            exactly (dh in [-16, 16]), written only where the class is 2.
// A class-0 tile writes its class and nothing else; the ungated parts of
// dc and dh keep whatever the buffer held, and the fused matmul never
// reads them. One block per tile (grid (K/128, M/128, batch)); each of the
// 256 threads keeps its four 16-byte vectors of both operands in registers
// while the block reduces max|delta|, then writes from them. M and K are
// multiples of 128.
#include "int4_pack.cuh"

namespace {

using namespace ditto;

constexpr int TILE = TILE_K;  // class tiles are TILE x TILE

__device__ __forceinline__ int absdiff_max4(uint32_t a, uint32_t p, int acc) {
#pragma unroll
  for (int s = 0; s < 32; s += 8) acc = max(acc, abs(byte_s8(a, s) - byte_s8(p, s)));
  return acc;
}

// The high parts (delta - lo) / 16 of the 4 byte lanes of a - p, one a byte.
__device__ __forceinline__ uint32_t high4(uint32_t a, uint32_t p) {
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    const int d = byte_s8(a, s) - byte_s8(p, s);
    const int h = (d - unpack_int4_lo(uint32_t(d), 0)) / 16;  // exact: a multiple of 16
    out |= (uint32_t(h) & 0xffu) << s;
  }
  return out;
}

__global__ void __launch_bounds__(THREADS)
    diff_encode_fused_kernel(const int8_t* __restrict__ xt, const int8_t* __restrict__ xp,
                             int32_t* __restrict__ classes, int8_t* __restrict__ dc,
                             int8_t* __restrict__ dh, int64_t k, int64_t sx, int64_t sc,
                             int low_max) {
  __shared__ int warp_max[THREADS / 32];
  __shared__ int tile_cls;
  const int64_t b = blockIdx.z;
  const int64_t row0 = int64_t(blockIdx.y) * TILE, col0 = int64_t(blockIdx.x) * TILE;
  const int64_t off = b * sx + row0 * k + col0;
  uint4 a[4], p[4];
  int amax = 0;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int v = threadIdx.x + it * THREADS;
    const int r = v >> 3, c = (v & 7) * 16;
    a[it] = *reinterpret_cast<const uint4*>(xt + off + r * k + c);
    p[it] = *reinterpret_cast<const uint4*>(xp + off + r * k + c);
    amax = absdiff_max4(a[it].x, p[it].x, amax);
    amax = absdiff_max4(a[it].y, p[it].y, amax);
    amax = absdiff_max4(a[it].z, p[it].z, amax);
    amax = absdiff_max4(a[it].w, p[it].w, amax);
  }
  amax = __reduce_max_sync(0xffffffffu, amax);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < THREADS / 32; ++i) amax = max(amax, warp_max[i]);
    const int c = amax == 0 ? 0 : (amax <= low_max ? 1 : 2);
    classes[b * sc + int64_t(blockIdx.y) * (k / TILE) + blockIdx.x] = c;
    tile_cls = c;
  }
  __syncthreads();
  const int cls = tile_cls;
  if (cls == 0) return;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int v = threadIdx.x + it * THREADS;
    const int r = v >> 3, c = (v & 7) * 16;
    // per-byte difference mod 256: its low nibbles are delta's
    const uint4 d = make_uint4(__vsub4(a[it].x, p[it].x), __vsub4(a[it].y, p[it].y),
                               __vsub4(a[it].z, p[it].z), __vsub4(a[it].w, p[it].w));
    *reinterpret_cast<uint2*>(dc + off / 2 + r * (k / 2) + c / 2) = pack_int4_x16(d);
    if (cls == 2)
      *reinterpret_cast<uint4*>(dh + off + r * k + c) =
          make_uint4(high4(a[it].x, p[it].x), high4(a[it].y, p[it].y),
                     high4(a[it].z, p[it].z), high4(a[it].w, p[it].w));
  }
}

}  // namespace

extern "C" int ditto_diff_encode_fused(const void* xt, const void* xp, void* classes, void* dc,
                                       void* dh, int64_t batch, int64_t m, int64_t k,
                                       int64_t sx, int64_t sc, int low_max, void* stream) {
  const dim3 grid(unsigned(k / TILE), unsigned(m / TILE), unsigned(batch));
  diff_encode_fused_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xt), static_cast<const int8_t*>(xp),
      static_cast<int32_t*>(classes), static_cast<int8_t*>(dc), static_cast<int8_t*>(dh), k,
      sx, sc, low_max);
  return int(cudaGetLastError());
}
