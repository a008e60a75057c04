// Encoding Unit with the delta cache, batched: one pass over (x_t, x_prev)
// gives, per 128 x 128 tile of delta = x_t - x_prev,
//   classes  one int32: 0 if max|delta| == 0, 1 if <= low_max, else 2;
//   dc       (M, K/2) int8: delta's low nibbles, two int4 K lanes a byte
//            (int4_pack.cuh layout), written only where the class >= 1;
//   dh       (M, K) int8: (delta - lo) / 16, so delta = lo + 16 * dh
//            exactly (dh in [-16, 16]), written only where the class is 2.
// A class-0 tile writes its class and nothing else; the ungated parts of
// dc and dh keep whatever the buffer held, and the fused matmul never
// reads them. Each tile is split over a thread-block cluster of C blocks
// (encode_sm90.cuh): every block keeps its rows of both operands in
// registers while the blocks exchange their maxima through distributed
// shared memory, then writes those rows of the planes the class needs, so
// a tile's stores and their arithmetic are spread over C SMs. M and K are
// multiples of 128.
#include "encode_sm90.cuh"
#include "int4_pack.cuh"

namespace {

using namespace ditto::encode;
using ditto::pack_int4_x16;

// The high parts (delta - lo) / 16 = floor((delta + 8) / 16) of the 4 byte
// lanes of delta = a - p, one a byte, exact. Bytes 0 and 2 (then 1 and 3)
// go to 16-bit lanes as unsigned values (x ^ 0x80 keeps every
// difference); there delta + 0x1008 lies in [0x0f09, 0x1107] and borrows
// nothing from the next lane, and a shift by 4 leaves
// floor((delta + 8) / 16) + 0x100, whose low byte is the high part.
__device__ __forceinline__ uint32_t high4(uint32_t a, uint32_t p) {
  a ^= 0x80808080u;
  p ^= 0x80808080u;
  const uint32_t even =
      (__byte_perm(a, 0, 0x4240) + 0x10081008u - __byte_perm(p, 0, 0x4240)) >> 4;
  const uint32_t odd =
      (__byte_perm(a, 0, 0x4341) + 0x10081008u - __byte_perm(p, 0, 0x4341)) >> 4;
  return __byte_perm(even, odd, 0x6240);
}

template <int C>
__global__ void __launch_bounds__(Geometry<C>::THREADS)
    diff_encode_fused_kernel(const int8_t* __restrict__ xt, const int8_t* __restrict__ xp,
                             int32_t* __restrict__ classes, int8_t* __restrict__ dc,
                             int8_t* __restrict__ dh, int64_t k, int64_t sx, int64_t sc,
                             int low_max) {
  __shared__ TileMax<C> share;
  tile_begin<C>(share);
  const Slab s = slab_of<C>(k, sx, sc);
  uint4 a[Geometry<C>::VECS], p[Geometry<C>::VECS];
  load_slab<C>(xt, xp, s, k, a, p);
  const int cls = tile_class(tile_max<C>(slab_max<C>(a, p), share, s.rank), low_max);
  if (s.rank == 0 && threadIdx.x == 0) classes[s.cls_at] = cls;
  if (cls != 0) {
#pragma unroll
    for (int i = 0; i < Geometry<C>::VECS; ++i) {
      const int64_t at = s.off + vec_at<C>(i, k);  // even: K is a multiple of 128
      // per-byte difference mod 256: its low nibbles are delta's
      const uint4 d = make_uint4(__vsub4(a[i].x, p[i].x), __vsub4(a[i].y, p[i].y),
                                 __vsub4(a[i].z, p[i].z), __vsub4(a[i].w, p[i].w));
      *reinterpret_cast<uint2*>(dc + at / 2) = pack_int4_x16(d);
      if (cls == 2)
        *reinterpret_cast<uint4*>(dh + at) =
            make_uint4(high4(a[i].x, p[i].x), high4(a[i].y, p[i].y), high4(a[i].z, p[i].z),
                       high4(a[i].w, p[i].w));
    }
  }
}

}  // namespace

// cluster: the blocks a tile is split over, 1, 2, 4 or 8; -1 for another.
extern "C" int ditto_diff_encode_fused(const void* xt, const void* xp, void* classes, void* dc,
                                       void* dh, int64_t batch, int64_t m, int64_t k,
                                       int64_t sx, int64_t sc, int low_max, int cluster,
                                       void* stream) {
  return with_cluster(cluster, [&](auto c) {
    constexpr int C = decltype(c)::value;
    return launch_tiles<C>(diff_encode_fused_kernel<C>, batch, m, k, stream,
                           static_cast<const int8_t*>(xt), static_cast<const int8_t*>(xp),
                           static_cast<int32_t*>(classes), static_cast<int8_t*>(dc),
                           static_cast<int8_t*>(dh), k, sx, sc, low_max);
  });
}
