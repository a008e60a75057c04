// Encoding Unit, batched: one int32 class per 128 x 128 tile of
// delta = x_t - x_prev:
//   0 if max|delta| == 0,  1 if max|delta| <= low_max,  else 2.
// Each tile is split over a thread-block cluster of C blocks
// (encode_sm90.cuh): every block loads its rows of both operands, the
// blocks exchange their maxima through distributed shared memory, and
// block 0 writes the class. M and K are multiples of 128.
#include "encode_sm90.cuh"

namespace {

using namespace ditto::encode;

template <int C>
__global__ void __launch_bounds__(Geometry<C>::THREADS)
    diff_encode_kernel(const int8_t* __restrict__ xt, const int8_t* __restrict__ xp,
                       int32_t* __restrict__ classes, int64_t k, int64_t sx, int64_t sc,
                       int low_max) {
  __shared__ TileMax<C> share;
  tile_begin<C>(share);
  const Slab s = slab_of<C>(k, sx, sc);
  uint4 a[Geometry<C>::VECS], p[Geometry<C>::VECS];
  load_slab<C>(xt, xp, s, k, a, p);
  const int cls = tile_class(tile_max<C>(slab_max<C>(a, p), share, s.rank), low_max);
  if (s.rank == 0 && threadIdx.x == 0) classes[s.cls_at] = cls;
}

}  // namespace

// cluster: the blocks a tile is split over, 1, 2, 4 or 8; -1 for another.
extern "C" int ditto_diff_encode(const void* xt, const void* xp, void* classes,
                                 int64_t batch, int64_t m, int64_t k, int64_t sx, int64_t sc,
                                 int low_max, int cluster, void* stream) {
  return with_cluster(cluster, [&](auto c) {
    constexpr int C = decltype(c)::value;
    return launch_tiles<C>(diff_encode_kernel<C>, batch, m, k, stream,
                           static_cast<const int8_t*>(xt), static_cast<const int8_t*>(xp),
                           static_cast<int32_t*>(classes), k, sx, sc, low_max);
  });
}
