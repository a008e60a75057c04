// The two crossings of the int8 boundary of the compiled step, each one pass
// over memory, for sm_90a:
//
//   quantize_rows:   q[i] = clamp(rint(x[i] / s[i / group]), -127, 127) as int8
//   dequantize_rows: out[r, c] = ((float)y[r, c] * s_row[r / row_group]) * s_col (+ bias[c])
//                    with s_col = s_col[c] (a column vector) or s_col[r / col_group]
//
// Replaces no TPU kernel: the reference leaves these chains to XLA, which
// fuses each into one loop. PyTorch runs them as a chain of launches (a
// broadcast divide, round, clamp and a cast on the way in, a cast and two or
// three broadcast products on the way out), about 29 and 32 bytes moved an
// element where one pass moves 5 and 8, and they took most of the replayed
// step's device time (PERF.md). Both kernels give the chains' bits:
// __fdiv_rn is IEEE division (never a reciprocal product), rintf rounds
// half to even as torch.round does, the clamp passes NaN through as
// PyTorch's does before the cast; the products and the bias add are written
// as __int2float_rn / __fmul_rn / __fadd_rn, one rounding each as PyTorch
// rounds them, because nvcc would contract a*b + c into an FMA.
//
// What bounds them on the H100: bytes, at a few operations an element (5
// and 8 bytes an element against the card's 3.35 TB/s). Hence one pass and
// 16-byte loads, a warp's on consecutive addresses. A quantize block takes
// 4096 elements: each thread loads four float4 of them, 1024 elements
// apart, before it divides, and stores each four int8 as one 32-bit word;
// a float4 never straddles a scale group where the group is a multiple of
// 4. An operand that is the transpose of a contiguous tensor (attention's
// V^T) is read in place by a tiled kernel: a block takes 8 rows x 256
// columns of q, read as 256 source rows of 32 bytes into shared memory and
// written as 8 rows of 256 bytes (a warp's each), the 8 rows' scales
// loaded once; a copy to a contiguous tensor first would move 8 bytes an
// element more. A dequantize thread loads 4 int32 of a row as one int4 and stores 4
// floats as one float4. A thread's scale group, row and batch are found by
// integer division, 32-bit where the operands allow it. Where a vector
// would straddle a group or a row's end, or a pointer, width or stride is
// not aligned to it, the thread takes the scalar path for its elements, so
// any width and group is right. The dequantize reads y as (batch, rows,
// width) through its row and batch strides (elements), so a row and
// column slice of a padded GEMM result is read in place; `out` is (batch x
// rows, width) contiguous. Scales and bias are read as scalars (small, they
// stay in cache), so they need 4-byte alignment only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QTHREADS = 256;
constexpr int QELEMS = 16;  // elements a quantize thread
constexpr int DTHREADS = 256;
constexpr int DELEMS = 4;  // elements a dequantize thread

// NaN passes the clamp and converts to 0 (cvt's rule for NaN, which
// PyTorch's cast on the card gives too); a static_cast of a NaN would be
// undefined.
__device__ __forceinline__ int8_t quantize1(float x, float s) {
  float v = rintf(__fdiv_rn(x, s));
  if (!isnan(v)) v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rz(v));
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float s) {
  return static_cast<uint32_t>(static_cast<uint8_t>(quantize1(v.x, s))) |
         static_cast<uint32_t>(static_cast<uint8_t>(quantize1(v.y, s))) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(quantize1(v.z, s))) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(quantize1(v.w, s))) << 24;
}

template <typename I>
__global__ void __launch_bounds__(QTHREADS)
    quantize_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                         int8_t* __restrict__ q, I n, I group, bool vec) {
  constexpr int CHUNKS = QELEMS / 4;  // float4 a thread
  const I base = static_cast<I>(blockIdx.x) * (QTHREADS * QELEMS) + threadIdx.x * 4;
  if (vec && base + (CHUNKS - 1) * QTHREADS * 4 + 4 <= n) {
    float4 v[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
      v[k] = *reinterpret_cast<const float4*>(x + base + k * QTHREADS * 4);
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const I i = base + k * QTHREADS * 4;
      *reinterpret_cast<uint32_t*>(q + i) = quantize4(v[k], scale[i / group]);
    }
    return;
  }
  for (int k = 0; k < CHUNKS; ++k)
    for (int j = 0; j < 4; ++j) {
      const I i = base + k * QTHREADS * 4 + j;
      if (i < n) q[i] = quantize1(x[i], scale[i / group]);
    }
}

constexpr int TR = 8;      // rows of q a transposed tile (a warp's each)
constexpr int TC = 256;    // columns of q a transposed tile
constexpr int TPAD = 4;    // keeps the tile's rows 16-byte aligned, its stores conflict-free

// q (batch, rows, width) from x read as (batch, width, rows), contiguous;
// q's row g = b * rows + r takes scale[g / rows_each]. A block of
// QTHREADS takes a TR x TC tile of q: each thread loads 8 floats of it
// (a warp 4 source rows x 32 bytes), the tile is staged in shared memory
// as q's rows, and warp r writes row r as 4-byte words of 4 int8. Block
// indices are 64-bit: a few divisions a block.
__global__ void __launch_bounds__(QTHREADS)
    quantize_rows_t_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                           int8_t* __restrict__ q, int64_t rows, int64_t width,
                           int64_t tiles_r, int64_t tiles_c, int64_t rows_each, bool vec) {
  static_assert(QTHREADS == TR * 32 && TC % 128 == 0, "a warp a row, 4 columns a lane");
  __shared__ __align__(16) float tile[TR][TC + TPAD];
  __shared__ float s[TR];
  const int64_t blk = blockIdx.x;
  const int64_t b = blk / (tiles_r * tiles_c);
  const int64_t r0 = blk / tiles_c % tiles_r * TR, c0 = blk % tiles_c * TC;
  const int t = threadIdx.x;
  const float* xb = x + b * rows * width;
#pragma unroll
  for (int k = 0; k < TR * TC / QTHREADS; ++k) {
    const int e = t + k * QTHREADS, c = e / TR, r = e % TR;
    if (c0 + c < width && r0 + r < rows) tile[r][c] = xb[(c0 + c) * rows + r0 + r];
  }
  if (t < TR && r0 + t < rows) s[t] = scale[(b * rows + r0 + t) / rows_each];
  __syncthreads();
  const int r = t / 32, lane = t % 32;
  if (r0 + r >= rows) return;
  int8_t* qr = q + (b * rows + r0 + r) * width + c0;
  const float sr = s[r];
#pragma unroll
  for (int h = 0; h < TC; h += 128) {
    const int c = h + 4 * lane;
    if (vec && c0 + c + 4 <= width) {
      *reinterpret_cast<uint32_t*>(qr + c) =
          quantize4(*reinterpret_cast<const float4*>(&tile[r][c]), sr);
    } else {
      for (int j = 0; j < 4 && c0 + c + j < width; ++j) qr[c + j] = quantize1(tile[r][c + j], sr);
    }
  }
}

__device__ __forceinline__ float dequantize1(int32_t y, float sr, float sc, const float* bias,
                                             int64_t c) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(y), sr), sc);
  return bias != nullptr ? __fadd_rn(v, bias[c]) : v;
}

// Row r of y is row r % batch_rows of batch r / batch_rows. col_group 0:
// s_col is a vector over the columns; else one value a group of col_group
// rows. bias may be null.
template <typename I>
__global__ void __launch_bounds__(DTHREADS)
    dequantize_rows_kernel(const int32_t* __restrict__ y, float* __restrict__ out,
                           const float* __restrict__ s_row, const float* __restrict__ s_col,
                           const float* __restrict__ bias, I rows, I width, I chunks,
                           I batch_rows, int64_t ld, int64_t batch_ld, I row_group,
                           I col_group, bool vec) {
  const I u = static_cast<I>(blockIdx.x) * DTHREADS + threadIdx.x;
  if (u >= rows * chunks) return;
  const I r = u / chunks;
  const I c = (u - r * chunks) * DELEMS;
  const I b = batch_rows == rows ? 0 : r / batch_rows;
  const float sr = s_row[row_group == 1 ? r : r / row_group];
  const float sg = col_group ? s_col[col_group == 1 ? r : r / col_group] : 0.0f;
  const int32_t* yr = y + static_cast<int64_t>(b) * batch_ld +
                      static_cast<int64_t>(r - b * batch_rows) * ld;
  float* o = out + static_cast<int64_t>(r) * width;
  if (vec && c + DELEMS <= width) {
    const int4 v = *reinterpret_cast<const int4*>(yr + c);
    float4 f;
    f.x = dequantize1(v.x, sr, col_group ? sg : s_col[c], bias, c);
    f.y = dequantize1(v.y, sr, col_group ? sg : s_col[c + 1], bias, c + 1);
    f.z = dequantize1(v.z, sr, col_group ? sg : s_col[c + 2], bias, c + 2);
    f.w = dequantize1(v.w, sr, col_group ? sg : s_col[c + 3], bias, c + 3);
    *reinterpret_cast<float4*>(o + c) = f;
    return;
  }
  for (I j = c; j < c + DELEMS && j < width; ++j)
    o[j] = dequantize1(yr[j], sr, col_group ? sg : s_col[j], bias, j);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int64_t blocks_for(int64_t work, int threads) { return (work + threads - 1) / threads; }

}  // namespace

// q: n elements, contiguous; scale: one value a group of `group`
// consecutive elements of q. x: n elements, contiguous (t_rows and t_width
// 0, one thread a 16 elements), or the transpose of contiguous (n /
// (t_rows x t_width), t_width, t_rows) matrices, q their (t_rows, t_width)
// transposes (group then a multiple of t_width). An argument out of range
// (the wrapper checks them first) returns cudaErrorInvalidValue. Indices
// are 32-bit where n allows it, else 64-bit.
extern "C" int ditto_quantize_rows(const void* x, const void* scale, void* q, int64_t n,
                                   int64_t group, int64_t t_rows, int64_t t_width,
                                   void* stream) {
  if (n <= 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* sf = static_cast<const float*>(scale);
  auto* qi = static_cast<int8_t*>(q);
  auto st = static_cast<cudaStream_t>(stream);
  if (t_rows || t_width) {
    if (t_rows <= 0 || t_width <= 0 || n % (t_rows * t_width) || group <= 0 ||
        group % t_width)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles_r = (t_rows + TR - 1) / TR, tiles_c = (t_width + TC - 1) / TC;
    const int64_t blocks = n / (t_rows * t_width) * tiles_r * tiles_c;
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    quantize_rows_t_kernel<<<static_cast<unsigned>(blocks), QTHREADS, 0, st>>>(
        xf, sf, qi, t_rows, t_width, tiles_r, tiles_c, group / t_width,
        aligned16(q) && t_width % 4 == 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = blocks_for((n + QELEMS - 1) / QELEMS, QTHREADS);
  if (group <= 0 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(x) && aligned16(q) && group % 4 == 0;
  if (n + QELEMS * QTHREADS < INT32_MAX)
    quantize_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), QTHREADS, 0, st>>>(
        xf, sf, qi, static_cast<uint32_t>(n), static_cast<uint32_t>(group), vec);
  else
    quantize_rows_kernel<uint64_t><<<static_cast<unsigned>(blocks), QTHREADS, 0, st>>>(
        xf, sf, qi, static_cast<uint64_t>(n), static_cast<uint64_t>(group), vec);
  return static_cast<int>(cudaGetLastError());
}

// y: batch_rows rows of `width` int32 a batch, at a row stride of `ld` and
// a batch stride of `batch_ld` elements, `rows` rows in all; out: (rows,
// width) float32, contiguous; s_row: one value a group of row_group rows;
// s_col: a vector of `width` values (col_group 0) or one value a group of
// col_group rows; bias: `width` values or null. One thread a 4 elements.
extern "C" int ditto_dequantize_rows(const void* y, void* out, const void* s_row,
                                     const void* s_col, const void* bias, int64_t rows,
                                     int64_t width, int64_t batch_rows, int64_t ld,
                                     int64_t batch_ld, int64_t row_group, int64_t col_group,
                                     void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  const int64_t chunks = (width + DELEMS - 1) / DELEMS;
  const int64_t blocks = blocks_for(rows * chunks, DTHREADS);
  if (batch_rows <= 0 || rows % batch_rows || ld < width || row_group <= 0 || col_group < 0 ||
      blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(y) && aligned16(out) && width % DELEMS == 0 &&
                   ld % DELEMS == 0 && batch_ld % DELEMS == 0;
  const auto* yi = static_cast<const int32_t*>(y);
  auto* of = static_cast<float*>(out);
  const auto* sr = static_cast<const float*>(s_row);
  const auto* sc = static_cast<const float*>(s_col);
  const auto* bf = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (rows * chunks + DTHREADS < INT32_MAX)
    dequantize_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), DTHREADS, 0, st>>>(
        yi, of, sr, sc, bf, static_cast<uint32_t>(rows), static_cast<uint32_t>(width),
        static_cast<uint32_t>(chunks), static_cast<uint32_t>(batch_rows), ld, batch_ld,
        static_cast<uint32_t>(row_group), static_cast<uint32_t>(col_group), vec);
  else
    dequantize_rows_kernel<uint64_t><<<static_cast<unsigned>(blocks), DTHREADS, 0, st>>>(
        yi, of, sr, sc, bf, static_cast<uint64_t>(rows), static_cast<uint64_t>(width),
        static_cast<uint64_t>(chunks), static_cast<uint64_t>(batch_rows), ld, batch_ld,
        static_cast<uint64_t>(row_group), static_cast<uint64_t>(col_group), vec);
  return static_cast<int>(cudaGetLastError());
}
