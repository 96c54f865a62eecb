// The paged KV cache's writes, on Hopper (sm_90a): new K/V rows scattered
// through the block tables into a layer's pools, quantized for an int8 pool
// or copied as they are for a pool of the model's type.
//
// The quantizing scatter replaces the JAX package's _paged_scatter_q
// (grove_tpu/models/llama.py:525, an XLA composition, no Pallas source): for
// every (row, kv head) of the new K and V,
//
//   scale = max(max_i |x_i|, 1e-8) * f32(1 / 127),
//   code_i = clip(rint(x_i / scale), -127, 127)
//
// with x in f32 (bf16 rows widen exactly). The scale is the product with
// the reciprocal because that is what XLA makes of the JAX package's
// division by the constant 127; the codes take an IEEE division (this file
// is built without --use_fast_math, so `/` stays div.rn) and round half to
// even. So codes and scales equal the plain version's, and JAX's, bit for
// bit. The codes land at flat slot table[b, pos / bs] * bs + pos % bs of
// the int8 pool [nb, bs, n_kv, d], the scale at the same slot of the f32
// scales [nb, bs, n_kv].
//
// The plain scatter replaces _paged_scatter (grove_tpu/models/llama.py:482,
// also XLA): each row [n_kv, d] lands, as it is, at the same flat slot of a
// pool of its own type. The port's plain version is an index computation
// and two index_copy_ per layer; this is one launch, bitwise the same.
//
// Both route alike: a position whose column is past the table's width, or
// a row whose valid flag is 0, goes to slot pos % bs of block 0 (the null
// block), as the plain versions route it; a slot outside the pool is
// dropped.
//
// What bounds them on an H100: bytes (each element read once and written
// once, a few flops each for the quantizer). The designs: the quantizer
// runs one warp per (K or V, row, kv head), each lane holding 4 consecutive
// values (d <= 128), the row's absmax by five shuffles; the plain scatter
// one CTA per (K or V, row), 16 bytes per thread. One launch covers K and V
// of a layer.
//
// The C entry points return cudaGetLastError() after their launch (or the
// error that kept them from launching); they launch on the given stream and
// never synchronize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;  // 4 values per lane

__device__ __forceinline__ void load4(const float* src, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* x) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(src);
  const __nv_bfloat162 hi =
      *reinterpret_cast<const __nv_bfloat162*>(src + 2);
  x[0] = __bfloat162float(lo.x); x[1] = __bfloat162float(lo.y);
  x[2] = __bfloat162float(hi.x); x[3] = __bfloat162float(hi.y);
}

// Flat pool slot of row `row` (rows = b * s, row-major over [b, s]), or -1
// when the slot lies outside the pool [nb * bs slots].
__device__ __forceinline__ long long slot_of(long long row,
                                             const int* __restrict__ tables,
                                             const int* __restrict__ positions,
                                             const uint8_t* __restrict__ valid,
                                             int s, int w, int nb, int bs) {
  const int pos = positions[row];
  const int col = pos / bs, slot = pos % bs;
  if (pos < 0) return -1;
  const bool keep = col < w && (valid == nullptr || valid[row] != 0);
  const long long flat =
      keep ? (long long)tables[(row / s) * w + col] * bs + slot : slot;
  return flat < 0 || flat >= (long long)nb * bs ? -1 : flat;
}

// Grid: ceil(2 * rows * n_kv / kWarps) CTAs of kThreads. k, v:
// [rows, n_kv, d] (rows = b * s); positions [rows] int32 (>= 0); valid
// [rows] bytes or null; tables [b, w] int32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_q_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     int8_t* kpool, int8_t* vpool, float* kscale,
                     float* vscale, const int* __restrict__ tables,
                     const int* __restrict__ positions,
                     const uint8_t* __restrict__ valid, long long rows,
                     int s, int w, int n_kv, int d, int nb, int bs) {
  const long long per = rows * n_kv;  // (row, head) items of K, then of V
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= 2 * per) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int which = item >= per ? 1 : 0;
  const long long rh = item - which * per;
  const int head = (int)(rh % n_kv);
  const long long row = rh / n_kv;
  const long long flat =
      slot_of(row, tables, positions, valid, s, w, nb, bs);
  if (flat < 0) return;

  const int c0 = 4 * lane;
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (c0 < d) load4((which ? v : k) + (row * n_kv + head) * d + c0, x);
  float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                     fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  const long long dst = flat * n_kv + head;
  if (c0 < d) {
    char4 out;
    int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = (int8_t)fminf(fmaxf(rintf(x[j] / scale), -127.f), 127.f);
    *reinterpret_cast<char4*>((which ? vpool : kpool) + dst * d + c0) = out;
  }
  if (lane == 0) (which ? vscale : kscale)[dst] = scale;
}

// Grid: 2 * rows CTAs of kThreads, one per (K or V, row). k, v: [rows,
// chunks] 16-byte chunks (a row's n_kv * d values); pools [nb * bs, chunks].
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                   uint4* kpool, uint4* vpool, const int* __restrict__ tables,
                   const int* __restrict__ positions,
                   const uint8_t* __restrict__ valid, long long rows, int s,
                   int w, int chunks, int nb, int bs) {
  const int which = blockIdx.x >= rows ? 1 : 0;
  const long long row = blockIdx.x - which * rows;
  const long long flat =
      slot_of(row, tables, positions, valid, s, w, nb, bs);
  if (flat < 0) return;
  const uint4* src = (which ? v : k) + row * chunks;
  uint4* dst = (which ? vpool : kpool) + flat * chunks;
  for (int c = threadIdx.x; c < chunks; c += kThreads) dst[c] = src[c];
}

}  // namespace

// Quantize and scatter one layer's new K and V rows. k, v: [rows, n_kv, d]
// (rows = b * s, row-major over [b, s]); kpool, vpool: [nb, bs, n_kv, d]
// int8; kscale, vscale: [nb, bs, n_kv] f32; tables [b, w] int32; positions
// [rows] int32; valid [rows] bytes or null. All contiguous; k, v 16-byte
// aligned (f32) or 8-byte aligned (bf16), pools 4-byte aligned. dtype 0 =
// f32 rows, 1 = bf16 rows.
extern "C" int grove_kv_scatter_q(const void* k, const void* v, void* kpool,
                                  void* vpool, void* kscale, void* vscale,
                                  const void* tables, const void* positions,
                                  const void* valid, int dtype, int b, int s,
                                  int w, int n_kv, int d, int nb, int bs,
                                  void* stream) {
  if (b <= 0 || s <= 0 || w <= 0 || n_kv <= 0 || d <= 0 || d > kMaxD ||
      d % 4 != 0 || nb <= 0 || bs <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * s;
  const long long warps = 2 * rows * n_kv;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(positions);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  int8_t* kp = static_cast<int8_t*>(kpool);
  int8_t* vp = static_cast<int8_t*>(vpool);
  float* ks = static_cast<float*>(kscale);
  float* vs = static_cast<float*>(vscale);
  if (dtype == 0)
    scatter_q_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), kp, vp,
        ks, vs, t, p, ok, rows, s, w, n_kv, d, nb, bs);
  else
    scatter_q_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kp, vp, ks, vs, t, p, ok, rows,
        s, w, n_kv, d, nb, bs);
  return (int)cudaGetLastError();
}

// Scatter one layer's new K and V rows, as they are, into pools of their
// type. k, v: [rows, row_bytes] (rows = b * s, row-major over [b, s]);
// kpool, vpool: [nb, bs, row_bytes]; tables [b, w] int32; positions [rows]
// int32; valid [rows] bytes or null. All contiguous and 16-byte aligned;
// row_bytes (n_kv * d * the element size) a multiple of 16.
extern "C" int grove_kv_scatter(const void* k, const void* v, void* kpool,
                                void* vpool, const void* tables,
                                const void* positions, const void* valid,
                                int b, int s, int w, int row_bytes, int nb,
                                int bs, void* stream) {
  if (b <= 0 || s <= 0 || w <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      nb <= 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * s;
  scatter_kernel<<<(unsigned)(2 * rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v),
      static_cast<uint4*>(kpool), static_cast<uint4*>(vpool),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      static_cast<const uint8_t*>(valid), rows, s, w, row_bytes / 16, nb, bs);
  return (int)cudaGetLastError();
}

extern "C" const char* grove_kv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
