// The paged KV cache's write, on Hopper (sm_90a): one layer's rope and its
// new K/V rows scattered through the block tables into the layer's pools,
// one launch per layer. A pool of the model's type takes the rows as they
// are; an int8 pool takes codes and a per-(slot, kv head) f32 scale.
//
// It replaces three things the JAX package leaves to XLA (no Pallas
// source): apply_rope on q and on k (grove_tpu/ops/rope.py), then
// _paged_scatter (grove_tpu/models/llama.py:482) or _paged_scatter_q
// (:525) of k and v. With rope off (no rope tables) it is those scatters
// alone.
//
// Rope (split halves: column i pairs with i + d/2), in f32 against the f32
// tables at the position clamped to [0, max_len - 1], then one rounding to
// the rows' type:
//
//   out_i        = (x_i * c_i) - (x_{i+d/2} * s_i)
//   out_{i+d/2}  = (x_{i+d/2} * c_i) + (x_i * s_i)
//
// each product and sum rounded to f32 on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: nvcc would contract a * b - c * d into an FMA), as PyTorch's
// separate elementwise kernels round them. So q and k equal the plain
// version's bit for bit.
//
// The int8 write quantizes the roped k after its rounding to the rows'
// type (the plain version hands the bf16 rows to the quantizer), and v as
// it is: for every (row, kv head),
//
//   scale = max(max_i |x_i|, 1e-8) * f32(1 / 127),
//   code_i = clip(rint(x_i / scale), -127, 127)
//
// in f32. The scale is the product with the reciprocal because that is what
// XLA makes of the JAX package's division by the constant 127; the codes
// take an IEEE division (this file is built without --use_fast_math, so
// `/` stays div.rn) and round half to even. Codes and scales equal the
// plain version's, and JAX's, bit for bit.
//
// Routing takes the unclamped position: a row lands at flat slot
// table[b, pos / bs] * bs + pos % bs of the pool [nb, bs, n_kv, d] (its
// scale at the same slot of [nb, bs, n_kv]); a position whose column is
// past the table's width, or a row whose valid flag is 0, goes to slot
// pos % bs of block 0 (the null block), as the plain version routes it; a
// slot outside the pool, or a negative position, is dropped. q is always
// written, roped, to its own output.
//
// What bounds it on an H100: one launch. A decode step moves a few
// hundred KB (32 rows x (16 + 2 x 8) heads x 128 at llama-1b), far under
// a launch's floor, and the rope before it was 13 PyTorch kernels per
// tensor. The design: one warp per (row, head) over the q, k
// and v heads of a layer; each lane holds the pairs (2 lane, 2 lane + 1)
// and their partners d/2 further on, so rope needs no shuffle, and reads
// its two cos and two sin values of the row once; the int8 row's absmax
// takes five shuffles. Nothing is staged in shared memory.
//
// The C entry point returns cudaGetLastError() after its launch (or the
// error that kept it from launching); it launches on the given stream and
// never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One launch's arguments; mirrored field for field by ops/kvquant.py
// (_Args). Rows are row-major over [b, s]: q [rows, n_q, d], k and v
// [rows, n_kv, d], all of the rows' type; pools [nb * bs, n_kv, d] of the
// rows' type or int8, scales [nb * bs, n_kv] f32 (int8 pools); cos and
// sin [max_len, d / 2] f32, or null for no rope (then n_q is 0);
// tables [b, w] int32; positions [rows] int32; valid [rows] bytes or null.
struct RopeScatterArgs {
  const void* q;
  const void* k;
  const void* v;
  void* q_out;
  void* kpool;
  void* vpool;
  float* kscale;
  float* vscale;
  const float* cos;
  const float* sin;
  const int* tables;
  const int* positions;
  const uint8_t* valid;
  long long rows;
  int s, w, n_q, n_kv, d, nb, bs, max_len;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;  // two pairs per lane

__device__ __forceinline__ void load2(const float* src, float* x) {
  const float2 a = *reinterpret_cast<const float2*>(src);
  x[0] = a.x;
  x[1] = a.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* src, float* x) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(src);
  x[0] = __bfloat162float(a.x);
  x[1] = __bfloat162float(a.y);
}

__device__ __forceinline__ void store2(float* dst, const float* x) {
  *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
}

// x holds values already of the rows' type, so the conversion is exact.
__device__ __forceinline__ void store2(__nv_bfloat16* dst, const float* x) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __halves2bfloat162(__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1]));
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Flat pool slot of row `row`, or -1 when it is dropped.
__device__ __forceinline__ long long slot_of(const RopeScatterArgs& a,
                                             long long row, int pos) {
  if (pos < 0) return -1;
  const int col = pos / a.bs, slot = pos % a.bs;
  const bool keep = col < a.w && (a.valid == nullptr || a.valid[row] != 0);
  const long long flat =
      keep ? (long long)a.tables[(row / a.s) * a.w + col] * a.bs + slot : slot;
  return flat < 0 || flat >= (long long)a.nb * a.bs ? -1 : flat;
}

// Grid: ceil(rows * (n_q + 2 n_kv) / kWarps) CTAs of kThreads; warp item
// (row, head) with heads ordered q, then k, then v. A lane's values: x[0..1]
// at columns 2 lane + {0, 1}, x[2..3] at d / 2 + 2 lane + {0, 1}.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    rope_scatter_kernel(const RopeScatterArgs a) {
  const int heads = a.n_q + 2 * a.n_kv;
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= a.rows * heads) return;  // whole warps leave together
  const long long row = item / heads;
  const int hh = (int)(item - row * heads);
  const int kind = hh < a.n_q ? 0 : hh < a.n_q + a.n_kv ? 1 : 2;  // q, k, v
  const int head = hh - (kind == 0 ? 0 : kind == 1 ? a.n_q : a.n_q + a.n_kv);
  const int pos = a.positions[row];
  long long flat = 0;
  if (kind != 0) {
    flat = slot_of(a, row, pos);
    if (flat < 0) return;  // the whole warp: one row
  }
  const int d = a.d, half = d >> 1, lane = threadIdx.x & 31;
  const int i0 = 2 * lane;
  const bool live = i0 < half;
  const int n = kind == 0 ? a.n_q : a.n_kv;
  const long long off = (row * n + head) * d;
  const T* src = static_cast<const T*>(kind == 0 ? a.q : kind == 1 ? a.k : a.v);
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    load2(src + off + i0, x);
    load2(src + off + half + i0, x + 2);
  }
  if (kind != 2 && a.cos != nullptr && live) {
    const int p = min(max(pos, 0), a.max_len - 1);
    float c[2], s[2];
    load2(a.cos + (long long)p * half + i0, c);
    load2(a.sin + (long long)p * half + i0, s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x1 = x[j], x2 = x[2 + j];
      x[j] = round_to(__fsub_rn(__fmul_rn(x1, c[j]), __fmul_rn(x2, s[j])), src);
      x[2 + j] =
          round_to(__fadd_rn(__fmul_rn(x2, c[j]), __fmul_rn(x1, s[j])), src);
    }
  }
  if (kind == 0) {
    if (live) {
      T* dst = static_cast<T*>(a.q_out) + off;
      store2(dst + i0, x);
      store2(dst + half + i0, x + 2);
    }
    return;
  }
  const long long dst = flat * a.n_kv + head;
  if constexpr (kQuant) {
    float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                       fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
    if (live) {
      int8_t* out = static_cast<int8_t*>(kind == 1 ? a.kpool : a.vpool) +
                    dst * d;
      char2 lo, hi;
      lo.x = (int8_t)fminf(fmaxf(rintf(x[0] / scale), -127.f), 127.f);
      lo.y = (int8_t)fminf(fmaxf(rintf(x[1] / scale), -127.f), 127.f);
      hi.x = (int8_t)fminf(fmaxf(rintf(x[2] / scale), -127.f), 127.f);
      hi.y = (int8_t)fminf(fmaxf(rintf(x[3] / scale), -127.f), 127.f);
      *reinterpret_cast<char2*>(out + i0) = lo;
      *reinterpret_cast<char2*>(out + half + i0) = hi;
    }
    if (lane == 0) (kind == 1 ? a.kscale : a.vscale)[dst] = scale;
  } else if (live) {
    T* out = static_cast<T*>(kind == 1 ? a.kpool : a.vpool) + dst * d;
    store2(out + i0, x);
    store2(out + half + i0, x + 2);
  }
}

template <typename T, bool kQuant>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&rope_scatter_kernel<T, kQuant>);
}

const void* pick(int dtype, int quant) {
  if (dtype == 0) return quant ? kernel_of<float, true>()
                               : kernel_of<float, false>();
  return quant ? kernel_of<__nv_bfloat16, true>()
               : kernel_of<__nv_bfloat16, false>();
}

}  // namespace

// Rope (when a->cos is not null) and one layer's K/V write. dtype 0 = f32
// rows, 1 = bf16 rows; quant 1 = int8 pools with f32 scales, 0 = pools of
// the rows' type. Needs d % 4 == 0 and d <= 128; pointers aligned to their
// two-element loads (8 bytes for f32 rows and the rope tables, 4 for bf16
// rows, 2 for int8 pools, 4 for scales).
extern "C" int grove_rope_scatter(const RopeScatterArgs* a, int dtype,
                                  int quant, void* stream) {
  if (a == nullptr || a->rows <= 0 || a->s <= 0 || a->w <= 0 ||
      a->n_kv <= 0 || a->n_q < 0 || (a->cos == nullptr) != (a->n_q == 0) ||
      (a->cos != nullptr && (a->sin == nullptr || a->max_len <= 0)) ||
      a->d <= 0 || a->d > kMaxD || a->d % 4 != 0 || a->nb <= 0 ||
      a->bs <= 0 || (dtype != 0 && dtype != 1) || (quant != 0 && quant != 1))
    return (int)cudaErrorInvalidValue;
  const long long warps = a->rows * (a->n_q + 2 * a->n_kv);
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (quant) rope_scatter_kernel<float, true><<<grid, kThreads, 0, st>>>(*a);
    else rope_scatter_kernel<float, false><<<grid, kThreads, 0, st>>>(*a);
  } else {
    if (quant)
      rope_scatter_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, st>>>(*a);
    else
      rope_scatter_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of one build: out[0..1].
extern "C" int grove_rope_scatter_info(int dtype, int quant, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, pick(dtype, quant));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* grove_kv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
