// RMS normalisation of each row, alone or after a residual add, on Hopper
// (sm_90a).
//
// Replaces the JAX package's rms_norm (grove_tpu/ops/norms.py:10) and the
// residual adds before it (x + out.astype(x.dtype) in _attn_out and
// _mlp_block, grove_tpu/models/llama.py:175-193), which XLA fuses into one
// pass on the TPU. Two functions:
//
//   rms_norm:      out[r, i] = T( (f32(x[r, i]) * rstd[r]) * f32(w[i]) )
//   add_rms_norm:  s[r, i] = T( f32(x[r, i]) + f32(delta[r, i]) ),
//                  out[r, i] = T( (f32(s[r, i]) * rstd[r]) * f32(w[i]) )
//
// with rstd[r] = 1 / sqrt(sum_j f32(v[r, j])^2 / d + eps) over the normed
// row v (x, or s). The add is torch's (and JAX's) bf16 add: one rounding of
// the f32 sum. add_rms_norm writes s and out in one pass; its out is
// rms_norm(s) bit for bit, since both take the same code.
//
// Row invariance. A row's sum of squares runs in a fixed order that depends
// on d alone: thread t sums its elements (vectors t, t + threads, ... and
// within each vector in order; threads_for fixes the thread count from
// d), each warp reduces by a fixed xor butterfly, and every thread adds
// the warp sums in warp order. So a row's bits never depend on the number
// of rows or on which CTA takes the row: speculative decoding's verify chunk
// (k + 1 rows per sequence) reproduces sequential decoding (one row)
// bitwise. Each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: nvcc would contract them into FMAs), and rstd is the IEEE
// 1 / sqrt (built without --use_fast_math).
//
// Bound by bytes: x (and delta) read once, out (and s) written once, a few
// operations per byte. The design: one CTA per row with one thread per
// 16-byte vector (up to 256 threads: llama-1b's d = 2,048 bf16 is one
// vector a thread), so the row's loads are all in flight at once and each
// thread's serial work is a few instructions, which is what decides the
// time at a decode step's 32 rows; vector loads and stores where d and the
// pointers allow (else one element at a time); the first kHeld vectors of
// each thread stay in registers between the sum and the scaling, the rest
// are read again (from L1 or L2). One warp per row was slower at 32 rows:
// a warp's 64 elements a lane ran serially with nothing to hide them.
//
// The C entry returns cudaGetLastError() after the launch; it launches on
// the given stream and never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per row at most
constexpr int kHeld = 4;          // vectors per thread kept in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// The normed row's vector at element i: x's, or s = T(x + delta).
template <typename T, int kVec, bool kAdd>
__device__ __forceinline__ Vec<T, kVec> load_row(const T* __restrict__ x,
                                                 const T* __restrict__ delta,
                                                 int i) {
  using V = Vec<T, kVec>;
  V v = *reinterpret_cast<const V*>(x + i);
  if constexpr (kAdd) {
    const V dv = *reinterpret_cast<const V*>(delta + i);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v.v[j] = from_f<T>(__fadd_rn(to_f(v.v[j]), to_f(dv.v[j])));
  }
  return v;
}

// out[i .. i + kVec) = T((v * rstd) * w): the weight as one vector where
// it has x's type (the host checks its alignment), else element by
// element.
template <typename T, typename W, int kVec>
__device__ __forceinline__ void store_normed(T* __restrict__ out,
                                             const W* __restrict__ w, int i,
                                             const Vec<T, kVec>& v,
                                             float rstd) {
  Vec<W, kVec> wv;
  if constexpr (sizeof(W) == sizeof(T)) {
    wv = *reinterpret_cast<const Vec<W, kVec>*>(w + i);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) wv.v[j] = w[i + j];
  }
  Vec<T, kVec> o;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    o.v[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(v.v[j]), rstd),
                                 to_f(wv.v[j])));
  *reinterpret_cast<Vec<T, kVec>*>(out + i) = o;
}

// Grid: one CTA per row; blockDim.x threads (a multiple of 32, fixed by d:
// threads_for). Thread t takes vectors t, t + blockDim.x, ... of the row
// (d % kVec == 0, every pointer kVec-element aligned).
template <typename T, typename W, bool kAdd, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                    const W* __restrict__ w, T* __restrict__ s_out,
                    T* __restrict__ out, int rows, int d, float eps) {
  using V = Vec<T, kVec>;
  __shared__ float warp_sums[kMaxThreads / 32];
  const size_t off = (size_t)blockIdx.x * d;
  x += off;
  out += off;
  if constexpr (kAdd) {
    delta += off;
    s_out += off;
  }
  const int tid = threadIdx.x, nt = blockDim.x, n_vec = d / kVec;
  V held[kHeld];
  float acc = 0.f;
  // Pass 1: the sum of squares (and s), in an order fixed by d.
#pragma unroll
  for (int p = 0; p < kHeld; ++p) {
    const int v = tid + p * nt;
    if (v < n_vec) {
      held[p] = load_row<T, kVec, kAdd>(x, delta, v * kVec);
      if constexpr (kAdd) *reinterpret_cast<V*>(s_out + v * kVec) = held[p];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f(held[p].v[j]);
        acc = __fadd_rn(acc, __fmul_rn(f, f));
      }
    }
  }
  for (int v = tid + kHeld * nt; v < n_vec; v += nt) {
    const V r = load_row<T, kVec, kAdd>(x, delta, v * kVec);
    if constexpr (kAdd) *reinterpret_cast<V*>(s_out + v * kVec) = r;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_f(r.v[j]);
      acc = __fadd_rn(acc, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  if ((tid & 31) == 0) warp_sums[tid >> 5] = acc;
  __syncthreads();
  float sum = warp_sums[0];  // every thread, in warp order
  for (int k = 1; k < (nt >> 5); ++k) sum = __fadd_rn(sum, warp_sums[k]);
  const float rstd = 1.f / sqrtf(__fadd_rn(sum / (float)d, eps));
  // Pass 2: scale and store.
#pragma unroll
  for (int p = 0; p < kHeld; ++p) {
    const int v = tid + p * nt;
    if (v < n_vec) store_normed<T, W, kVec>(out, w, v * kVec, held[p], rstd);
  }
  for (int v = tid + kHeld * nt; v < n_vec; v += nt)
    store_normed<T, W, kVec>(out, w, v * kVec,
                             load_row<T, kVec, kAdd>(x, delta, v * kVec),
                             rstd);
}

// Threads per row: one per vector up to kMaxThreads, whole warps.
int threads_for(int n_vec) {
  const int t = (n_vec + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T, typename W, bool kAdd, int kVec>
const void* kernel_of() {
  return reinterpret_cast<const void*>(rms_norm_kernel<T, W, kAdd, kVec>);
}

// The build for (x type, weight type, add, vectorized).
const void* pick(int x_dtype, int w_dtype, bool add, bool vec) {
#define PICK(T, W, V)                                             \
  return add ? kernel_of<T, W, true, V>() : kernel_of<T, W, false, V>()
  if (x_dtype == 0) {
    if (w_dtype == 0) {
      if (vec) PICK(float, float, 4);
      PICK(float, float, 1);
    }
    if (vec) PICK(float, __nv_bfloat16, 4);
    PICK(float, __nv_bfloat16, 1);
  }
  if (w_dtype == 0) {
    if (vec) PICK(__nv_bfloat16, float, 8);
    PICK(__nv_bfloat16, float, 1);
  }
  if (vec) PICK(__nv_bfloat16, __nv_bfloat16, 8);
  PICK(__nv_bfloat16, __nv_bfloat16, 1);
#undef PICK
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x, out (and delta, s_out): [rows, d] contiguous, of type x_dtype (0 f32,
// 1 bf16); w: [d] of type w_dtype. delta == nullptr: out = rms_norm(x);
// else s_out = x + delta and out = rms_norm(s_out). 16-byte vectors when
// d and every pointer allow, else elements. Returns a cudaError_t.
extern "C" int grove_rms_norm(const void* x, const void* delta, const void* w,
                              void* s_out, void* out, int rows, int d,
                              float eps, int x_dtype, int w_dtype,
                              void* stream) {
  const bool add = delta != nullptr;
  if (x == nullptr || w == nullptr || out == nullptr ||
      (add && s_out == nullptr) || rows <= 0 || d <= 0 ||
      (x_dtype != 0 && x_dtype != 1) || (w_dtype != 0 && w_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int vec_n = x_dtype == 0 ? 4 : 8;  // 16 bytes of x
  const bool vec = d % vec_n == 0 && aligned(x, 16) && aligned(out, 16) &&
                   aligned(delta, 16) && aligned(s_out, 16) &&
                   (x_dtype != w_dtype || aligned(w, 16));
  if (!add) s_out = nullptr;
  const void* fn = pick(x_dtype, w_dtype, add, vec);
  void* args[] = {&x, &delta, &w, &s_out, &out, &rows, &d, &eps};
  const cudaError_t err = cudaLaunchKernel(
      fn, dim3(rows), dim3(threads_for(vec ? d / vec_n : d)), args, 0,
      static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Registers and local (spill) bytes per thread of one build: out[0..1].
extern "C" int grove_rms_norm_info(int x_dtype, int w_dtype, int add,
                                   int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, pick(x_dtype, w_dtype, add != 0, true));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* grove_rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
