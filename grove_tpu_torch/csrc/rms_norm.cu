// RMS normalisation of each row, on Hopper (sm_90a).
//
// The JAX package's rms_norm (grove_tpu/ops/norms.py) is an XLA
// composition, and its PyTorch port was one too: a cast to f32, the square,
// a mean over the row, rsqrt, two products and the cast back, nine kernels
// per call. Its mean is PyTorch's reduction kernel, whose split of a row's
// sum across threads and blocks follows the number of rows, so a row's bits
// depended on how many rows the call held (4 and 16 rows of llama-1b's
// d = 2048 gave a row another last bit). Speculative decoding verifies k + 1
// rows per sequence where sequential decoding runs one, and commits a token
// only if the two agree bitwise, so this kernel fixes the order:
//
//   out[r, i] = T( (f32(x[r, i]) * rsqrt(sum_j f32(x[r, j])^2 / d + eps))
//                  * f32(w[i]) )
//
// One CTA of kThreads threads per row. Thread t sums the squares of columns
// t, t + kThreads, ... in that order; the warps reduce by a fixed xor
// butterfly and warp 0 adds the eight warp sums in warp order. The order
// depends on d alone, never on the number of rows or on which CTA takes a
// row, so a row's output is a function of that row. rsqrt is the IEEE
// 1 / sqrt, built without --use_fast_math. What bounds the kernel is bytes
// (each element read twice from L1 or L2, once from device memory, written
// once; a few operations per byte); a decode step's 32 rows of 2048 move
// 256 KB, well under a launch's floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float rstd;
  const T* row = x + (size_t)blockIdx.x * d;
  T* dst = out + (size_t)blockIdx.x * d;
  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f(row[i]);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = warp_sums[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) sum = __fadd_rn(sum, warp_sums[k]);
    rstd = 1.f / sqrtf(__fadd_rn(sum / (float)d, eps));
  }
  __syncthreads();
  const float s = rstd;
  for (int i = threadIdx.x; i < d; i += kThreads)
    dst[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(row[i]), s), to_f(w[i])));
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* out, int rows, int d,
            float eps, cudaStream_t st) {
  rms_norm_kernel<T, W><<<rows, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), d, eps);
}

const void* pick(int x_dtype, int w_dtype) {
  if (x_dtype == 0)
    return w_dtype == 0 ? (const void*)rms_norm_kernel<float, float>
                        : (const void*)rms_norm_kernel<float, __nv_bfloat16>;
  return w_dtype == 0
             ? (const void*)rms_norm_kernel<__nv_bfloat16, float>
             : (const void*)rms_norm_kernel<__nv_bfloat16, __nv_bfloat16>;
}

}  // namespace

// x, out: [rows, d] contiguous, of type x_dtype (0 f32, 1 bf16); w: [d] of
// type w_dtype. Returns a cudaError_t.
extern "C" int grove_rms_norm(const void* x, const void* w, void* out,
                              int rows, int d, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  if (x == nullptr || w == nullptr || out == nullptr || rows <= 0 ||
      d <= 0 || (x_dtype != 0 && x_dtype != 1) ||
      (w_dtype != 0 && w_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (w_dtype == 0) launch<float, float>(x, w, out, rows, d, eps, st);
    else launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, st);
  } else {
    if (w_dtype == 0) launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, st);
    else launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, st);
  }
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of one build: out[0..1].
extern "C" int grove_rms_norm_info(int x_dtype, int w_dtype, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, pick(x_dtype, w_dtype));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* grove_rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
