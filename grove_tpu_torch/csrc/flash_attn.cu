// Causal GQA flash attention, forward, for prefill on Hopper (sm_90a).
//
// Computes the function of grove_tpu/ops/pallas_flash.py::_flash_kernel:
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/g] * d^-0.5) v[b, j, h/g]
// over j <= i, with g = H / KVH query heads per kv head. The online-softmax
// state (row max m, row sum l, accumulator acc) is f32; q is scaled by
// d^-0.5 in f32; masked scores are NEG_INF = -1e30 and a tile whose row is
// wholly masked contributes p = 0 (the TPU kernel's rules); the output is
// acc / max(l, 1e-30) rounded once to the input type.
//
// Blocking. One CTA per (q-tile of kBlockQ rows, head, batch); heavy q-tiles
// (near the end of the sequence, with more keys below the diagonal) are
// scheduled first. Four warps own kBlockQ / 4 rows each. The CTA walks the
// k-tiles of kBlockK keys up to the diagonal of its last row; K and V tiles
// are staged in shared memory as f32. For scores each lane owns one key of
// the tile; for the output each lane owns four head-dim columns. Row max
// and row sum reduce across the warp with shuffles; the probabilities go
// through a per-warp shared tile to the P.V product.
//
// Inputs are read through their [b, s, h, d] strides directly (no head-major
// transpose). Rows and keys past the sequence end are masked here, so any
// sequence length works. Supported: f32 and bf16, d <= 128, d % 8 == 0.
//
// C entry point: grove_flash_attn_fwd, returning cudaGetLastError() after
// the launch. Shared memory exceeds the 48 KB static limit at d = 128, so
// the kernel is launched with dynamic shared memory after raising its
// cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 4;
constexpr int kRows = kBlockQ / kWarps;  // rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

struct Strides {
  // Element strides of the batch, sequence and head axes (the head-dim
  // axis is contiguous) for q, k, v and out.
  long long qb, qs, qh;
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long ob, os, oh;
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage `rows` rows of width d (from `base`, row stride `rs` elements) into
// shared f32 `dst` with row stride `ds`, times `mul`; rows at or past
// `valid` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ds, const T* base,
                                      long long rs, int rows, int valid,
                                      int d, float mul) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float v[8];
    if (r < valid) {
      load8(base + r * rs + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= mul;
    float* out = dst + r * ds + c;
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KVH, int d, Strides st, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dk = d + 4;                 // padded K row: conflict-free float4
  float* Qs = smem;                     // [kBlockQ][d], pre-scaled
  float* Ks = Qs + kBlockQ * d;         // [kBlockK][d + 4]
  float* Vs = Ks + kBlockK * dk;        // [kBlockK][d]
  float* Ps = Vs + kBlockK * d;         // [kWarps][kRows][kBlockK]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int q0 = qt * kBlockQ;
  const int q_valid = min(kBlockQ, S - q0);
  const T* qbase = q + b * st.qb + (long long)q0 * st.qs + h * st.qh;
  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;

  stage(Qs, d, qbase, st.qs, kBlockQ, q_valid, d, scale);

  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  const int row0 = q0 + warp * kRows;   // absolute position of this warp's row 0
  const int col = lane * 4;             // this lane's output columns
  const bool col_ok = col < d;
  const float* Qw = Qs + warp * kRows * d;
  float* Pw = Ps + warp * kRows * kBlockK;
  // k-tiles whose first key is at or before the CTA's last row.
  const int n_kt = (q0 + q_valid - 1) / kBlockK + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile fully consumed (and Qs staged)
    const int k_valid = min(kBlockK, S - k0);
    stage(Ks, dk, kbase + (long long)k0 * st.ks, st.ks, kBlockK, k_valid, d,
          1.f);
    stage(Vs, d, vbase + (long long)k0 * st.vs, st.vs, kBlockK, k_valid, d,
          1.f);
    __syncthreads();

    // Scores: this lane's key against the warp's rows.
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float* krow = Ks + lane * dk;
    for (int c = 0; c < d; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + r * d + c);
        sc[r] = fmaf(qv.x, kv.x, sc[r]);
        sc[r] = fmaf(qv.y, kv.y, sc[r]);
        sc[r] = fmaf(qv.z, kv.z, sc[r]);
        sc[r] = fmaf(qv.w, kv.w, sc[r]);
      }
    }

    // Online softmax over this tile.
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = (kpos <= row0 + r) ? sc[r] : kNegInf;
      const float block_m = warp_max(s);
      const float m_new = fmaxf(m[r], block_m);
      const float p = (block_m == kNegInf) ? 0.f : expf(s - m_new);
      const float corr = (m[r] == kNegInf) ? 0.f : expf(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= corr;
      Pw[r * kBlockK + lane] = p;
    }
    __syncwarp();

    // acc += P . V on this lane's columns.
    if (col_ok) {
      for (int j = 0; j < kBlockK; j += 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(Vs + (j + 0) * d + col);
        const float4 v1 = *reinterpret_cast<const float4*>(Vs + (j + 1) * d + col);
        const float4 v2 = *reinterpret_cast<const float4*>(Vs + (j + 2) * d + col);
        const float4 v3 = *reinterpret_cast<const float4*>(Vs + (j + 3) * d + col);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(Pw + r * kBlockK + j);
          acc[r][0] = fmaf(p.x, v0.x, fmaf(p.y, v1.x, fmaf(p.z, v2.x, fmaf(p.w, v3.x, acc[r][0]))));
          acc[r][1] = fmaf(p.x, v0.y, fmaf(p.y, v1.y, fmaf(p.z, v2.y, fmaf(p.w, v3.y, acc[r][1]))));
          acc[r][2] = fmaf(p.x, v0.z, fmaf(p.y, v1.z, fmaf(p.z, v2.z, fmaf(p.w, v3.z, acc[r][2]))));
          acc[r][3] = fmaf(p.x, v0.w, fmaf(p.y, v1.w, fmaf(p.z, v2.w, fmaf(p.w, v3.w, acc[r][3]))));
        }
      }
    }
    __syncwarp();
  }

  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int pos = row0 + r;
    if (pos >= S) break;
    const float den = fmaxf(l[r], 1e-30f);
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = acc[r][c] / den;
    store4(o + b * st.ob + (long long)pos * st.os + h * st.oh + col, out);
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t)(kBlockQ * d + kBlockK * (d + 4) + kBlockK * d +
                  kWarps * kRows * kBlockK);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KVH, int d, const Strides& st,
                   float scale, cudaStream_t stream) {
  static bool smem_raised = false;  // once per instantiation and process
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const size_t smem = smem_bytes(d);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KVH, d, st, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` points to 12 int64 values in
// the order of Strides. Returns cudaSuccess (0) or the launch error.
extern "C" int grove_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, int dtype, int B,
                                    int S, int H, int KVH, int d,
                                    const long long* strides, float scale,
                                    void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 != 0 || KVH <= 0 || H % KVH != 0 ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, S, H, KVH, d, st, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, d, st, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* grove_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
