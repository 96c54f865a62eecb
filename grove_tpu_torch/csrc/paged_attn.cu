// Attention through a paged KV cache's block tables, for decode and for
// chunked prefill, on Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: decode_step_paged and
// prefill_chunk_paged (grove_tpu/models/llama.py) gather each layer's
// block pool into a dense [b, w * bs, n_kv, d] cache (_paged_gather) and run
// XLA's decode_attention / causal_attention on it. These kernels compute the
// same functions without materializing the gathered cache: each CTA follows
// its sequence's table entries to the pool's rows.
//
//   paged_decode:  out[b, 0, h] = sum_{p < len[b]} softmax_p(qs . k[p]) v[p]
//   paged_chunk:   out[b, i, h] = sum_{p <= off[b] + i} softmax_p(qs . k[p]) v[p]
//
// where qs = q * d^-0.5 rounded to the input type (the working-type scaling
// of the JAX and plain versions), k[p] / v[p] is row p % bs of block
// table[b, p / bs] of kv head h / g, scores are f32, and the probabilities
// are rounded to the input type before the P.V product (l sums the f32 p).
// Pools are one layer's [nb, bs, n_kv, d]; tables are [b, w] int32; len and
// off are int32 device tensors, read by the kernel (a captured CUDA graph
// freezes every host value). Table entries are clamped to [0, nb) as the
// JAX gather clamps them.
//
// What bounds them on an H100: bytes. A decode step reads every live K/V
// row once for all g query heads of its kv head and does 4 d g flops per
// row and kv head; at llama-1b (d = 128, g = 2, bf16) that is 1 flop per
// byte, far below the ~295 flops per byte where the tensor cores would
// bind. The design is therefore the simple one: CUDA cores, f32
// accumulation, K/V tiles of 32 keys staged in shared memory as f32 with
// 16-byte vector loads, and each K/V row read from device memory once per
// CTA, for all the query rows it holds.
//
// Both functions run as two kernels. Pass 1 (paged_partial_kernel) is
// split-K: one CTA per (key span, group of query rows, sequence x kv head),
// where the spans are fixed runs of split_keys positions tiling the table
// from position 0 on, so the number of spans follows the table width W,
// not the lengths, and a graph captured for a bucket serves every length
// in it. A CTA holds up to kMaxRows query rows: the g heads of its kv head
// for decode, and positions x heads for a chunk. It walks its span's
// 32-key tiles in order, online softmax per row, and writes each row's
// partial (acc, m, l); a row with no visible key in the span writes a
// neutral partial (m = -1e30, l = 0, acc = 0). Pass 2
// (paged_combine_kernel) merges each row's partials in span order.
//
// A row's result depends only on its absolute position, its q row and the
// K/V rows: tiles and spans are aligned to position 0 whatever the chunk's
// offset, a tile wholly past a row's bound leaves its state bitwise
// unchanged (p = 0, correction 1), and neutral partials add exact zeros in
// the combine. So a chunk boundary moved by a prefix-cache hit, the other
// rows of the CTA, and the table width never change a row's numbers.
//
// C entry points return cudaGetLastError() after their launches (or the
// error that kept them from launching); they launch on the given stream
// and never synchronize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;  // keys per tile: one per lane in the softmax
constexpr int kMaxD = 128;
constexpr int kMaxRows = 16;  // query rows per CTA
constexpr int kMaxElems = kMaxRows * kMaxD / kThreads;  // acc per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded through the input type (a no-op for f32).
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// 16-byte vector loads: 4 f32 or 8 bf16 elements, widened to f32.
template <typename T>
struct Vec {
  static constexpr int kElems = 16 / sizeof(T);
};

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
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

// Shared memory of one CTA (all f32): the scaled q rows, one K tile (rows
// padded to an odd stride, so that the lanes of a warp, one key each, read
// distinct banks), one V tile, the tile's scores / probabilities, and
// per-row softmax state.
struct Smem {
  int ldk;      // K tile row stride, d + 1
  float* qs;    // [rows, d]
  float* ks;    // [kTileK, ldk]
  float* vs;    // [kTileK, d]
  float* sc;    // [rows, kTileK]
  float* m;     // [rows] running max
  float* l;     // [rows] running sum of f32 p
  float* corr;  // [rows] this tile's rescale of acc
  int* lim;     // [rows] exclusive bound on the row's visible positions

  __device__ Smem(float* base, int rows, int d) {
    ldk = d + 1;
    qs = base;
    ks = qs + rows * d;
    vs = ks + kTileK * ldk;
    sc = vs + kTileK * d;
    m = sc + rows * kTileK;
    l = m + rows;
    corr = l + rows;
    lim = reinterpret_cast<int*>(corr + rows);
  }
};

size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (size_t)(rows * d + kTileK * (d + 1) + kTileK * d +
                                  rows * kTileK + 4 * rows);
}

// One key tile [t0, t0 + kTileK) of one kv head for every row of the CTA.
// Keys at positions >= tile_end are not loaded (zeros); a row sees key p
// only when p < lim[row], and lim[row] <= tile_end for every row that has
// a visible key in the tile.
template <typename T>
__device__ __forceinline__ void attend_tile(const T* kpool, const T* vpool,
                                            const int* table_row, int nb,
                                            int bs, int n_kv, int kv, int d,
                                            int t0, int tile_end, int rows,
                                            const Smem& s, float* acc) {
  constexpr int kVec = Vec<T>::kElems;
  constexpr int kRowsPerThread = kMaxRows / kWarps;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int vecs = d / kVec;
  // 1. K and V rows through the block table.
  for (int u = tid; u < kTileK * vecs; u += kThreads) {
    const int t = u / vecs, i = (u % vecs) * kVec;
    const int p = t0 + t;
    float kb[kVec], vb[kVec];
    if (p < tile_end) {
      int blk = table_row[p / bs];
      blk = blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
      const size_t off =
          ((size_t)(blk * bs + p % bs) * n_kv + kv) * d + i;
      load_vec(kpool + off, kb);
      load_vec(vpool + off, vb);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) kb[j] = vb[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s.ks[t * s.ldk + i + j] = kb[j];
      s.vs[t * d + i + j] = vb[j];
    }
  }
  __syncthreads();
  // 2. Scores: thread (warp w, lane t) takes key t against rows w, w + 4,
  //    ...: one K read per column feeds up to four rows, and the q reads
  //    of a warp are one broadcast.
  {
    float part[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) part[j] = 0.f;
    if (warp < rows) {
      const float* kr = s.ks + lane * s.ldk;
      for (int i = 0; i < d; ++i) {
        const float kv_i = kr[i];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = warp + j * kWarps;
          if (r < rows) part[j] = fmaf(s.qs[r * d + i], kv_i, part[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = warp + j * kWarps;
      if (r < rows)
        s.sc[r * kTileK + lane] = (t0 + lane < s.lim[r]) ? part[j] : kNegInf;
    }
  }
  __syncthreads();
  // 3. Online softmax: one warp per row, one key per lane.
  for (int r = warp; r < rows; r += kWarps) {
    const float sc = s.sc[r * kTileK + lane];
    const float mt = warp_max(sc);
    const float mo = s.m[r];
    const float mn = fmaxf(mo, mt);
    // A wholly masked tile contributes p = 0; a row with no visible key
    // yet rescales nothing (the TPU kernel's NEG_INF rules).
    const float p = mt == kNegInf ? 0.f : expf(sc - mn);
    const float psum = warp_sum(p);
    s.sc[r * kTileK + lane] = round_t<T>(p);
    if (lane == 0) {
      const float c = mo == kNegInf ? 0.f : expf(mo - mn);
      s.corr[r] = c;
      s.l[r] = s.l[r] * c + psum;
      s.m[r] = mn;
    }
  }
  __syncthreads();
  // 4. acc = acc * corr + P V, element e = (row, column) of this thread.
#pragma unroll
  for (int j = 0; j < kMaxElems; ++j) {
    const int e = tid + j * kThreads;
    if (e < rows * d) {
      const int r = e / d, i = e % d;
      float a = acc[j] * s.corr[r];
      const float* pr = s.sc + r * kTileK;
#pragma unroll 8
      for (int t = 0; t < kTileK; ++t) a = fmaf(pr[t], s.vs[t * d + i], a);
      acc[j] = a;
    }
  }
  __syncthreads();
}

// Pass 1, for decode (causal = 0) and chunk (causal = 1): grid
// (n_split, ceil(C / qpos), b * n_kv). The CTA holds rows = qpos * g query
// rows: position i = blockIdx.y * qpos + r / g of the chunk (C = 1 for
// decode), head kv * g + r % g, and attends to the keys of its span
// [split * split_keys, (split + 1) * split_keys) that the row sees: below
// the length (decode) or at most offset + i (chunk). Writes (acc[0..d), m,
// l) of each row into part[(row * n_split + split) * (d + 2)], row = the
// query row's index in [b, C, H].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_partial_kernel(const T* q, const T* kpool, const T* vpool,
                         const int* tables, const int* per_seq, float* part,
                         int C, int W, int H, int n_kv, int d, int nb, int bs,
                         int qpos, int split_keys, int causal, float scale) {
  extern __shared__ float4 smem_raw[];
  const int split = blockIdx.x, n_split = gridDim.x;
  const int b = blockIdx.z / n_kv, kv = blockIdx.z % n_kv;
  const int g = H / n_kv, rows = qpos * g;
  const int i0 = blockIdx.y * qpos;
  const Smem s(reinterpret_cast<float*>(smem_raw), rows, d);
  const int n_keys = W * bs;
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, n_keys);
  const int seq = per_seq[b];  // decode: length; chunk: offset

  // Each thread derives the rows' bounds itself (no shared state needed).
  int max_lim = k_begin;
  for (int r = 0; r < rows; ++r) {
    const int i = i0 + r / g;
    if (i >= C) break;
    int lim = causal ? seq + i + 1 : seq;
    lim = max(k_begin, min(lim, k_end));
    max_lim = max(max_lim, lim);
  }
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, i = i0 + r / g;
    s.qs[e] = i < C ? round_t<T>(to_f(q[(((size_t)b * C + i) * H + kv * g +
                                        r % g) * d + e % d]) * scale)
                    : 0.f;
  }
  if (threadIdx.x < rows) {
    const int r = threadIdx.x, i = i0 + r / g;
    int lim = causal ? seq + i + 1 : seq;
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
    s.lim[r] = i < C ? max(k_begin, min(lim, k_end)) : k_begin;
  }
  float acc[kMaxElems];
#pragma unroll
  for (int j = 0; j < kMaxElems; ++j) acc[j] = 0.f;
  __syncthreads();

  const int* table_row = tables + (size_t)b * W;
  for (int t0 = k_begin; t0 < max_lim; t0 += kTileK)
    attend_tile<T>(kpool, vpool, table_row, nb, bs, n_kv, kv, d, t0,
                   min(t0 + kTileK, max_lim), rows, s, acc);

  const size_t row0 = ((size_t)b * C + i0) * H + kv * g;  // row r = 0
#pragma unroll
  for (int j = 0; j < kMaxElems; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / d;
    if (e < rows * d && i0 + r / g < C)
      part[((row0 + (size_t)(r / g) * H + r % g) * n_split + split) *
               (d + 2) + e % d] = acc[j];
  }
  if (threadIdx.x < rows && i0 + threadIdx.x / g < C) {
    const int r = threadIdx.x;
    float* out =
        part + ((row0 + (size_t)(r / g) * H + r % g) * n_split + split) *
                   (d + 2);
    out[d] = s.m[r];
    out[d + 1] = s.l[r];
  }
}

// Pass 2: grid (rows); merges the n_split partials of one query row in
// split order and writes out[row, :] (the [b, C, H, d] output).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* part, T* out, int d, int n_split) {
  const size_t row = blockIdx.x;
  const float* base = part + row * n_split * (d + 2);
  float M = kNegInf;
  for (int sp = 0; sp < n_split; ++sp)
    M = fmaxf(M, base[sp * (d + 2) + d]);
  float L = 0.f;
  for (int sp = 0; sp < n_split; ++sp)
    L += base[sp * (d + 2) + d + 1] * expf(base[sp * (d + 2) + d] - M);
  const float den = fmaxf(L, 1e-30f);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float o = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      o += base[sp * (d + 2) + i] * expf(base[sp * (d + 2) + d] - M);
    out[row * d + i] = from_f<T>(o / den);
  }
}

bool bad_geometry(int H, int n_kv, int d, int W, int nb, int bs) {
  return d <= 0 || d > kMaxD || d % 8 != 0 || n_kv <= 0 || H % n_kv != 0 ||
         H / n_kv > kMaxRows || W <= 0 || nb <= 0 || bs <= 0;
}

// Both passes over [b, C, H, d] queries: split-K partials, then the
// combine. part holds b * C * H * n_split * (d + 2) floats.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* per_seq, float* part,
                   void* out, int b, int C, int W, int H, int n_kv, int d,
                   int nb, int bs, int split_keys, int causal, float scale,
                   cudaStream_t stream) {
  const int g = H / n_kv;
  const int qpos = C == 1 ? 1 : kMaxRows / g;
  const int n_split = (W * bs + split_keys - 1) / split_keys;
  paged_partial_kernel<T><<<dim3(n_split, (C + qpos - 1) / qpos, b * n_kv),
                            kThreads, smem_bytes(qpos * g, d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, per_seq, part, C, W, H, n_kv, d, nb,
      bs, qpos, split_keys, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<(unsigned)((size_t)b * C * H), kThreads, 0,
                            stream>>>(part, static_cast<T*>(out), d,
                                      n_split);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* per_seq, void* part, void* out, int dtype, int b,
             int C, int W, int H, int n_kv, int d, int nb, int bs,
             int split_keys, int causal, float scale, void* stream) {
  if (bad_geometry(H, n_kv, d, W, nb, bs) || b <= 0 || C <= 0 ||
      split_keys <= 0 || split_keys % kTileK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(per_seq);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, t, ps, p, out, b, C, W, H, n_kv, d,
                              nb, bs, split_keys, causal, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, t, ps, p, out, b, C, W, H,
                                      n_kv, d, nb, bs, split_keys, causal,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Decode attention through the block tables. q, out: [B, 1, H, d]; k, v:
// one layer's pool [nb, bs, n_kv, d]; tables [B, W] int32; lengths [B]
// int32 (counting the new token); part: f32 scratch of
// B * H * ceil(W * bs / split_keys) * (d + 2) elements. All contiguous.
// dtype 0 = f32, 1 = bf16.
extern "C" int grove_paged_decode(const void* q, const void* k, const void* v,
                                  const void* tables, const void* lengths,
                                  void* part, void* out, int dtype, int B,
                                  int W, int H, int n_kv, int d, int nb,
                                  int bs, int split_keys, float scale,
                                  void* stream) {
  return dispatch(q, k, v, tables, lengths, part, out, dtype, B, 1, W, H,
                  n_kv, d, nb, bs, split_keys, 0, scale, stream);
}

// Chunked-prefill attention through the block tables. q, out:
// [b, C, H, d]; k, v: one layer's pool [nb, bs, n_kv, d]; tables [b, W]
// int32; offsets [b] int32 (absolute position of each sequence's row 0);
// part: f32 scratch of b * C * H * ceil(W * bs / split_keys) * (d + 2)
// elements. All contiguous. dtype 0 = f32, 1 = bf16.
extern "C" int grove_paged_chunk(const void* q, const void* k, const void* v,
                                 const void* tables, const void* offsets,
                                 void* part, void* out, int dtype, int b,
                                 int C, int W, int H, int n_kv, int d, int nb,
                                 int bs, int split_keys, float scale,
                                 void* stream) {
  return dispatch(q, k, v, tables, offsets, part, out, dtype, b, C, W, H,
                  n_kv, d, nb, bs, split_keys, 1, scale, stream);
}

// Per-thread registers and local (spill) bytes of the partial (which = 0)
// or combine (which = 1) kernel for dtype, into out[2].
extern "C" int grove_paged_info(int which, int dtype, int* out) {
  const void* fn = nullptr;
  if (which == 0)
    fn = dtype == 0
             ? reinterpret_cast<const void*>(paged_partial_kernel<float>)
             : reinterpret_cast<const void*>(
                   paged_partial_kernel<__nv_bfloat16>);
  else
    fn = dtype == 0
             ? reinterpret_cast<const void*>(paged_combine_kernel<float>)
             : reinterpret_cast<const void*>(
                   paged_combine_kernel<__nv_bfloat16>);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* grove_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
