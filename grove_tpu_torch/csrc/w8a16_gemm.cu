// W8A16 GEMM: activations [M, K] times int8 weights [K, N] with one bf16
// scale per output column, on Hopper (sm_90a).
//
// Replaces the JAX package's int8-weight projections: QTensor.materialize
// (grove_tpu/serving/quant.py:42) read through _w (grove_tpu/models/
// llama.py:157) by every einsum of _qkv, _attn_out, _mlp_block and the LM
// head. XLA fuses the int8 -> bf16 upcast and the scale into the matmul's
// operand read, so the weight crosses device memory as int8; so does it
// here. For each output element
//
//   out[m, n] = sum_k x[m, k] * w[k, n],  w[k, n] = bf16(f32(q[k, n]) *
//                                                       f32(scale[n]))
//
// with f32 accumulation, rounded once to the output type (bf16 for the layer
// projections, f32 for the LM head). w is the plain version's dequantized
// weight bit for bit: one f32 product (exact: 8 by 8 significant bits), one
// round to nearest even. It lives only in shared memory.
//
// What bounds it on an H100: at M <= 32 (decode, the prefill chunk) the
// weight read, K * N bytes at 3.35 TB/s; at M = 4,096 (the lanes prefill)
// the tensor cores. The design:
//   - bf16 activations: each CTA owns a BM x BN output tile and a slice of
//     K. A ring of cp.async stages brings the int8 weight rows [64, BN] and
//     the activation rows [BM, 64] of each 64-deep k-step; each thread
//     dequantizes the int8 chunks it copied into one of two bf16 tiles in
//     shared memory while the warps run mma.sync m16n8k16 (bf16 operands,
//     f32 accumulators) on the other, A by ldmatrix, B by ldmatrix.trans
//     from the [k][n] tile: one barrier per k-step.
//     Two tile shapes: 32 x 64 (4 warps) for M <= 256, 128 x 128 (8 warps)
//     above, where the weight tile is reused by more rows.
//   - f32 activations (an f32 model over int8 weights): a CUDA-core FMA
//     kernel over the same tiles and the same split of K.
//   - One launch may cover up to three weights that share x (wq, wk, wv;
//     w_gate, w_up): each keeps its own codes, scales, N and output, read
//     and written as stored, and the grid's column tiles run over them in
//     order. No concatenated copy is made.
//   - Split-K fills the card when N gives few column tiles (N = 1,024 gives
//     16 tiles of 64 for 132 SMs). Each split writes its f32 partial tile;
//     the last CTA of a tile to arrive (a per-tile arrival counter, reset by
//     that CTA) sums the partials in split order 0, 1, ..., never by
//     atomics on the values, and writes the output.
//
// Row invariance: the split count and k-step depth come from K and the
// launch's weights alone (the caller picks them; ops/w8a16.py), each
// accumulator takes its k-steps
// and its 16-deep mma steps in increasing order, and the split sum runs in
// split order. So an output row's bits depend only on its own input row,
// for every M that takes the same split (every M <= 256).
//
// The C entry point returns cudaGetLastError() after its launch (or the
// error that kept it from launching); it launches on the given stream and
// never synchronizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // k-step depth
constexpr int kMaxWeights = 3;

// The weights of one launch, in column-tile order: they share x and K; each
// has its own int8 codes [K, n], bf16 scales [n], output [M, n] and first
// column tile (tile0[count] is the total).
struct Weights {
  const int8_t* q[kMaxWeights];
  const __nv_bfloat16* scale[kMaxWeights];
  void* out[kMaxWeights];
  int n[kMaxWeights];
  int tile0[kMaxWeights + 1];
  int count;
};

// The weight that column tile `tile` of a launch falls in, and the tile's
// first column within it.
struct Target {
  const int8_t* q;
  const __nv_bfloat16* scale;
  void* out;
  int N, n0;
};

__device__ __forceinline__ Target target_of(const Weights& w, int tile,
                                            int bn) {
  Target t{w.q[0], w.scale[0], w.out[0], w.n[0], tile * bn};
#pragma unroll
  for (int j = 1; j < kMaxWeights; ++j)
    if (j < w.count && tile >= w.tile0[j])
      t = Target{w.q[j], w.scale[j], w.out[j], w.n[j],
                 (tile - w.tile0[j]) * bn};
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a chunk past the matrix's edge (valid false)
// is zero-filled and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += A[16 x 16] B[16 x 8]: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Code i (0..3) of the four int8 codes in w, as an exact f32: the byte
// permute builds the f32 2^23 + (x + 128), less 2^23 + 128 (no conversion
// unit, which runs at a quarter of the FMA rate).
__device__ __forceinline__ float code_f32(uint32_t w, int i) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 in each byte
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
         8388736.0f;
}

// The four codes of w, each times its column's scale in f32 and rounded once
// to bf16 (the plain version's weight), as two bf16 pairs.
__device__ __forceinline__ uint2 dequant4(uint32_t w, const float* s) {
  return make_uint2(pack_bf16(code_f32(w, 0) * s[0], code_f32(w, 1) * s[1]),
                    pack_bf16(code_f32(w, 2) * s[2], code_f32(w, 3) * s[3]));
}

// The 16 scales of columns n .. n + 15 as f32 (zeros past N; N % 16 == 0,
// so a chunk is wholly inside or outside), by two 16-byte loads.
__device__ __forceinline__ void load_scales(const __nv_bfloat16* scale, int n,
                                            int N, float* sc) {
  uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (n < N) {
    v[0] = *reinterpret_cast<const uint4*>(scale + n);
    v[1] = *reinterpret_cast<const uint4*>(scale + n + 8);
  }
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(v);
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void store_pair(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

// Called by every thread of a CTA after it wrote its partial tile: true in
// the CTA that arrives last at its tile's counter (which it resets for the
// next launch). That CTA then reads every split's partial.
__device__ __forceinline__ bool last_to_arrive(int* counter, int split) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == split - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The k-steps [k0, k1) of split s of k_steps steps in `split` parts.
__device__ __forceinline__ void split_range(int k_steps, int split, int s,
                                            int* k0, int* k1) {
  *k0 = (int)((long long)s * k_steps / split);
  *k1 = (int)((long long)(s + 1) * k_steps / split);
}

// ---- bf16 activations: tensor cores ----

// WM x WN warps, each MT 16-row by NT 8-column mma tiles: BM = 16 WM MT rows
// and BN = 8 WN NT columns per CTA.
// The last CTA of a tile: out[m0.., n0..] = the sum of the split partial
// tiles [split][BM][BN] at tp, taken in split order 0, 1, ..., four
// columns per item, the loads of several splits in flight at once.
template <int BM, int BN, int kThreads, typename OutT>
__device__ __forceinline__ void sum_partials(const float* tp, int split,
                                             OutT* out, int m0, int n0,
                                             int M, int N) {
  constexpr int kVec = BM * BN / 4, kPer = kVec / kThreads;
  static_assert(kVec % kThreads == 0, "whole float4 items per thread");
  const float4* p4 = reinterpret_cast<const float4*>(tp) + threadIdx.x;
  float4 sum[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) sum[j] = __ldcg(p4 + j * kThreads);
#pragma unroll 4
  for (int s = 1; s < split; ++s) {
    float4 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = __ldcg(p4 + (size_t)s * kVec + j * kThreads);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      sum[j].x += v[j].x;
      sum[j].y += v[j].y;
      sum[j].z += v[j].z;
      sum[j].w += v[j].w;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int m = m0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
    if (m < M && n < N) {
      store_pair(out + (size_t)m * N + n, sum[j].x, sum[j].y);
      store_pair(out + (size_t)m * N + n + 2, sum[j].z, sum[j].w);
    }
  }
}

// ---- bf16 activations: tensor cores ----

// WM x WN warps, each MT 16-row by NT 8-column mma tiles: BM = 16 WM MT rows
// and BN = 8 WN NT columns per CTA; kSplit: whether K may be split.
template <int WM, int WN, int MT, int NT, int kStages, bool kSplit_>
struct Mma {
  static constexpr int WN_ = WN, MT_ = MT, NT_ = NT, STAGES = kStages;
  static constexpr bool kSplit = kSplit_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * WM * MT;
  static constexpr int BN = 8 * WN * NT;
  static constexpr int XS = kBK + 8;  // x tile row stride, bf16
  static constexpr int WS = BN + 8;   // weight tile row stride, bf16
  static constexpr int kXBytes = BM * XS * 2;
  static constexpr int kQBytes = kBK * BN;  // int8 rows, BN bytes each
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kWBytes = kBK * WS * 2;
  static constexpr int kSmem = STAGES * kStageBytes + 2 * kWBytes;
  static constexpr int kChunkCols = BN / 16;  // 16-byte int8 chunks per row
  static_assert(kThreads % kChunkCols == 0, "a thread keeps its columns");
  static_assert(NT % 2 == 0, "B fragments load in pairs of 8 columns");
  static_assert(STAGES >= 2, "a stage ahead of the one in use");
};

using Small = Mma<1, 4, 2, 2, 4, true>;   // 32 x 64, 128 threads
using Wide = Mma<2, 4, 4, 4, 3, false>;   // 128 x 128, 256 threads

// Grid: (column tiles of every weight, split, M tiles). x [M, K] bf16; each
// weight q [K, N] int8, scale [N] bf16, out [M, N]; part: split partial
// tiles [M tiles, column tiles, split, BM, BN] f32 and counters [M tiles,
// column tiles] (zero) when split > 1.
//
// The pipeline: a ring of STAGES cp.async stages (x rows and int8 rows of a
// k-step) and two bf16 weight tiles. Each thread dequantizes exactly the
// int8 chunks it copied, so it needs only its own copies' completion before
// it dequantizes. Iteration i issues the copies of step i + STAGES - 1,
// dequantizes step i + 1 into the other weight tile, runs the products of
// step i, then meets the others at the one barrier of the step: warps
// overlap one step's dequantize with another's products.
template <class G, typename OutT>
__global__ void __launch_bounds__(G::kThreads)
    w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const Weights ws,
                     float* __restrict__ part, int* __restrict__ counters,
                     int M, int K, int split) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int BM = G::BM, BN = G::BN, XS = G::XS, WS = G::WS;
  constexpr int S = G::STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Target tg = target_of(ws, blockIdx.x, BN);
  const int8_t* const q = tg.q;
  OutT* const out = static_cast<OutT*>(tg.out);
  const int N = tg.N, n0 = tg.n0, m0 = blockIdx.z * BM;
  int k0, k1;
  split_range(K / kBK, split, blockIdx.y, &k0, &k1);
  const int n_k = k1 - k0;
  uint8_t* const wtiles = smem + S * G::kStageBytes;

  // This thread's int8 chunks: the same 16 columns of every row it copies
  // and dequantizes, and their scales (two 16-byte loads).
  const int ccol = (tid % G::kChunkCols) * 16;
  float sc[16];
  load_scales(tg.scale, n0 + ccol, N, sc);

  auto load = [&](int kk, int st) {
    uint8_t* const xs = smem + st * G::kStageBytes;
    uint8_t* const qs = xs + G::kXBytes;
    for (int c = tid; c < BM * (kBK / 8); c += G::kThreads) {
      const int r = c >> 3, cc = c & 7;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src =
          x + (size_t)(ok ? m0 + r : 0) * K + kk * kBK + cc * 8;
      cp_async16(smem_addr(xs + (r * XS + cc * 8) * 2), src, ok);
    }
    for (int c = tid; c < kBK * G::kChunkCols; c += G::kThreads) {
      const int r = c / G::kChunkCols;
      const bool ok = n0 + ccol < N;
      const int8_t* src =
          q + (size_t)(kk * kBK + r) * N + (ok ? n0 + ccol : 0);
      cp_async16(smem_addr(qs + r * BN + ccol), src, ok);
    }
  };
  auto dequant = [&](int st, uint8_t* wt) {
    const uint8_t* const qs = smem + st * G::kStageBytes + G::kXBytes;
    for (int c = tid; c < kBK * G::kChunkCols; c += G::kThreads) {
      const int r = c / G::kChunkCols;
      const uint4 w = *reinterpret_cast<const uint4*>(qs + r * BN + ccol);
      uint8_t* const dst = wt + (r * WS + ccol) * 2;
      const uint2 d0 = dequant4(w.x, sc), d1 = dequant4(w.y, sc + 4);
      const uint2 d2 = dequant4(w.z, sc + 8), d3 = dequant4(w.w, sc + 12);
      *reinterpret_cast<uint4*>(dst) = make_uint4(d0.x, d0.y, d1.x, d1.y);
      *reinterpret_cast<uint4*>(dst + 16) = make_uint4(d2.x, d2.y, d3.x, d3.y);
    }
  };

  const int wm = warp / G::WN_, wn = warp % G::WN_;
  float acc[G::MT_][G::NT_][4];
#pragma unroll
  for (int a = 0; a < G::MT_; ++a)
#pragma unroll
    for (int b = 0; b < G::NT_; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  // ldmatrix: lane supplies row lane % 8 of matrix lane / 8. A: rows
  // lane % 16, columns 8 (lane / 16) of the 16-deep step; B (transposed
  // from the [k][n] tile): k rows 8 (mi & 1) + 0..7, columns 8 (mi >> 1) +
  // 0..7 of a 16-column pair of mma tiles.
  const int mi = lane >> 3, mr = lane & 7;
  const int a_row = wm * G::MT_ * 16 + (lane & 15), a_col = 8 * (lane >> 4);
  const int b_row = 8 * (mi & 1) + mr,
            b_col = wn * G::NT_ * 8 + 8 * (mi >> 1);
  auto products = [&](int st, const uint8_t* wt) {
    const uint32_t x_base = smem_addr(smem + st * G::kStageBytes);
    const uint32_t w_base = smem_addr(wt);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[G::MT_][4];
#pragma unroll
      for (int t = 0; t < G::MT_; ++t)
        ldmatrix_x4(a[t], x_base + ((a_row + 16 * t) * XS + 16 * ks + a_col) *
                                       2);
#pragma unroll
      for (int np = 0; np < G::NT_ / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_base + ((16 * ks + b_row) * WS + b_col +
                                       16 * np) * 2);
#pragma unroll
        for (int t = 0; t < G::MT_; ++t) {
          mma_bf16(acc[t][2 * np], a[t], b[0], b[1]);
          mma_bf16(acc[t][2 * np + 1], a[t], b[2], b[3]);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_k) load(k0 + i, i);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // this thread's copies of step 0
  dequant(0, wtiles);
  __syncthreads();         // every copy of step 0 and its weight tile
  for (int i = 0; i < n_k; ++i) {
    if (i + S - 1 < n_k) load(k0 + i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 2>();  // this thread's copies of step i + 1
    if (i + 1 < n_k)
      dequant((i + 1) % S, wtiles + ((i + 1) & 1) * G::kWBytes);
    products(i % S, wtiles + (i & 1) * G::kWBytes);
    __syncthreads();
  }
  cp_async_wait<0>();

  // Element e of mma tile (t, u): local row 16 t + gid + 8 (e >> 1) of the
  // warp's rows, local column 8 u + 2 tig + (e & 1) of its columns.
  const int gid = lane >> 2, tig = lane & 3;
  const int r_base = wm * G::MT_ * 16 + gid, c_base = wn * G::NT_ * 8 + 2 * tig;
  if (!G::kSplit || split == 1) {
#pragma unroll
    for (int t = 0; t < G::MT_; ++t)
#pragma unroll
      for (int u = 0; u < G::NT_; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r_base + 16 * t + 8 * h, n = n0 + c_base + 8 * u;
          if (m < M && n < N)
            store_pair(out + (size_t)m * N + n, acc[t][u][2 * h],
                       acc[t][u][2 * h + 1]);
        }
    return;
  }
  if constexpr (G::kSplit) {
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    float* const tp = part + (size_t)tile * split * BM * BN;
#pragma unroll
    for (int t = 0; t < G::MT_; ++t)
#pragma unroll
      for (int u = 0; u < G::NT_; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(tp + ((size_t)blockIdx.y * BM + r_base + 16 * t +
                           8 * h) * BN + c_base + 8 * u,
                     acc[t][u][2 * h], acc[t][u][2 * h + 1]);
    if (last_to_arrive(counters + tile, split))
      sum_partials<BM, BN, G::kThreads>(tp, split, out, m0, n0, M, N);
  }
}

// ---- f32 activations: CUDA cores ----

constexpr int kFmaThreads = 256;
constexpr int kFmaBM = 32, kFmaBN = 64, kFmaRows = kFmaBM * kFmaBN /
                                                   kFmaThreads;

// Grid and partials as the mma kernel's, with BM x BN = 32 x 64: thread
// column tid % 64, rows 8 (tid / 64) + 0..7 of the tile, k in increasing
// order over the split's k-steps.
__global__ void __launch_bounds__(kFmaThreads)
    w8a16_fma_kernel(const float* __restrict__ x, const Weights ws,
                     float* __restrict__ part, int* __restrict__ counters,
                     int M, int K, int split) {
  const Target tg = target_of(ws, blockIdx.x, kFmaBN);
  const int8_t* const q = tg.q;
  float* const out = static_cast<float*>(tg.out);
  const int N = tg.N;
  const int tid = threadIdx.x, col = tid % kFmaBN,
            row0 = (tid / kFmaBN) * kFmaRows;
  const int n = tg.n0 + col, m0 = blockIdx.z * kFmaBM;
  const float s = n < N ? __bfloat162float(tg.scale[n]) : 0.f;
  int k0, k1;
  split_range(K / kBK, split, blockIdx.y, &k0, &k1);
  float acc[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;
  for (int k = k0 * kBK; k < k1 * kBK; ++k) {
    const float w = n < N ? __bfloat162float(__float2bfloat16_rn(
                                (float)q[(size_t)k * N + n] * s))
                          : 0.f;
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const int m = m0 + row0 + r;
      const float xv = m < M ? x[(size_t)m * K + k] : 0.f;
      acc[r] = fmaf(xv, w, acc[r]);
    }
  }
  if (split == 1) {
    for (int r = 0; r < kFmaRows; ++r) {
      const int m = m0 + row0 + r;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[r];
    }
    return;
  }
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  float* const tp = part + (size_t)tile * split * kFmaBM * kFmaBN;
  for (int r = 0; r < kFmaRows; ++r)
    tp[((size_t)blockIdx.y * kFmaBM + row0 + r) * kFmaBN + col] = acc[r];
  if (last_to_arrive(counters + tile, split))
    sum_partials<kFmaBM, kFmaBN, kFmaThreads>(tp, split, out, m0, tg.n0, M,
                                              N);
}

template <class G, typename OutT>
cudaError_t launch_mma(const void* x, const Weights& ws, void* part,
                       void* counters, int M, int K, int split,
                       cudaStream_t st) {
  auto kernel = w8a16_mma_kernel<G, OutT>;
  static bool ready = false;  // one attribute call per instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(ws.tile0[ws.count], split, (M + G::BM - 1) / G::BM);
  kernel<<<grid, G::kThreads, G::kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(x), ws, static_cast<float*>(part),
      static_cast<int*>(counters), M, K, split);
  return cudaGetLastError();
}

}  // namespace

// out_i [M, n_i] = x [M, K] . dequant(q_i [K, n_i] int8, scale_i [n_i] bf16)
// for the `count` (1..3) weights of q, scale, out and n, in one launch; all
// contiguous and 16-byte aligned. x_dtype 0 = f32 (out f32, the FMA
// kernel), 1 = bf16 (out_dtype 0 = f32, 1 = bf16; the tensor-core kernel,
// tile 32 x 64 or, with wide = 1, 128 x 128 and split 1). K % 64 == 0,
// n_i % 16 == 0, 1 <= split <= K / 64. With split > 1, part holds the
// partial tiles ([M tiles, column tiles, split, BM, BN] f32) and counters
// one zero int per (M tile, column tile), which the kernel leaves zero.
extern "C" int grove_w8a16_matmul(const void* x, const void* const* q,
                                  const void* const* scale, void* const* out,
                                  const int* n, int count, void* part,
                                  void* counters, int x_dtype, int out_dtype,
                                  int wide, int M, int K, int split,
                                  void* stream) {
  if (M <= 0 || K <= 0 || K % kBK != 0 || count < 1 ||
      count > kMaxWeights || split < 1 || split > K / kBK ||
      (split > 1 && (!part || !counters)))
    return (int)cudaErrorInvalidValue;
  const int bn = x_dtype == 0 ? kFmaBN : wide ? Wide::BN : Small::BN;
  Weights ws{};
  ws.count = count;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0 || n[i] % 16 != 0) return (int)cudaErrorInvalidValue;
    ws.q[i] = static_cast<const int8_t*>(q[i]);
    ws.scale[i] = static_cast<const __nv_bfloat16*>(scale[i]);
    ws.out[i] = out[i];
    ws.n[i] = n[i];
    ws.tile0[i + 1] = ws.tile0[i] + (n[i] + bn - 1) / bn;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (out_dtype != 0 || wide) return (int)cudaErrorInvalidValue;
    const dim3 grid(ws.tile0[count], split, (M + kFmaBM - 1) / kFmaBM);
    w8a16_fma_kernel<<<grid, kFmaThreads, 0, st>>>(
        static_cast<const float*>(x), ws, static_cast<float*>(part),
        static_cast<int*>(counters), M, K, split);
    return (int)cudaGetLastError();
  }
  if (x_dtype != 1 || (out_dtype != 0 && out_dtype != 1) ||
      (wide && split != 1))
    return (int)cudaErrorInvalidValue;
  if (wide)
    return out_dtype ? (int)launch_mma<Wide, __nv_bfloat16>(
                           x, ws, part, counters, M, K, split, st)
                     : (int)launch_mma<Wide, float>(x, ws, part, counters, M,
                                                    K, split, st);
  return out_dtype ? (int)launch_mma<Small, __nv_bfloat16>(
                         x, ws, part, counters, M, K, split, st)
                   : (int)launch_mma<Small, float>(x, ws, part, counters, M, K,
                                                   split, st);
}

// Tile rows, tile columns, registers, local (spill) bytes and dynamic shared
// memory of a build, into out[5]: which = 0 the 32 x 64 tensor-core kernel,
// 1 the 128 x 128 one (both with bf16 output), 2 the FMA kernel.
extern "C" int grove_w8a16_info(int which, int* out) {
  const void* fn;
  int bm, bn, smem;
  if (which == 0) {
    fn = reinterpret_cast<const void*>(w8a16_mma_kernel<Small, __nv_bfloat16>);
    bm = Small::BM, bn = Small::BN, smem = Small::kSmem;
  } else if (which == 1) {
    fn = reinterpret_cast<const void*>(w8a16_mma_kernel<Wide, __nv_bfloat16>);
    bm = Wide::BM, bn = Wide::BN, smem = Wide::kSmem;
  } else if (which == 2) {
    fn = reinterpret_cast<const void*>(w8a16_fma_kernel);
    bm = kFmaBM, bn = kFmaBN, smem = 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = bm;
  out[1] = bn;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  return 0;
}

extern "C" const char* grove_w8a16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
