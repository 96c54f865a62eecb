// The routed expert layer of a Mixtral-shaped model on Hopper (sm_90a):
// routing with the permutation of the rows, the grouped expert GEMM, and
// the weighted combine.
//
// Replaces the JAX package's MoE block (grove_tpu/models/moe.py:97,
// _moe_block), which evaluates every expert for every token and masks the
// result by the router's weights. That is the TPU's way to keep shapes
// static; on this card it would read and multiply 4x the expert weights a
// top-2-of-8 token needs. Here each token reaches only its k experts, with
// no host read of the routing, so the layer runs inside the engine's CUDA
// graphs: every grid is fixed by the launch's rows, never by the routing.
//
// moe_route_kernel: from the router's f32 logits [M, E] (the dense GEMM's
// f32 output), each token's k largest in descending order (ties to the lower
// expert) and a softmax over those k; a counting sort of the M k
// assignments by expert (one warp per expert, ballots over the assignments
// in token-major order, so an expert's rows keep the tokens' order); the
// offsets [E + 1] of each expert's rows; each assignment's row (`slot`);
// and the permuted copy of the normed rows, x_perm[slot[t k + j]] = h[t].
// Every CTA computes the whole routing (a few KB of logits) and copies the
// rows of kRouteRows assignments; CTA 0 alone writes the offsets, slots,
// weights and the counters: per-expert assignments, the experts that got
// any, and the layer's dispatches, added to an int64 buffer on the device
// that the engine reads only after its own fetches.
//
// moe_expert_kernel: x_perm [A, K] times each expert's own weights, the
// experts stacked as [E K, N] (the stored [E, K, N] seen as 2-D), for up to
// two weights sharing x (the gate and up projections, in one launch). The
// dense build's design (csrc/w8a16_gemm.cu, w8a16_dense_kernel) with the
// expert as a grid axis: swapped wgmma with the weight tile [64 k][64
// columns] as A (MN-major, read as stored) and the expert's rows as n, in
// kT token tiles of 64 (n = 64 kT); two consumer warpgroups of 64 columns;
// one producer warp keeping a TMA ring of ~192 KB in flight; one CTA per SM.
// Grid: (column tiles of 128 over the weights, E). A CTA reads its expert's
// row range from the device offsets, exits at once where the expert got no
// row (no weight byte read), else loops over the range in passes of 64 kT
// rows, streaming its weight tile again per pass (one pass up to 64 kT rows:
// decode's 16 a expert at 64 rows take kT = 1, a 256-row chunk's ~64 take
// kT = 2). Rows of the boxes past the range are other experts' (or past x:
// TMA's zero fill) and are never stored. No split of K: the expert launches
// have tens of column tiles per expert already (gate/up 224 x 8 CTAs at
// Mixtral's widths, down 32 x 8), and an element's sum is over the k-steps
// in increasing k, 16 deep per wgmma: an output row's bits depend on its
// own input row and the expert alone, never on M, the passes or the other
// rows (n does not enter an element's sum; chip_smoke.py phase 3 holds rows
// bitwise across M). The accumulators go straight to the bf16 output from
// registers (no split to reduce), so the ring keeps streaming across passes.
// Bound by the weight bytes of the experts reached (3.35 TB/s): up to ~128
// rows a pass the operations stay below the card's ridge.
//
// moe_combine_kernel: out[t] = bf16(sum_j w[t, j] y[slot[t k + j]]), each
// product and the sum rounded to f32 on its own (__fmul_rn, __fadd_rn, in
// j order), so the plain version's f32 ops give the same bits.
//
// The C entry points launch on the given stream, never synchronize, and
// return cudaGetLastError() after a launch (or the error that kept it from
// launching).

#define GROVE_GEMM_DEVICE_ONLY
#include "w8a16_gemm.cu"

namespace {

constexpr int kMoeMaxExperts = 64;
constexpr int kMoeMaxK = 4;
constexpr int kMaxAssign = 8192;    // M k, in the route kernel's shared memory
constexpr int kRouteThreads = 256;
constexpr int kRouteRows = 4;       // assignments whose rows a CTA copies
constexpr int kCombineThreads = 256;
constexpr int kExpertWeights = 2;   // weights sharing x in one launch

__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const float* __restrict__ logits,
                     const __nv_bfloat16* __restrict__ h,
                     __nv_bfloat16* __restrict__ x_perm,
                     int* __restrict__ offsets, int* __restrict__ slot,
                     float* __restrict__ weights,
                     long long* __restrict__ stats, int M, int E, int k,
                     int d) {
  extern __shared__ int route_smem[];
  __shared__ int count[kMoeMaxExperts], off[kMoeMaxExperts + 1];
  const int A = M * k;
  int* const sel = route_smem;  // [A] each assignment's expert
  int* const rank = sel + A;    // [A] its place among its expert's rows
  for (int t = threadIdx.x; t < M; t += blockDim.x) {
    const float* row = logits + (size_t)t * E;
    int idx[kMoeMaxK];
    float val[kMoeMaxK];
#pragma unroll
    for (int j = 0; j < kMoeMaxK; ++j) {
      if (j >= k) break;
      int best = -1;
      float bv = 0.f;
      for (int e = 0; e < E; ++e) {
        bool taken = false;
        for (int i = 0; i < j; ++i) taken |= idx[i] == e;
        const float v = row[e];
        if (!taken && (best < 0 || v > bv)) best = e, bv = v;
      }
      idx[j] = best, val[j] = bv;
      sel[t * k + j] = best;
    }
    if (blockIdx.x == 0) {  // softmax over the k values: exp(v - max) / sum
      float ex[kMoeMaxK], sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMoeMaxK; ++j)
        if (j < k) {
          ex[j] = expf(__fsub_rn(val[j], val[0]));
          sum = __fadd_rn(sum, ex[j]);
        }
#pragma unroll
      for (int j = 0; j < kMoeMaxK; ++j)
        if (j < k) weights[t * k + j] = __fdiv_rn(ex[j], sum);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = warp; e < E; e += blockDim.x >> 5) {
    int base = 0;
    for (int a0 = 0; a0 < A; a0 += 32) {
      const int a = a0 + lane;
      const bool mine = a < A && sel[a] == e;
      const unsigned mask = __ballot_sync(0xffffffffu, mine);
      if (mine) rank[a] = base + __popc(mask & ((1u << lane) - 1u));
      base += __popc(mask);
    }
    if (lane == 0) count[e] = base;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int e = 0; e < E; ++e) off[e] = s, s += count[e];
    off[E] = s;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int a = threadIdx.x; a < A; a += blockDim.x)
      slot[a] = off[sel[a]] + rank[a];
    for (int e = threadIdx.x; e <= E; e += blockDim.x) offsets[e] = off[e];
    if (stats != nullptr && threadIdx.x == 0) {
      int touched = 0;
      for (int e = 0; e < E; ++e) {
        stats[e] += count[e];
        touched += count[e] > 0;
      }
      stats[E] += touched;
      stats[E + 1] += 1;
    }
  }
  const int vec = d / 8;  // 16-byte vectors a row
  const int a0 = (int)blockIdx.x * kRouteRows, a1 = min(A, a0 + kRouteRows);
  for (int a = a0; a < a1; ++a) {
    const uint4* src = reinterpret_cast<const uint4*>(h + (size_t)(a / k) * d);
    uint4* dst = reinterpret_cast<uint4*>(
        x_perm + (size_t)(off[sel[a]] + rank[a]) * d);
    for (int v = threadIdx.x; v < vec; v += blockDim.x) dst[v] = src[v];
  }
}

// The outputs of one expert launch: weight j's [A, n[j]] bf16 output and
// its first column tile (tile0[count] is the total).
struct ExpertOuts {
  __nv_bfloat16* out[kExpertWeights];
  int n[kExpertWeights];
  int tile0[kExpertWeights + 1];
  int count;
};

// Grid (column tiles of 128 over the weights, E); see the header. The ring,
// its stages and the element map of acc are the dense build's (DenseGeom,
// w8a16_dense_kernel): element 4 jj + 2 i + c is weight column 64 wg +
// 16 (warp % 4) + gid + 8 i of the tile, row 8 jj + 2 tig + c of the pass.
template <int kT>
__global__ void __launch_bounds__(kDenseThreads, 1)
    moe_expert_kernel(__grid_constant__ const CUtensorMap x_map,
                      __grid_constant__ const CUtensorMap w_map0,
                      __grid_constant__ const CUtensorMap w_map1,
                      const ExpertOuts outs, const int* __restrict__ offsets,
                      int K) {
  using G = DenseGeom<kT>;
  constexpr int kPassRows = kDenseN * kT;
  const int e = blockIdx.y;
  const int r0 = offsets[e], rows = offsets[e + 1] - r0;
  if (rows <= 0) return;  // every thread alike: no barrier is initialized
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + G::kRingBytes;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (G::kStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Weight j's tile (selects, not an index into the parameter: no stack).
  const bool j = outs.count > 1 && (int)blockIdx.x >= outs.tile0[1];
  const int n0 = ((int)blockIdx.x - (j ? outs.tile0[1] : 0)) * kBN;
  const int N = j ? outs.n[1] : outs.n[0];
  const int k_steps = K / kBK, passes = (rows + kPassRows - 1) / kPassRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDenseConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kDenseConsumers / 32) {
    // Producer: lane 0 keeps the ring filled, pass after pass; a pass loads
    // only the token tiles its rows reach.
    if (lane == 0) {
      const CUtensorMap* wm = j ? &w_map1 : &w_map0;
      prefetch_map(wm);
      prefetch_map(&x_map);
      int it = 0;
      for (int p = 0; p < passes; ++p) {
        const int pr0 = r0 + p * kPassRows;
        const int prows = min(kPassRows, rows - p * kPassRows);
        const int tiles = (prows + kDenseN - 1) / kDenseN;
        for (int i = 0; i < k_steps; ++i, ++it) {
          const int s = it % G::kStages, use = it / G::kStages;
          if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
          const uint32_t st = base + s * G::kStageBytes;
          const int k = i * kBK;
          mbar_expect_tx(full(s), 2 * kWBoxBytes + tiles * kXBoxBytes);
          tma_load_2d(st, wm, full(s), n0, e * K + k);
          tma_load_2d(st + kWBoxBytes, wm, full(s), n0 + 64, e * K + k);
          for (int t = 0; t < tiles; ++t)
            tma_load_2d(st + 2 * kWBoxBytes + t * kXBoxBytes, &x_map,
                        full(s), k, pr0 + kDenseN * t);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int lc0 = 64 * wg + 16 * (warp & 3) + gid;  // + 8 i
  __nv_bfloat16* const out = j ? outs.out[1] : outs.out[0];
  float acc[kT * 32];
  int it = 0;
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int q = 0; q < kT * 32; ++q) acc[q] = 0.f;
    fence_regs(acc);
    for (int i = 0; i < k_steps; ++i, ++it) {
      const int s = it % G::kStages;
      mbar_wait(full(s), (it / G::kStages) & 1);
      const uint32_t st = base + s * G::kStageBytes;
      const uint32_t wbox = st + wg * kWBoxBytes, xs = st + 2 * kWBoxBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_ta<kDenseN * kT>(
            acc, sw128_desc(wbox + kk * 16 * 128, kWBoxBytes, 1024),
            sw128_desc(xs + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // step i - 1's products are done: release its stage
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((it - 1) % G::kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty((it - 1) % G::kStages));
    const int pr0 = r0 + p * kPassRows;
    const int prows = min(kPassRows, rows - p * kPassRows);
#pragma unroll
    for (int jj = 0; jj < 8 * kT; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * jj + 2 * tig + c;
        if (r >= prows) continue;
        __nv_bfloat16* const orow = out + (size_t)(pr0 + r) * N;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n0 + lc0 + 8 * i;
          if (n < N) orow[n] = __float2bfloat16_rn(acc[4 * jj + 2 * i + c]);
        }
      }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const __nv_bfloat16* __restrict__ y,
                       const int* __restrict__ slot,
                       const float* __restrict__ weights,
                       __nv_bfloat16* __restrict__ out, int k, int d) {
  const int t = blockIdx.x;
  int rows[kMoeMaxK];
  float w[kMoeMaxK];
#pragma unroll
  for (int j = 0; j < kMoeMaxK; ++j)
    if (j < k) rows[j] = slot[t * k + j], w[j] = weights[t * k + j];
  for (int c = 2 * threadIdx.x; c < d; c += 2 * blockDim.x) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMoeMaxK; ++j) {
      if (j >= k) break;
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          y + (size_t)rows[j] * d + c);
      const float p0 = __fmul_rn(w[j], __low2float(v));
      const float p1 = __fmul_rn(w[j], __high2float(v));
      s0 = j == 0 ? p0 : __fadd_rn(s0, p0);
      s1 = j == 0 ? p1 : __fadd_rn(s1, p1);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)t * d + c) =
        __floats2bfloat162_rn(s0, s1);
  }
}

template <class Kernel>
cudaError_t smem_limit(Kernel kernel, int bytes, bool* ready) {
  if (*ready) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *ready = true;
  return err;
}

struct alignas(64) ExpertPlan {
  CUtensorMap w_map[kExpertWeights];
  int n[kExpertWeights];
  int count, E, K;
};

template <int kT>
cudaError_t launch_expert(const CUtensorMap& x_map, const ExpertPlan& p,
                          ExpertOuts& o, const int* offsets,
                          cudaStream_t st) {
  auto kernel = moe_expert_kernel<kT>;
  static bool ready = false;
  cudaError_t err = smem_limit(kernel, DenseGeom<kT>::kSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(o.tile0[o.count], p.E);
  kernel<<<grid, kDenseThreads, DenseGeom<kT>::kSmem, st>>>(
      x_map, p.w_map[0], p.w_map[p.count - 1], o, offsets, p.K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int grove_moe_plan_bytes() { return (int)sizeof(ExpertPlan); }

// Plan the expert launches over `count` (1 or 2) stacked expert weights
// w_i [E, K, n_i] bf16 (contiguous, 16-byte aligned) that share x: K % 64 ==
// 0, n_i % 8 == 0, 1 <= E <= 64. Writes grove_moe_plan_bytes() bytes.
extern "C" int grove_moe_plan(const void* const* w, const int* n, int count,
                              int E, int K, void* plan) {
  if (count < 1 || count > kExpertWeights || E < 1 || E > kMoeMaxExperts ||
      K <= 0 || K % kBK != 0)
    return (int)cudaErrorInvalidValue;
  ExpertPlan p;
  memset(&p, 0, sizeof(p));
  p.count = count, p.E = E, p.K = K;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0 || n[i] % 8 != 0 || w[i] == nullptr)
      return (int)cudaErrorInvalidValue;
    p.n[i] = n[i];
    const cudaError_t err =
        make_map(&p.w_map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w[i], n[i],
                 (long long)E * K, 64, kBK);
    if (err != cudaSuccess) return (int)err;
  }
  memcpy(plan, &p, sizeof(p));
  return 0;
}

// x [A, K] bf16 (the permuted rows, contiguous, 16-byte aligned) times each
// planned weight, expert e over rows [offsets[e], offsets[e + 1]) (device
// memory, written by the route kernel); out holds the outputs one after
// another, [A, n_i] bf16 each. kT (1 or 2) token tiles a pass.
extern "C" int grove_moe_expert_run(const void* plan, const void* x,
                                    void* out, const int* offsets, int A,
                                    int kT, void* stream) {
  ExpertPlan p;
  memcpy(&p, plan, sizeof(p));
  if (A <= 0 || (kT != 1 && kT != 2)) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map;
  cudaError_t err = make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                             p.K, A, kBK, kDenseN);
  if (err != cudaSuccess) return (int)err;
  ExpertOuts o;
  memset(&o, 0, sizeof(o));
  o.count = p.count;
  size_t at = 0;
  for (int i = 0; i < p.count; ++i) {
    o.out[i] = static_cast<__nv_bfloat16*>(out) + at;
    o.n[i] = p.n[i];
    o.tile0[i + 1] = o.tile0[i] + (p.n[i] + kBN - 1) / kBN;
    at += (size_t)A * p.n[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = kT == 1 ? launch_expert<1>(x_map, p, o, offsets, st)
                : launch_expert<2>(x_map, p, o, offsets, st);
  return (int)err;
}

// Routing of M tokens over E experts, k each (see the header): logits [M, E]
// f32, h [M, d] bf16 (d % 8 == 0, 16-byte aligned); out: x_perm [M k, d]
// bf16, offsets [E + 1] and slot [M k] int32, weights [M k] f32; stats
// [E + 2] int64 accumulated in place, or null.
extern "C" int grove_moe_route(const float* logits, const void* h,
                               void* x_perm, int* offsets, int* slot,
                               float* weights, long long* stats, int M,
                               int E, int k, int d, void* stream) {
  if (M <= 0 || E < 1 || E > kMoeMaxExperts || k < 1 || k > kMoeMaxK ||
      k > E || M * k > kMaxAssign || d <= 0 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * M * k * (int)sizeof(int);
  static bool ready = false;
  cudaError_t err = smem_limit(moe_route_kernel, 2 * kMaxAssign * 4, &ready);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M * k + kRouteRows - 1) / kRouteRows;
  moe_route_kernel<<<grid, kRouteThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      logits, static_cast<const __nv_bfloat16*>(h),
      static_cast<__nv_bfloat16*>(x_perm), offsets, slot, weights, stats, M,
      E, k, d);
  return (int)cudaGetLastError();
}

// out [M, d] bf16 = the weighted sum of each token's k rows of y [M k, d].
extern "C" int grove_moe_combine(const void* y, const int* slot,
                                 const float* weights, void* out, int M,
                                 int k, int d, void* stream) {
  if (M <= 0 || k < 1 || k > kMoeMaxK || d <= 0 || d % 2 != 0)
    return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<M, kCombineThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), slot, weights,
      static_cast<__nv_bfloat16*>(out), k, d);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, dynamic shared memory, CTAs per SM and
// ring stages into out[5]: which = 0 the route kernel (its most shared
// memory), 1 and 2 the expert kernel at 1 and 2 token tiles, 3 the combine.
extern "C" int grove_moe_info(int which, int* out) {
  const void* fn = nullptr;
  int smem = 0, threads = 0, stages = 0;
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    static bool ready = false;
    fn = reinterpret_cast<const void*>(moe_route_kernel);
    smem = 2 * kMaxAssign * 4, threads = kRouteThreads;
    err = smem_limit(moe_route_kernel, smem, &ready);
  } else if (which == 1) {
    static bool ready = false;
    fn = reinterpret_cast<const void*>(moe_expert_kernel<1>);
    smem = DenseGeom<1>::kSmem, threads = kDenseThreads;
    stages = DenseGeom<1>::kStages;
    err = smem_limit(moe_expert_kernel<1>, smem, &ready);
  } else if (which == 2) {
    static bool ready = false;
    fn = reinterpret_cast<const void*>(moe_expert_kernel<2>);
    smem = DenseGeom<2>::kSmem, threads = kDenseThreads;
    stages = DenseGeom<2>::kStages;
    err = smem_limit(moe_expert_kernel<2>, smem, &ready);
  } else if (which == 3) {
    fn = reinterpret_cast<const void*>(moe_combine_kernel);
    threads = kCombineThreads;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = per_sm;
  out[4] = stages;
  return 0;
}

extern "C" const char* grove_moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
