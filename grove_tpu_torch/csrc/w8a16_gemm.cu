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
// weight bit for bit: the product of two values of 8 significant bits is
// exact, and one fma.rn.bf16x2 (with a -0 addend) rounds it once to nearest
// even, as the plain version's f32 product rounded to bf16 does.
//
// The weights are read as stored, [K, N] with N contiguous; one launch may
// cover up to three weights that share x (wq, wk, wv; w_gate, w_up), each
// with its own codes, scales, N and output, the grid's column tiles running
// over them in order. Every tile of a weight arrives by TMA as int8: a box
// of 64 k rows by 128 columns is one 128-byte swizzle row per k. The tensor
// maps of the weights are encoded once per launch plan (ops/w8a16.py caches
// the plan by the weights' pointers and shapes); x's map is encoded per call.
//
// Small M (M <= 256: decode, prefill chunks, the lanes decode). Bound by the
// weight bytes, K * N at 3.35 TB/s. w8a16_small_kernel:
//   - Swapped operands: out^T = w^T x^T on mma.sync m16n8k16. The weight's
//     columns are the mma's 16-row side (A) and the tokens its 8-wide side
//     (B), so M = 1..8 costs one n-tile and M = 32 four, with no padding of
//     M to 16-row tiles. A CTA covers 128 columns and 32 tokens.
//   - The int8 weight is dequantized straight into A fragments in registers;
//     no bf16 weight tile is ever written. ldmatrix.trans over the int8 tile
//     seen as b16 column pairs gives lane (gid = lane / 4, tig = lane % 4)
//     the codes of columns 2 gid and 2 gid + 1 at k = 2 tig and 2 tig + 1;
//     byte permutes pair them by column, and fragment row r holds column
//
//        fragment_column(r) = 2 (r mod 8) + r div 8
//
//     of its 16-column tile (ops/w8a16.py: fragment_column, pinned by
//     tests/test_torch_w8a16.py). The epilogue reads the accumulator rows
//     through the same map. Each thread needs two scales per 16 columns.
//   - x, the small operand, rides in the same TMA stage as the weight tile
//     (a 32 x 64 bf16 box, rows past M zero-filled), so each CTA reads x once
//     over its k range. One producer warp keeps a ring of 4 stages (32 KB of
//     weight) in flight behind full/empty mbarriers; four consumer warps
//     own 32 columns each, three CTAs per SM.
//   - Split-K inside a thread-block cluster: the `split` CTAs of one column
//     tile (split in 1, 2, 4, 8: ops/w8a16.py::split_count) are one cluster.
//     Each rank owns 128 / split columns of the tile; every rank pushes its
//     f32 partial of each owner's columns into that owner's shared memory
//     (st.shared::cluster), and after a cluster barrier each owner sums its
//     columns in rank order 0, 1, ... and writes them. No global partials,
//     no counters, no atomics on values. Every remote store precedes the
//     second cluster barrier and the first one guarantees every rank has
//     started, so no rank touches the shared memory of one that exited.
//
// Wide M (M > 256: the lanes prefill, M = 4,096). Bound by operations.
// w8a16_wide_kernel: 128 x 256 output tiles, one producer warp and two
// consumer warpgroups of 64 rows. x is wgmma's A, K-major by TMA (64 x 128
// box, 128-byte swizzle); the int8 weight tile arrives by TMA beside it and
// the consumers dequantize it, bit-exact as above, into a 128-byte-swizzled
// bf16 tile [64 k][256 n] that wgmma reads as an MN-major B (the transpose
// bit), while the previous k-step's wgmma runs. No split.
//
// f32 activations (an f32 model over int8 or dense f32 weights, off the
// serving path): w8a16_fma_kernel, CUDA-core FMAs over 32 x 64 tiles, no
// split.
//
// Dense bf16 weights (a model served without weight quantization, the
// engine's default): w8a16_dense_kernel replaces the einsum on dense weights
// (_w + einsum, grove_tpu/models/llama.py:157, :166-193) and the LM head's
// preferred_element_type=f32 product (:227-229) at M <= 256 (above it, in
// slabs of 256 rows). Bound by the weight bytes, 2 K N, up to M ~ 256, where
// 2 M K N operations reach the card's ridge. So a CTA reads its weight tile
// once for every token of the launch: the grid has no M axis.
//   - Swapped operands on wgmma: A is the weight, 64 columns by 16 k, read
//     from the TMA'd 128-byte-swizzled bf16 box [64 k][64 columns] as an
//     MN-major operand (the transpose bit); B is x, K-major by TMA in boxes
//     of [64 tokens][64 k], rows past M zero-filled. The kernel is built for
//     kT = ceil(M / 64) token tiles (a template argument), one wgmma of
//     n = 64 kT per 16-deep step: the n follows M, and each output element's
//     sum does not (phase 3 of chip_smoke.py holds rows bitwise across M).
//   - A CTA covers 128 columns: two consumer warpgroups of 64 columns share
//     each stage's x boxes; one producer warp keeps a ring of stages (both
//     weight boxes and kT x boxes) in flight behind full/empty mbarriers.
//     One CTA per SM, with as many stages as ~200 KB holds (8 at kT = 1, 4
//     at kT = 4): fewer, longer CTAs, since each pays the ring's fill and
//     the cluster epilogue once (ops/w8a16.py::RESIDENT["bf16"]).
//   - Split-K in a cluster, each rank owning 128 / split columns; the split
//     (ops/w8a16.py::split_count with the build's fixed residency) never
//     follows M. The partial tile grows with M (f32, 135 KB at kT = 4), so
//     each rank stages it over its drained ring; after a cluster barrier
//     each owner reads its columns of every rank's tile, 16 bytes at a time
//     (ld.shared::cluster), sums them in rank order and writes them, four
//     adjacent columns a store.
//   - Four token tiles (M 193..256: the prefill chunk, the verify above 192
//     rows), w8a16_dense4_kernel. There the launch is near the card's ridge
//     (2 M K N operations take ~80% of the weight bytes' time), so idle SMs
//     cost directly. Measured on an H100 at Yi-1.5-9B's launches, one CTA
//     per 128 columns and all 256 rows fills 0.61 of a wave for QKV (80
//     CTAs), 0.48 for wo and w_down (64) and 1.30 for gate/up (172, a second
//     wave of 40 CTAs). Its main loop runs each SM's tensor cores near their
//     peak, so the time is waves x one CTA's work, plus ~11 us per CTA of
//     fill and epilogue (about half of it the epilogue) that no other work
//     hides. The rows of a column tile may run as two CTAs of 128 rows each
//     (wgmma n = 128, a ring of 6 stages), side by side, so the second read
//     of the weight tile comes from L2: launches whose whole tiles leave
//     half the card idle run every tile halved (wo, w_down: 128 CTAs, one
//     wave), and gate/up runs half its tiles whole and halves the rest (258
//     CTAs: the halves fill what the whole tiles leave, 1.5 tiles' time
//     instead of 2). The split, the k order and the rank-order sum stay the
//     one-tile build's, so a row's bits do not depend on M; the choice
//     (ops/w8a16.py::dense_whole) follows the weights alone. What bounds it
//     then: the bytes the SMs take in from L2 (the weight tiles, and x
//     again for every column tile; ~7 TB/s in all on this card), not the
//     HBM weight stream; TMA multicast of x to a pair of column-neighbour
//     CTAs, a deeper weight ring with fewer x stages, and 192-column CTAs
//     (three consumer warpgroups: 128 accumulators a thread do not fit the
//     registers of 416 or 512 threads) measured no better or could not be
//     built.
//
// The C entry points return cudaGetLastError() after a launch (or the
// error that kept it from launching); they launch on the given stream and
// never synchronize.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBK = 64;        // k-step depth
constexpr int kBN = 128;       // weight columns per CTA (tensor cores)
constexpr int kMaxWeights = 3;
constexpr int kMaxSplit = 8;   // the portable cluster size

// The weights of one launch, in column-tile order: they share x and K; each
// has its own weight [K, n] (int8 codes with bf16 scales [n], or a dense
// bf16 or f32 weight, no scales), output [M, n] and first column tile
// (tile0[count] is the total).
struct Weights {
  const void* w[kMaxWeights];  // int8 codes, or the bf16 / f32 weight
  const __nv_bfloat16* scale[kMaxWeights];
  void* out[kMaxWeights];
  int n[kMaxWeights];
  int tile0[kMaxWeights + 1];
  int count;
};

// The weight (index j) that column tile `tile` of a launch falls in, and the
// tile's first column within it.
struct Target {
  const void* w;
  const __nv_bfloat16* scale;
  void* out;
  int N, n0, j;
};

__device__ __forceinline__ Target target_of(const Weights& w, int tile,
                                            int bn) {
  Target t{w.w[0], w.scale[0], w.out[0], w.n[0], tile * bn, 0};
#pragma unroll
  for (int j = 1; j < kMaxWeights; ++j)
    if (j < w.count && tile >= w.tile0[j])
      t = Target{w.w[j], w.scale[j], w.out[j], w.n[j],
                 (tile - w.tile0[j]) * bn, j};
  return t;
}

// The k-steps [k0, k1) of split s of k_steps steps in `split` parts.
__device__ __forceinline__ void split_range(int k_steps, int split, int s,
                                            int* k0, int* k1) {
  *k0 = (int)((long long)s * k_steps / split);
  *k1 = (int)((long long)(s + 1) * k_steps / split);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void store_pair(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_quad(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store_quad(__nv_bfloat16* out, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(out) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// ---- mbarriers, TMA, cluster ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// some ten seconds means a broken pipeline: trap, so that the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Generic-proxy writes to shared memory, made visible to the async proxy
// (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The cluster barrier, in halves: every thread of every CTA of the cluster
// arrives, then waits for all the others.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of this CTA's shared-memory address `addr` in cluster rank
// `rank`'s shared memory.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f32x2(uint32_t addr, float a,
                                                 float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- the exact dequantize ----

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte i (0..3) of u = codes ^ 0x80808080 (x + 128 in each byte) as the
// exact f32 x: the byte permute builds the f32 2^23 + (x + 128), less
// 2^23 + 128 (no conversion unit, which runs at a quarter of the FMA rate).
__device__ __forceinline__ float code_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
         8388736.0f;
}

// Two exact bf16 codes (lo, hi) times two bf16 scales, each product rounded
// once to bf16: fma.rn with a -0 addend is the rounded product itself.
__device__ __forceinline__ uint32_t scale_pair(float lo, float hi,
                                               uint32_t s2) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(pack_bf16(lo, hi)), "r"(s2), "r"(0x80008000u));
  return d;
}

// ---- small M: swapped mma.sync, TMA ring, split-K in a cluster ----

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

// One register of ldmatrix.trans over the int8 tile: the codes of columns
// c = 2 gid and c + 1 at k = 2 tig and k + 1, as bytes (k, c), (k, c + 1),
// (k + 1, c), (k + 1, c + 1). Out: the A register of fragment row gid
// (column c: k, k + 1) and of row gid + 8 (column c + 1), each times its
// column's scale (s_lo, s_hi: the scale in both halves).
__device__ __forceinline__ void dequant_a(uint32_t r, uint32_t s_lo,
                                          uint32_t s_hi, uint32_t& row_lo,
                                          uint32_t& row_hi) {
  const uint32_t u = r ^ 0x80808080u;
  row_lo = scale_pair(code_f32(u, 0), code_f32(u, 2), s_lo);
  row_hi = scale_pair(code_f32(u, 1), code_f32(u, 3), s_hi);
}

constexpr int kSmallM = 32;                        // tokens per CTA
constexpr int kSmallWarps = 4;                     // consumers: 32 columns
constexpr int kSmallConsumers = 32 * kSmallWarps;
constexpr int kSmallThreads = kSmallConsumers + 32;  // + the producer warp
constexpr int kSmallStages = 4;
constexpr int kQTileBytes = kBK * kBN;             // int8 [64 k][128 n]
constexpr int kSmallXBytes = kSmallM * kBK * 2;    // bf16 [32 m][64 k]
constexpr int kRecvBytes = kBN * kSmallM * 4;      // f32 [rank][m][slice]

constexpr int kSmallStageBytes = kQTileBytes + kSmallXBytes;
constexpr int kSmallBarOff = kSmallStages * kSmallStageBytes + kRecvBytes;
constexpr int kSmallSmem = kSmallBarOff + 16 * kSmallStages + 1024;

// Grid: (column tiles of every weight, split, M tiles of 32), clusters of
// (1, split, 1): rank = blockIdx.y = the part of K. Tiles in shared memory
// (128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)): the
// weight [64 k][128 columns] and x [32 m][64 k] of each stage.
template <typename OutT>
__global__ void __launch_bounds__(kSmallThreads)
    w8a16_small_kernel(__grid_constant__ const CUtensorMap x_map,
                       __grid_constant__ const CUtensorMap w_map0,
                       __grid_constant__ const CUtensorMap w_map1,
                       __grid_constant__ const CUtensorMap w_map2,
                       const Weights ws, int M, int K, int split) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t recv_addr = base + kSmallStages * kSmallStageBytes;
  const float* const recv =
      reinterpret_cast<const float*>(smem_raw + (recv_addr - raw));
  const uint32_t bar0 = base + kSmallBarOff;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kSmallStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Target tg = target_of(ws, blockIdx.x, kBN);
  const int m0 = blockIdx.z * kSmallM, rank = blockIdx.y;
  int k0, k1;  // a last k-step past K reads zeros (TMA's fill)
  split_range((K + kBK - 1) / kBK, split, rank, &k0, &k1);
  const int n_k = k1 - k0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSmallStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kSmallWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (split > 1) cluster_arrive_relaxed();  // this CTA has started

  if (warp == kSmallWarps) {
    // Producer: lane 0 keeps the ring filled.
    if (lane == 0) {
      const CUtensorMap* wm =
          tg.j == 0 ? &w_map0 : tg.j == 1 ? &w_map1 : &w_map2;
      prefetch_map(wm);
      prefetch_map(&x_map);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kSmallStages, use = i / kSmallStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const uint32_t st = base + s * kSmallStageBytes;
        mbar_expect_tx(full(s), kSmallStageBytes);
        tma_load_2d(st, wm, full(s), tg.n0, (k0 + i) * kBK);
        tma_load_2d(st + kQTileBytes, &x_map, full(s), (k0 + i) * kBK, m0);
      }
    }
    __syncwarp();
    if (split > 1) {  // the cluster's two barriers, as every thread
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // Consumer warp `warp`: columns 32 warp + 16 t + 0..15 (t = 0, 1) of the
  // tile, every token of it. Lane (gid, tig)'s scales, columns 2 gid and
  // 2 gid + 1 of each 16 (zero past N; N % 16 == 0).
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t s_lo[2], s_hi[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = tg.n0 + 32 * warp + 16 * t + 2 * gid;
    const uint32_t p =
        c < tg.N ? *reinterpret_cast<const uint32_t*>(tg.scale + c) : 0u;
    s_lo[t] = __byte_perm(p, 0, 0x1010);
    s_hi[t] = __byte_perm(p, 0, 0x3232);
  }
  // acc[t][j]: rows = columns of 16-column tile t (through fragment_column),
  // columns = tokens 8 j + 0..7; token tiles wholly past M are skipped.
  float acc[2][4][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  const int rows_left = M - m0;
  const int n_tiles = rows_left >= kSmallM ? 4 : (rows_left + 7) / 8;
  // ldmatrix addresses: lane l supplies row l % 8 of matrix l / 8.
  const int mi = lane >> 3;

  for (int i = 0; i < n_k; ++i) {
    const int s = i % kSmallStages;
    mbar_wait(full(s), (i / kSmallStages) & 1);
    const uint32_t qs = base + s * kSmallStageBytes, xs = qs + kQTileBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k 32 h .. 32 h + 31 of the step
      // B = x^T: k16 steps 2 h + kk, token tiles 2 jp and 2 jp + 1 per
      // ldmatrix (matrices: tile 2 jp k-lo, k-hi, tile 2 jp + 1 k-lo, k-hi).
      uint32_t b[2][4][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int row = 8 * (2 * jp + (mi >> 1)) + (lane & 7);
          const int chunk = 2 * (2 * h + kk) + (mi & 1);
          uint32_t r[4];
          ldmatrix_x4(r, xs + row * 128 + ((chunk ^ (row & 7)) << 4));
          b[kk][2 * jp][0] = r[0];
          b[kk][2 * jp][1] = r[1];
          b[kk][2 * jp + 1][0] = r[2];
          b[kk][2 * jp + 1][1] = r[3];
        }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // A = w^T: k rows 32 h + lane of column chunk 2 warp + t; r[q] is
        // k 32 h + 8 q + 0..7.
        uint32_t a[2][4];
        const int row = 32 * h + lane, chunk = 2 * warp + t;
        uint32_t r[4];
        ldmatrix_x4_trans(r, qs + row * 128 + ((chunk ^ (row & 7)) << 4));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          dequant_a(r[2 * kk], s_lo[t], s_hi[t], a[kk][0], a[kk][1]);
          dequant_a(r[2 * kk + 1], s_lo[t], s_hi[t], a[kk][2], a[kk][3]);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < n_tiles)
              mma_bf16(acc[t][j], a[kk], b[kk][j][0], b[kk][j][1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // Element e of acc[t][j]: token 8 j + 2 tig + (e & 1) of weight column
  // (tile-local) 32 warp + 16 t + 2 gid + (e >> 1): adjacent column pairs.
  OutT* const out = static_cast<OutT*>(tg.out);
  const int N = tg.N;
  if (split == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + 2 * tig + h;
          const int n = tg.n0 + 32 * warp + 16 * t + 2 * gid;
          if (m < M && n < N)
            store_pair(out + (size_t)m * N + n, acc[t][j][h],
                       acc[t][j][2 + h]);
        }
    return;
  }
  // Rank r owns columns [r slice, (r + 1) slice) of the tile; its recv
  // buffer holds each rank's partial of them as f32 [rank][token][slice].
  // A 16-column mma tile lies within one slice (slice >= 16).
  const int slice = kBN / split;
  cluster_wait();  // every rank has started
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int lc = 32 * warp + 16 * t + 2 * gid;
    const uint32_t owner = (uint32_t)(lc / slice);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = 8 * j + 2 * tig + h;
        const uint32_t off =
            (uint32_t)(((rank * kSmallM + tok) * slice + lc % slice) * 4);
        st_cluster_f32x2(map_rank(recv_addr + off, owner), acc[t][j][h],
                         acc[t][j][2 + h]);
      }
  }
  cluster_arrive();
  cluster_wait();  // every partial has landed; no remote access after this
  const int per_row = slice / 4;
  for (int it = threadIdx.x; it < kSmallM * per_row; it += kSmallConsumers) {
    const int tok = it / per_row, c = (it % per_row) * 4;
    const int m = m0 + tok, n = tg.n0 + rank * slice + c;
    if (m >= M || n >= N) continue;
    float4 sum = *reinterpret_cast<const float4*>(recv + tok * slice + c);
    for (int src = 1; src < split; ++src) {
      const float4 v = *reinterpret_cast<const float4*>(
          recv + (src * kSmallM + tok) * slice + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store_pair(out + (size_t)m * N + n, sum.x, sum.y);
    store_pair(out + (size_t)m * N + n + 2, sum.z, sum.w);
  }
}

// ---- wide M: wgmma over a dequantized bf16 B tile ----

// Shared-memory matrix descriptor for a 128-byte-swizzled operand. For a
// K-major operand (x) `lbo` is unused and `sbo` is the 8-row stride; for an
// MN-major one (the bf16 weight tile) `lbo` is the stride between 64-column
// panels and `sbo` the 8-row stride along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(a, i)                                                       \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),          \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d[64 x 256] += A[64 x 16] B[16 x 256]: A K-major and B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_ss_tb(float (&d)[128],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, "
      "1, 0, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56), F8(d, 64), F8(d, 72), F8(d, 80), F8(d, 88),
        F8(d, 96), F8(d, 104), F8(d, 112), F8(d, 120)
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A MN-major (transposed) and B K-major
// in shared memory; N / 2 accumulators a thread.
template <int N>
__device__ __forceinline__ void wgmma_ss_ta(float (&d)[N / 2],
                                            uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss_ta<64>(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_ta<128>(float (&d)[64],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32),
        F8(d, 40), F8(d, 48), F8(d, 56)
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_ta<192>(float (&d)[96],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32),
        F8(d, 40), F8(d, 48), F8(d, 56), F8(d, 64), F8(d, 72),
        F8(d, 80), F8(d, 88)
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_ta<256>(float (&d)[128],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32),
        F8(d, 40), F8(d, 48), F8(d, 56), F8(d, 64), F8(d, 72),
        F8(d, 80), F8(d, 88), F8(d, 96), F8(d, 104), F8(d, 112),
        F8(d, 120)
      : "l"(desc_a), "l"(desc_b), "n"(1));
}

#undef F8

constexpr int kWideM = 128;                        // rows per CTA
constexpr int kWideN = 256;                        // weight columns per CTA
constexpr int kWideWarps = 8;                      // two consumer warpgroups
constexpr int kWideConsumers = 32 * kWideWarps;
constexpr int kWideThreads = kWideConsumers + 32;  // + the producer warp
constexpr int kWideStages = 4;
constexpr int kWideQBytes = kBK * kWideN;          // int8, two boxes
constexpr int kWideXBytes = kWideM * kBK * 2;      // bf16 [128 m][64 k]
constexpr int kWideStageBytes = kWideQBytes + kWideXBytes;
constexpr int kBPanelBytes = kBK * 128;            // bf16 [64 k][64 n]
constexpr int kBTileBytes = 4 * kBPanelBytes;      // [64 k][256 n]
constexpr int kWideBOff = kWideStages * kWideStageBytes;
constexpr int kWideBarOff = kWideBOff + 2 * kBTileBytes;
constexpr int kWideSmem = kWideBarOff + 16 * kWideStages + 1024;

// Grid: (column tiles of 256 of every weight, 1, M tiles of 128). Each
// stage of the ring holds the weight's int8 [64 k][256 n] (two boxes) and
// x's [128 m][64 k]; two bf16 B tiles alternate. Iteration i starts the
// wgmmas of step i on B tile i & 1, dequantizes step i + 1 into the other
// tile while they run, then waits for them and meets the other warpgroup
// at a named barrier. 256 columns per CTA: with 128, each CTA read as many
// bytes from L2 per operation as kept the tensor cores at ~40%.
template <typename OutT>
__global__ void __launch_bounds__(kWideThreads, 1)
    w8a16_wide_kernel(__grid_constant__ const CUtensorMap x_map,
                      __grid_constant__ const CUtensorMap w_map0,
                      __grid_constant__ const CUtensorMap w_map1,
                      __grid_constant__ const CUtensorMap w_map2,
                      const Weights ws, int M, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + kWideBarOff;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kWideStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Target tg = target_of(ws, blockIdx.x, kWideN);
  const int m0 = blockIdx.z * kWideM, n_k = K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWideWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWideWarps) {
    if (lane != 0) return;
    const CUtensorMap* wm =
        tg.j == 0 ? &w_map0 : tg.j == 1 ? &w_map1 : &w_map2;
    prefetch_map(wm);
    prefetch_map(&x_map);
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kWideStages, use = i / kWideStages;
      if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
      const uint32_t st = base + s * kWideStageBytes;
      mbar_expect_tx(full(s), kWideStageBytes);
      tma_load_2d(st, wm, full(s), tg.n0, i * kBK);
      tma_load_2d(st + kQTileBytes, wm, full(s), tg.n0 + kBN, i * kBK);
      tma_load_2d(st + kWideQBytes, &x_map, full(s), i * kBK, m0);
    }
    return;
  }

  // The dequantize: thread ct takes 16-byte chunk cc (columns 16 cc + 0..15;
  // box cc / 8) of k rows r0 + 16 jr (jr = 0..3); eight lanes in a row cover
  // eight k rows, so the swizzled reads and writes are free of bank
  // conflicts. Its scales as the bf16 pairs of adjacent columns (zero past
  // N; N % 16 == 0).
  const int ct = threadIdx.x, cc = (ct >> 3) & 15;
  const int r0 = (ct & 7) + 8 * (ct >> 7);
  uint32_t sc[8];
  {
    uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
    const int c = tg.n0 + 16 * cc;
    if (c < tg.N) {
      v0 = *reinterpret_cast<const uint4*>(tg.scale + c);
      v1 = *reinterpret_cast<const uint4*>(tg.scale + c + 8);
    }
    sc[0] = v0.x, sc[1] = v0.y, sc[2] = v0.z, sc[3] = v0.w;
    sc[4] = v1.x, sc[5] = v1.y, sc[6] = v1.z, sc[7] = v1.w;
  }
  auto dequant = [&](int s, int buf) {
    const uint8_t* const q =
        smem + s * kWideStageBytes + (cc >> 3) * kQTileBytes;
    uint8_t* const b =
        smem + kWideBOff + buf * kBTileBytes + (cc >> 2) * kBPanelBytes;
    const int qc = cc & 7, ch = 2 * (cc & 3);  // box chunk; panel chunks
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int r = r0 + 16 * jr;
      const uint4 w =
          *reinterpret_cast<const uint4*>(q + r * 128 + ((qc ^ (r & 7)) << 4));
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t d[8];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t u = words[p] ^ 0x80808080u;
        d[2 * p] = scale_pair(code_f32(u, 0), code_f32(u, 1), sc[2 * p]);
        d[2 * p + 1] =
            scale_pair(code_f32(u, 2), code_f32(u, 3), sc[2 * p + 1]);
      }
      *reinterpret_cast<uint4*>(b + r * 128 + ((ch ^ (r & 7)) << 4)) =
          make_uint4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<uint4*>(b + r * 128 + (((ch + 1) ^ (r & 7)) << 4)) =
          make_uint4(d[4], d[5], d[6], d[7]);
    }
  };
  auto consumers_sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWideConsumers) : "memory");
  };

  const int wg = warp >> 2;  // rows 64 wg .. 64 wg + 63 of the tile
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  mbar_wait(full(0), 0);
  dequant(0, 0);
  fence_proxy_async();
  consumers_sync();
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kWideStages;
    const uint32_t xs =
        base + s * kWideStageBytes + kWideQBytes + wg * 64 * 128;
    const uint32_t bs = base + kWideBOff + (i & 1) * kBTileBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n256k16_ss_tb(acc, sw128_desc(xs + 32 * kk, 16, 1024),
                             sw128_desc(bs + kk * 16 * 128, kBPanelBytes,
                                        1024));
    wgmma_commit();
    if (i + 1 < n_k) {
      const int s1 = (i + 1) % kWideStages;
      mbar_wait(full(s1), ((i + 1) / kWideStages) & 1);
      dequant(s1, (i + 1) & 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // step i's x and codes are used
    fence_proxy_async();
    consumers_sync();
  }

  // Element 4 j + 2 i + c: row 16 (warp % 4) + gid + 8 i of the
  // warpgroup's 64, column 8 j + 2 tig + c.
  OutT* const out = static_cast<OutT*>(tg.out);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 64 * wg + 16 * (warp & 3) + gid + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = tg.n0 + 8 * j + 2 * tig;
      if (n < tg.N)
        store_pair(out + (size_t)m * tg.N + n, acc[4 * j + 2 * i],
                   acc[4 * j + 2 * i + 1]);
    }
  }
}

// ---- dense bf16 weights, M <= 256: swapped wgmma, one weight read ----

constexpr int kDenseN = 64;                    // tokens per token tile
constexpr int kDenseMaxTiles = 4;              // 256 rows
constexpr int kWBoxBytes = kBK * 128;          // bf16 [64 k][64 n]
constexpr int kXBoxBytes = kDenseN * kBK * 2;  // bf16 [64 m][64 k]

constexpr int kDenseConsumers = 256;                 // two warpgroups
constexpr int kDenseThreads = kDenseConsumers + 32;  // + the producer warp

// The dense kernel's geometry for kT token tiles (up to 64 kT rows): one CTA
// per SM, whose ring takes as many stages as fit ~200 KB (8 at kT = 1, 4 at
// kT = 4), so each SM keeps 64 to 128 KB of weight in flight. The
// epilogue's f32 partial tile [64 kT tokens][128 columns] (rows padded by 4
// floats, so the accumulators' stores meet no bank conflict) lies over the
// drained ring.
template <int kT>
struct DenseGeom {
  static constexpr int kStageBytes = 2 * kWBoxBytes + kT * kXBoxBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kPartRow = kBN + 4;
  static constexpr int kPartBytes = kT * kDenseN * kPartRow * 4;
  static_assert(kPartBytes <= kRingBytes, "the partial tile fits the ring");
  static constexpr int kSmem = kRingBytes + 16 * kStages + 1024;
};

// Grid: (column tiles of 128 of every weight, split), clusters of
// (1, split, 1): rank = blockIdx.y = the part of K. No M axis: each CTA
// reads its weight tile once and serves every row of the launch (M <= 64 kT).
// Stage s holds weight boxes [64 k][64 columns] for columns n0 + 0..63 and
// n0 + 64..127, then x boxes [64 tokens][64 k] for tokens 64 j + 0..63
// (128-byte swizzle; together one K-major [64 kT tokens][64 k] tile).
// Consumer warpgroup wg takes columns n0 + 64 wg + 0..63: per k-step, one
// wgmma m64n(64 kT)k16 for each 16-deep kk, in increasing k; one group of
// products stays in flight while the next stage's are issued, and a stage
// is released once its group has finished. Element 4 jj + 2 i + c of acc:
// weight column 64 wg + 16 (warp % 4) + gid + 8 i of the tile, token
// 8 jj + 2 tig + c. n does not enter an element's sum: the split and the k
// order come from K and the weights alone.
template <typename OutT, int kT>
__global__ void __launch_bounds__(kDenseThreads, 1)
    w8a16_dense_kernel(__grid_constant__ const CUtensorMap x_map,
                       __grid_constant__ const CUtensorMap w_map0,
                       __grid_constant__ const CUtensorMap w_map1,
                       __grid_constant__ const CUtensorMap w_map2,
                       const Weights ws, int M, int K, int split) {
  using G = DenseGeom<kT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + G::kRingBytes;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (G::kStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Target tg = target_of(ws, blockIdx.x, kBN);
  const int rank = blockIdx.y;
  int k0, k1;  // a last k-step past K reads zeros (TMA's fill)
  split_range((K + kBK - 1) / kBK, split, rank, &k0, &k1);
  const int n_k = k1 - k0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDenseConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kDenseConsumers / 32) {
    // Producer: lane 0 keeps the ring filled.
    if (lane == 0) {
      const CUtensorMap* wm =
          tg.j == 0 ? &w_map0 : tg.j == 1 ? &w_map1 : &w_map2;
      prefetch_map(wm);
      prefetch_map(&x_map);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % G::kStages, use = i / G::kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const uint32_t st = base + s * G::kStageBytes;
        const int k = (k0 + i) * kBK;
        mbar_expect_tx(full(s), G::kStageBytes);
        tma_load_2d(st, wm, full(s), tg.n0, k);
        tma_load_2d(st + kWBoxBytes, wm, full(s), tg.n0 + 64, k);
#pragma unroll
        for (int j = 0; j < kT; ++j)
          tma_load_2d(st + 2 * kWBoxBytes + j * kXBoxBytes, &x_map, full(s),
                      k, kDenseN * j);
      }
    }
    __syncwarp();
    if (split > 1) {  // the cluster's two barriers, as every thread
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[kT * 32];
#pragma unroll
  for (int e = 0; e < kT * 32; ++e) acc[e] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % G::kStages;
    mbar_wait(full(s), (i / G::kStages) & 1);
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
      if (lane == 0) mbar_arrive(empty((i - 1) % G::kStages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // The epilogue: the partial tile into shared memory (over the ring, once
  // both warpgroups are done with it); then rank r sums columns
  // [r slice, (r + 1) slice) of every rank's tile in rank order 0, 1, ...,
  // reading 16 bytes at a time (ld.shared::cluster), and writes them. The
  // first cluster barrier orders every rank's tile before any read; the
  // second keeps each rank's shared memory alive until all have read it.
  // split = 1: no cluster, the CTA's consumers meet at named barrier 1.
  auto consumers_sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kDenseConsumers) : "memory");
  };
  consumers_sync();
  float* const part = reinterpret_cast<float*>(smem_raw + (base - raw));
  const int gid = lane >> 2, tig = lane & 3;
  const int lc0 = 64 * wg + 16 * (warp & 3) + gid;  // + 8 i
#pragma unroll
  for (int jj = 0; jj < 8 * kT; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        part[(8 * jj + 2 * tig + c) * G::kPartRow + lc0 + 8 * i] =
            acc[4 * jj + 2 * i + c];
  if (split > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    consumers_sync();
  }
  OutT* const out = static_cast<OutT*>(tg.out);
  const int N = tg.N, slice = kBN / split, per_row = slice / 4;
  for (int it = threadIdx.x; it < M * per_row; it += kDenseConsumers) {
    const int tok = it / per_row, c = rank * slice + (it % per_row) * 4;
    const int n = tg.n0 + c;
    if (n >= N) continue;
    const int at = tok * G::kPartRow + c;
    float4 sum;
    if (split == 1) {
      sum = *reinterpret_cast<const float4*>(part + at);
    } else {
      const uint32_t addr = base + (uint32_t)at * 4;
      float4 v[kMaxSplit];
#pragma unroll
      for (int src = 0; src < kMaxSplit; ++src)
        if (src < split) v[src] = ld_cluster_f32x4(map_rank(addr, src));
      sum = v[0];
#pragma unroll
      for (int src = 1; src < kMaxSplit; ++src)
        if (src < split) {
          sum.x += v[src].x;
          sum.y += v[src].y;
          sum.z += v[src].z;
          sum.w += v[src].w;
        }
    }
    store_quad(out + (size_t)tok * N + n, sum);
  }
  if (split > 1) {  // no rank exits while another may read its tile
    cluster_arrive();
    cluster_wait();
  }
}

// ---- dense bf16 weights at four token tiles (M 193..256) ----

// The four-tile build's ring, the same 192 KB for both kinds of CTA: 4
// stages of [two weight boxes | four x boxes] for a whole column tile (256
// tokens), or 6 of [two weight boxes | two x boxes] for half of one (128
// tokens). Its barriers are sized for the larger count.
constexpr int kDense4Ring = 192 * 1024;
constexpr int kDense4MaxStages = 6;
constexpr int kDense4Smem = kDense4Ring + 16 * kDense4MaxStages + 1024;
constexpr int kDense4PartRow = kBN + 4;

template <int kTT>
struct Dense4Part {
  static constexpr int kStageBytes = 2 * kWBoxBytes + kTT * kXBoxBytes;
  static constexpr int kStages = kDense4Ring / kStageBytes;
  static_assert(kStages <= kDense4MaxStages, "barriers for every stage");
  static_assert(kTT * kDenseN * kDense4PartRow * 4 <= kDense4Ring,
                "the partial tile fits the ring");
};

// One CTA's part of a column tile: tokens tok0 .. tok0 + 64 kTT - 1 of the
// launch, k-steps [k0, k0 + n_k) (split part `rank`), with
// w8a16_dense_kernel's main loop, partial tile and epilogue.
template <typename OutT, int kTT>
__device__ __forceinline__ void dense4_part(const CUtensorMap* x_map,
                                            const CUtensorMap* wm,
                                            const Target& tg, int M,
                                            int tok0, int k0, int n_k,
                                            int split, int rank,
                                            uint32_t base, float* part) {
  using P = Dense4Part<kTT>;
  const uint32_t bar0 = base + kDense4Ring;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kDense4MaxStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kDenseConsumers / 32) {
    if (lane == 0) {
      prefetch_map(wm);
      prefetch_map(x_map);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % P::kStages, use = i / P::kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const uint32_t st = base + s * P::kStageBytes;
        const int k = (k0 + i) * kBK;
        mbar_expect_tx(full(s), P::kStageBytes);
        tma_load_2d(st, wm, full(s), tg.n0, k);
        tma_load_2d(st + kWBoxBytes, wm, full(s), tg.n0 + 64, k);
#pragma unroll
        for (int j = 0; j < kTT; ++j)
          tma_load_2d(st + 2 * kWBoxBytes + j * kXBoxBytes, x_map, full(s),
                      k, tok0 + kDenseN * j);
      }
    }
    __syncwarp();
    if (split > 1) {
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[kTT * 32];
#pragma unroll
  for (int e = 0; e < kTT * 32; ++e) acc[e] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % P::kStages;
    mbar_wait(full(s), (i / P::kStages) & 1);
    const uint32_t st = base + s * P::kStageBytes;
    const uint32_t wbox = st + wg * kWBoxBytes, xs = st + 2 * kWBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_ta<kDenseN * kTT>(
          acc, sw128_desc(wbox + kk * 16 * 128, kWBoxBytes, 1024),
          sw128_desc(xs + 32 * kk, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((i - 1) % P::kStages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  auto consumers_sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kDenseConsumers) : "memory");
  };
  consumers_sync();
  const int gid = lane >> 2, tig = lane & 3;
  const int lc0 = 64 * wg + 16 * (warp & 3) + gid;
#pragma unroll
  for (int jj = 0; jj < 8 * kTT; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        part[(8 * jj + 2 * tig + c) * kDense4PartRow + lc0 + 8 * i] =
            acc[4 * jj + 2 * i + c];
  if (split > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    consumers_sync();
  }
  OutT* const out = static_cast<OutT*>(tg.out);
  const int N = tg.N, slice = kBN / split, per_row = slice / 4;
  const int items = min(kDenseN * kTT, M - tok0) * per_row;
  for (int it = threadIdx.x; it < items; it += kDenseConsumers) {
    const int tok = it / per_row, c = rank * slice + (it % per_row) * 4;
    const int n = tg.n0 + c;
    if (n >= N) continue;
    const int at = tok * kDense4PartRow + c;
    float4 sum;
    if (split == 1) {
      sum = *reinterpret_cast<const float4*>(part + at);
    } else {
      const uint32_t addr = base + (uint32_t)at * 4;
      float4 v[kMaxSplit];
#pragma unroll
      for (int src = 0; src < kMaxSplit; ++src)
        if (src < split) v[src] = ld_cluster_f32x4(map_rank(addr, src));
      sum = v[0];
#pragma unroll
      for (int src = 1; src < kMaxSplit; ++src)
        if (src < split) {
          sum.x += v[src].x;
          sum.y += v[src].y;
          sum.z += v[src].z;
          sum.w += v[src].w;
        }
    }
    store_quad(out + (size_t)(tok0 + tok) * N + n, sum);
  }
  if (split > 1) {  // no rank exits while another may read its tile
    cluster_arrive();
    cluster_wait();
  }
}

// Grid: (units, split), clusters of (1, split, 1): rank = blockIdx.y. Unit
// u < whole is column tile u with all 64 kTT <= 256 rows of the launch
// (wgmma n = 256); the other units are the halves of the tiles after them,
// u = whole + 2 t' + h: tile whole + t', rows 128 h .. 128 h + 127 (n =
// 128). Each CTA reads its weight tile once for the rows it serves; both
// halves of a tile run side by side (adjacent units), so the second read
// comes from L2. Whether a tile runs whole or halved changes only which
// CTA holds an element: each element's sum is the same split parts in the
// same k order and rank order (ops/w8a16.py::dense_geometry picks
// `whole`).
template <typename OutT>
__global__ void __launch_bounds__(kDenseThreads, 1)
    w8a16_dense4_kernel(__grid_constant__ const CUtensorMap x_map,
                        __grid_constant__ const CUtensorMap w_map0,
                        __grid_constant__ const CUtensorMap w_map1,
                        __grid_constant__ const CUtensorMap w_map2,
                        const Weights ws, int M, int K, int split,
                        int whole) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + kDense4Ring;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDense4MaxStages; ++s) {
      mbar_init(bar0 + 8 * s, 1);
      mbar_init(bar0 + 8 * (kDense4MaxStages + s), kDenseConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int u = blockIdx.x, half = u - whole;
  const Target tg = target_of(ws, half < 0 ? u : whole + half / 2, kBN);
  const CUtensorMap* wm = tg.j == 0 ? &w_map0 : tg.j == 1 ? &w_map1 : &w_map2;
  const int rank = blockIdx.y;
  int k0, k1;  // a last k-step past K reads zeros (TMA's fill)
  split_range((K + kBK - 1) / kBK, split, rank, &k0, &k1);
  float* const part = reinterpret_cast<float*>(smem_raw + (base - raw));
  if (half < 0)
    dense4_part<OutT, 4>(&x_map, wm, tg, M, 0, k0, k1 - k0, split, rank,
                         base, part);
  else
    dense4_part<OutT, 2>(&x_map, wm, tg, M, 2 * kDenseN * (half & 1), k0,
                         k1 - k0, split, rank, base, part);
}

// ---- f32 activations: CUDA cores ----

constexpr int kFmaThreads = 256;
constexpr int kFmaBM = 32, kFmaBN = 64, kFmaRows = kFmaBM * kFmaBN /
                                                   kFmaThreads;

// Grid: (column tiles of 64, 1, M tiles of 32): thread column tid % 64,
// rows 8 (tid / 64) + 0..7 of the tile, k in increasing order. kF32W: a
// dense f32 weight (an f32 model served without weight quantization), else
// int8 codes dequantized as the plain version does.
template <bool kF32W>
__global__ void __launch_bounds__(kFmaThreads)
    w8a16_fma_kernel(const float* __restrict__ x, const Weights ws, int M,
                     int K) {
  const Target tg = target_of(ws, blockIdx.x, kFmaBN);
  float* const out = static_cast<float*>(tg.out);
  const int N = tg.N;
  const int tid = threadIdx.x, col = tid % kFmaBN,
            row0 = (tid / kFmaBN) * kFmaRows;
  const int n = tg.n0 + col, m0 = blockIdx.z * kFmaBM;
  const float s =
      !kF32W && n < N ? __bfloat162float(tg.scale[n]) : 0.f;
  float acc[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; ++k) {
    float w = 0.f;
    if (n < N) {
      const size_t at = (size_t)k * N + n;
      w = kF32W ? static_cast<const float*>(tg.w)[at]
                : __bfloat162float(__float2bfloat16_rn(
                      (float)static_cast<const int8_t*>(tg.w)[at] * s));
    }
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const int m = m0 + row0 + r;
      const float xv = m < M ? x[(size_t)m * K + k] : 0.f;
      acc[r] = fmaf(xv, w, acc[r]);
    }
  }
  for (int r = 0; r < kFmaRows; ++r) {
    const int m = m0 + row0 + r;
    if (m < M && n < N) out[(size_t)m * N + n] = acc[r];
  }
}

// ---- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) through the runtime,
// so the build needs no -lcuda.
cudaError_t encode_fn(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A row-major [rows, cols] matrix as a 2-D tensor map, boxes of box_cols x
// box_rows (box_cols * elt = 128 bytes), 128-byte swizzled, zero-filled past
// the matrix.
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elt,
                     const void* ptr, long long cols, long long rows,
                     int box_cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elt)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A source that includes this file with GROVE_GEMM_DEVICE_ONLY defined
// (csrc/moe_gemm.cu) takes the device code and the map helpers above, and
// none of this file's launches or entry points.
#ifdef GROVE_GEMM_DEVICE_ONLY
}  // namespace
#else

// What a launch over a set of weights needs besides x, M and the output:
// made once per set (ops/w8a16.py caches it by the weights' pointers and
// shapes) and copied by value at each launch.
struct alignas(64) Plan {
  CUtensorMap w_map[kMaxWeights];    // bf16 activations only
  Weights ws;                        // out[] set at each launch
  long long out_off[kMaxWeights];    // output i at out + M * out_off[i]
  int K, x_dtype, w_dtype, out_dtype, wide, split;
  int whole;  // the dense kernel's whole column tiles at four token tiles
};

template <class Kernel>
cudaError_t raise_smem(Kernel kernel, int bytes, bool* ready) {
  if (*ready) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *ready = true;
  return err;
}

// A launch of a split-K kernel (the small or the dense one): grid (column
// tiles, split, z), clusters of (1, split, 1) where split > 1.
template <class Kernel>
cudaError_t launch_split(Kernel kernel, int smem, bool* ready, int threads,
                         int z, const CUtensorMap& x_map, Plan& p, int M,
                         cudaStream_t st) {
  cudaError_t err = raise_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ws.tile0[p.ws.count], p.split, z);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  void* args[] = {const_cast<CUtensorMap*>(&x_map), &p.w_map[0],
                  &p.w_map[1], &p.w_map[2], &p.ws, &M, &p.K, &p.split};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_small(const CUtensorMap& x_map, Plan& p, int M,
                         cudaStream_t st) {
  static bool ready = false;  // one attribute call per instantiation
  return launch_split(w8a16_small_kernel<OutT>, kSmallSmem, &ready,
                      kSmallThreads, (M + kSmallM - 1) / kSmallM, x_map, p,
                      M, st);
}

template <typename OutT, int kT>
cudaError_t launch_dense(const CUtensorMap& x_map, Plan& p, int M,
                         cudaStream_t st) {
  static bool ready = false;
  return launch_split(w8a16_dense_kernel<OutT, kT>, DenseGeom<kT>::kSmem,
                      &ready, kDenseThreads, 1, x_map, p, M, st);
}

// The four-tile build (ops/w8a16.py::dense_geometry): p.whole column tiles
// whole, then two halves of each other tile, each split in a cluster.
template <typename OutT>
cudaError_t launch_dense4(const CUtensorMap& x_map, Plan& p, int M,
                          cudaStream_t st) {
  auto kernel = w8a16_dense4_kernel<OutT>;
  static bool ready = false;
  cudaError_t err = raise_smem(kernel, kDense4Smem, &ready);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * p.ws.tile0[p.ws.count] - p.whole, p.split, 1);
  cfg.blockDim = dim3(kDenseThreads);
  cfg.dynamicSmemBytes = kDense4Smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  void* args[] = {const_cast<CUtensorMap*>(&x_map), &p.w_map[0],
                  &p.w_map[1], &p.w_map[2], &p.ws, &M, &p.K, &p.split,
                  &p.whole};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dense kernel built for ceil(M / 64) token tiles (M <= 256).
template <typename OutT>
cudaError_t launch_dense_rows(const CUtensorMap& x_map, Plan& p, int M,
                              cudaStream_t st) {
  switch ((M + kDenseN - 1) / kDenseN) {
    case 1:
      return launch_dense<OutT, 1>(x_map, p, M, st);
    case 2:
      return launch_dense<OutT, 2>(x_map, p, M, st);
    case 3:
      return launch_dense<OutT, 3>(x_map, p, M, st);
    case 4:
      return launch_dense4<OutT>(x_map, p, M, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename OutT>
cudaError_t launch_wide(const CUtensorMap& x_map, const Plan& p, int M,
                        cudaStream_t st) {
  auto kernel = w8a16_wide_kernel<OutT>;
  static bool ready = false;
  const cudaError_t err = raise_smem(kernel, kWideSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.ws.tile0[p.ws.count], 1, (M + kWideM - 1) / kWideM);
  kernel<<<grid, kWideThreads, kWideSmem, st>>>(
      x_map, p.w_map[0], p.w_map[1], p.w_map[2], p.ws, M, p.K);
  return cudaGetLastError();
}

// One launch over rows [0, M) of x and of the outputs in p.ws.out.
cudaError_t launch(Plan& p, const void* x, int M, cudaStream_t st) {
  if (p.x_dtype == 0) {
    const dim3 grid(p.ws.tile0[p.ws.count], 1, (M + kFmaBM - 1) / kFmaBM);
    if (p.w_dtype == 2)
      w8a16_fma_kernel<true><<<grid, kFmaThreads, 0, st>>>(
          static_cast<const float*>(x), p.ws, M, p.K);
    else
      w8a16_fma_kernel<false><<<grid, kFmaThreads, 0, st>>>(
          static_cast<const float*>(x), p.ws, M, p.K);
    return cudaGetLastError();
  }
  CUtensorMap x_map;
  const cudaError_t err =
      make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p.K, M, kBK,
               p.wide ? kWideM : p.w_dtype == 1 ? kDenseN : kSmallM);
  if (err != cudaSuccess) return err;
  if (p.wide)
    return p.out_dtype ? launch_wide<__nv_bfloat16>(x_map, p, M, st)
                       : launch_wide<float>(x_map, p, M, st);
  if (p.w_dtype == 1)
    return p.out_dtype ? launch_dense_rows<__nv_bfloat16>(x_map, p, M, st)
                       : launch_dense_rows<float>(x_map, p, M, st);
  return p.out_dtype ? launch_small<__nv_bfloat16>(x_map, p, M, st)
                     : launch_small<float>(x_map, p, M, st);
}

}  // namespace

extern "C" int grove_w8a16_plan_bytes() { return (int)sizeof(Plan); }

// Plan a launch of x [M, K] (x_dtype 0 = f32, 1 = bf16) times the `count`
// (1..3) weights w_i [K, n_i] (contiguous, 16-byte aligned) of w_dtype:
// 0 = int8 codes with scales_i [n_i] bf16, 1 = a dense bf16 weight (bf16 x,
// the dense kernel), 2 = a dense f32 weight (f32 x); dense weights take no
// scales (null). Outputs of out_dtype (0 = f32, 1 = bf16; f32 x takes an
// f32 output). wide = 1: the wgmma kernel (bf16 x, int8 weights, split 1);
// else bf16 x takes the small (int8) or dense (bf16) kernel with `split` in
// 1, 2, 4, 8 (at most the k-steps, ceil(K / 64)) and f32 x the FMA kernel
// (split 1). `whole`: the dense kernel's column tiles that run whole at
// four token tiles (0 .. all of them; the others run in halves).
// int8: K % 64 == 0, n_i % 16 == 0; bf16: K % 8 == 0, n_i % 8 == 0. Writes
// grove_w8a16_plan_bytes() bytes to `plan`.
extern "C" int grove_w8a16_plan(const void* const* w,
                                const void* const* scale, const int* n,
                                int count, int K, int x_dtype, int w_dtype,
                                int out_dtype, int wide, int split,
                                int whole, void* plan) {
  const bool pow2 = split == 1 || split == 2 || split == 4 || split == 8;
  const bool pair_ok = (w_dtype == 0) || (w_dtype == 1 && x_dtype == 1 &&
                                          !wide) ||
                       (w_dtype == 2 && x_dtype == 0);
  // int8: whole k-steps and 16-column scale pairs; bf16: 16-byte rows of x
  // and of the weight for TMA (a last partial k-step reads zeros past K).
  const int k_mult = w_dtype == 0 ? kBK : w_dtype == 1 ? 8 : 1;
  const int n_mult = w_dtype == 0 ? 16 : w_dtype == 1 ? 8 : 1;
  if (K <= 0 || K % k_mult != 0 || count < 1 || count > kMaxWeights ||
      !pow2 || split > (K + kBK - 1) / kBK || (x_dtype != 0 && x_dtype != 1) ||
      (w_dtype < 0 || w_dtype > 2) || !pair_ok ||
      (out_dtype != 0 && out_dtype != 1) ||
      (x_dtype == 0 && (out_dtype != 0 || wide || split != 1)) ||
      (wide && split != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  memset(&p, 0, sizeof(p));
  p.K = K, p.x_dtype = x_dtype, p.w_dtype = w_dtype;
  p.out_dtype = out_dtype, p.wide = wide, p.split = split;
  p.ws.count = count;
  const int bn = x_dtype == 0 ? kFmaBN : wide ? kWideN : kBN;
  long long off = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0 || n[i] % n_mult != 0 || w[i] == nullptr ||
        (w_dtype == 0 && scale[i] == nullptr))
      return (int)cudaErrorInvalidValue;
    p.ws.w[i] = w[i];
    p.ws.scale[i] = static_cast<const __nv_bfloat16*>(scale[i]);
    p.ws.n[i] = n[i];
    p.ws.tile0[i + 1] = p.ws.tile0[i] + (n[i] + bn - 1) / bn;
    p.out_off[i] = off;
    off += n[i];
    if (x_dtype == 1) {
      const cudaError_t err =
          w_dtype == 1
              ? make_map(&p.w_map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         w[i], n[i], K, 64, kBK)
              : make_map(&p.w_map[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         w[i], n[i], K, kBN, kBK);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (whole < 0 || whole > p.ws.tile0[count])
    return (int)cudaErrorInvalidValue;
  p.whole = whole;
  memcpy(plan, &p, sizeof(p));
  return 0;
}

// out: the outputs of a plan, one after another ([M, n_i] each). x and out
// contiguous and 16-byte aligned. slab > 0 (the small and dense kernels):
// one launch per `slab` consecutive rows, rows [r0, r0 + slab) of x read and
// of every output written in place, so each row takes the bits it takes at
// M <= slab. Else one launch. The dense kernel takes at most 256 rows a
// launch, so a dense plan needs 0 < slab <= 256.
extern "C" int grove_w8a16_run(const void* plan, const void* x, void* out,
                               int M, int slab, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(p));
  if (M <= 0 || slab < 0 ||
      (p.w_dtype == 1 && (slab == 0 || slab > kDenseN * kDenseMaxTiles)))
    return (int)cudaErrorInvalidValue;
  const int elt = p.out_dtype == 0 ? 4 : 2, x_elt = p.x_dtype == 0 ? 4 : 2;
  const int rows = slab > 0 && p.x_dtype == 1 && !p.wide ? slab : M;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int m = M - r0 < rows ? M - r0 : rows;
    for (int i = 0; i < p.ws.count; ++i)
      p.ws.out[i] = static_cast<char*>(out) +
                    ((size_t)M * p.out_off[i] + (size_t)r0 * p.ws.n[i]) * elt;
    const cudaError_t err = launch(
        p, static_cast<const char*>(x) + (size_t)r0 * p.K * x_elt, m, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A build's tile rows and columns, registers, local (spill) bytes, dynamic
// shared memory, largest cluster, residency, CTAs per SM and ring stages,
// into out[9]: which = 0 the small kernel over int8 weights, 3..6 the dense
// kernel for 1..4 token tiles (both: residency = clusters of kMaxSplit
// resident at once, by cudaOccupancyMaxActiveClusters), 1 the wide one, 2
// the FMA kernel (both: residency = CTAs per SM). The tensor-core builds are
// those with bf16 output.
template <class Kernel>
cudaError_t info_of(Kernel kernel, int smem, bool* ready, const void** fn) {
  *fn = reinterpret_cast<const void*>(kernel);
  return raise_smem(kernel, smem, ready);
}

template <int kT>
cudaError_t dense_info(const void** fn, int* smem, int* stages) {
  using G = DenseGeom<kT>;
  static bool ready = false;
  *smem = G::kSmem, *stages = G::kStages;
  return info_of(w8a16_dense_kernel<__nv_bfloat16, kT>, G::kSmem, &ready, fn);
}

// The four-tile build: its ring's stages for a whole column tile.
cudaError_t dense4_info(const void** fn, int* smem, int* stages) {
  static bool ready = false;
  *smem = kDense4Smem, *stages = Dense4Part<4>::kStages;
  return info_of(w8a16_dense4_kernel<__nv_bfloat16>, kDense4Smem, &ready,
                 fn);
}

extern "C" int grove_w8a16_info(int which, int* out) {
  const void* fn = nullptr;
  int bm, bn = kBN, smem = 0, threads, cluster = 1, stages = 0;
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    static bool ready = false;
    err = info_of(w8a16_small_kernel<__nv_bfloat16>, kSmallSmem, &ready, &fn);
    bm = kSmallM, smem = kSmallSmem, threads = kSmallThreads;
    cluster = kMaxSplit, stages = kSmallStages;
  } else if (which >= 3 && which <= 6) {
    const int t = which - 2;
    err = t == 1   ? dense_info<1>(&fn, &smem, &stages)
          : t == 2 ? dense_info<2>(&fn, &smem, &stages)
          : t == 3 ? dense_info<3>(&fn, &smem, &stages)
                   : dense4_info(&fn, &smem, &stages);
    bm = kDenseN * t, threads = kDenseThreads, cluster = kMaxSplit;
  } else if (which == 1) {
    static bool ready = false;
    err = info_of(w8a16_wide_kernel<__nv_bfloat16>, kWideSmem, &ready, &fn);
    bm = kWideM, bn = kWideN, smem = kWideSmem, threads = kWideThreads;
    stages = kWideStages;
  } else if (which == 2) {
    fn = reinterpret_cast<const void*>(w8a16_fma_kernel<false>);
    bm = kFmaBM, bn = kFmaBN, threads = kFmaThreads;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  resident = per_sm;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, cluster, 1);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = 1;
    a[0].val.clusterDim.y = cluster;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&resident, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
  }
  out[0] = bm;
  out[1] = bn;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  out[5] = cluster;
  out[6] = resident;
  out[7] = per_sm;
  out[8] = stages;
  return 0;
}

extern "C" const char* grove_w8a16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // GROVE_GEMM_DEVICE_ONLY
