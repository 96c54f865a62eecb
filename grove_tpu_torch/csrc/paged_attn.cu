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
// Both functions run as two kernels. Pass 1 is split-K over work items of
// (key span, group of query rows, sequence x group of kv heads), where the
// spans are fixed runs of split_keys positions tiling the table from
// position 0 on, so the number of spans follows the table width W, not the
// lengths, and a graph captured for a bucket serves every length in it. An
// item walks its key tiles in order, online softmax per row, and writes
// each row's partial (acc, m, l); an item whose span holds no key that any
// of its rows sees writes nothing. Pass 2 (paged_combine_kernel) merges
// each row's partials in span order over the spans that hold a key the row
// sees (a row with no visible key in a span of its item has a neutral
// partial, m = -1e30, l = 0, acc = 0, which would add exact zeros).
//
// A row's result depends only on its absolute position, its q row and the
// K/V rows: tiles and spans are aligned to position 0 whatever the chunk's
// offset, a tile wholly past a row's bound leaves its state bitwise
// unchanged (p = 0, correction exactly 1), and the combine reads the same
// spans in the same order. So a chunk boundary moved by a prefix-cache hit,
// the other rows of the item, and the table width never change a row's
// numbers; in the bf16 kernel a decode row at length p + 1 and a chunk row
// at position p run the same instructions on the same operands and agree
// bitwise.
//
// What bounds them on an H100: bytes. A decode step reads every live K/V
// row once for all g query heads of its kv head and does 4 d g flops per
// row and kv head; at llama-1b (d = 128, g = 2, bf16) that is 1 flop per
// byte, far below the ~295 flops per byte where the tensor cores would
// bind. A chunk of c = 32 positions does 32 times that, still far below.
//
// bfloat16 (the serving type): paged_partial_mma_kernel. A first, CUDA-core
// version of the kernel (kept for f32 below) reached 22% of the decode
// byte bound and lost 2.4x to a gather + SDPA composition on the chunk, for
// four reasons; the design answers each:
//   1. Synchronous loads, one 32-key tile in flight per CTA, four block-wide
//      barriers per tile. Here one producer warp streams K/V by TMA into a
//      three-stage ring of 16-position tiles with full/empty mbarriers;
//      four consumer warps compute tile t while tiles t + 1, t + 2 land,
//      and the steady loop has no block-wide barrier. The pool is a rank-4
//      tensor map over (d, position in block, kv head, block); one box is
//      (64 columns, gcd(bs, 16) positions of one block, the item's kv
//      heads), so a 16-position tile at bs = 16 is two boxes per K or V
//      (one per 64-column panel), each found through the table, and
//      columns past d load as zeros. Each span's table entries load
//      together, not one per tile.
//   2. f32 staging (twice the shared bytes). Tiles stay bf16 in shared
//      memory, 128-byte swizzled by the TMA, so the 8 rows of an ldmatrix
//      land in distinct bank groups.
//   3. Scores on the CUDA cores, half the warps idle at g = 2. Both
//      products are tensor-core mma.sync m16n8k16 (bf16 operands, f32
//      accumulators): a consumer warp holds one 16-row tile of one kv
//      head's query rows (decode: the g heads, padded to 16; chunk: 16 of
//      the positions x heads), its scaled q as A fragments in registers,
//      K and V as B fragments by ldmatrix (V transposed). The online
//      softmax runs on the accumulator fragments (row max and sum over the
//      quad that shares a row, exp2 of log2e-scaled scores), P is rounded
//      to bf16 in registers as the A operand of P.V and l sums the f32 p.
//   4. Grids that idle SMs or reread K/V. Items are one span of up to four
//      kv heads of one sequence (decode: one consumer warp per head) or of
//      one kv head with all 64 rows of 32 positions x 2 heads (chunk: each
//      K/V tile is read once per chunk, not once per 16-row group). The
//      kernel is persistent: two CTAs per SM take items at a fixed stride,
//      and both roles skip an item past every row it holds before any
//      load, so an SM streams tiles back to back (the producer runs ahead
//      across items) instead of paying a CTA's start and drain per span.
//      Spans are 128 positions (split_keys from the wrapper): shorter
//      spans gave the chunk more CTAs but cost decode more partials.
// Key slots of a tile past the keys it needs hold zeros (the ring is
// zeroed at start) or earlier finite rows, so P = 0 times them adds exact
// zeros. One instantiation per head-dim range: d <= 64 and d <= 128.
//
// float32: paged_partial_kernel, the CUDA-core kernel: 32-key tiles
// staged in shared memory as f32, one key per lane against a padded K
// tile, up to 16 query rows per CTA.
//
// int8 pools (GROVE_KV_QUANT=int8; the JAX package's _paged_gather_q,
// grove_tpu/models/llama.py:553): rows of int8 codes with one f32 scale per
// (slot, kv head) beside the pool. Each K/V value dequantizes as the plain
// version does, (float)code * scale in f32 rounded once to the query's type.
// In f32 the tile loads multiply by the row's scale. In bf16 the persistent
// kernel above runs over the int8 rows (kQ8):
//   1. Loads. The producer's lane 0 loads each tile's raw rows by TMA, one
//      box of (box_pos positions x the item's kv heads x d bytes) per K or V
//      and pool block, 128-byte swizzled at d = 128, where a row is exactly
//      one swizzle row. The scales ([nb, bs, n_kv] f32, too narrow a row for
//      a box at one kv head) come by cp.async from the 32 lanes on the same
//      full barrier. Where d % 16 != 0 no box fits a row and the lanes copy
//      the rows by cp.async too.
//   2. No bf16 staging tile. Each lane builds its bf16 B fragments from the
//      int8 codes in registers. K (keys on n, d on k): lane (gid, tig) reads
//      2 kNT bytes of key gid's row from byte 2 kNT tig, and k step ks takes
//      d = 2 kNT tig + 4 ks + 0..3, a fixed permutation of d that q's A
//      fragments take too (q8_column in ops/paged.py), so every score sums
//      the same terms. V (keys on k): ldmatrix.trans over the int8 rows read
//      as b16 hands a lane two adjacent columns of keys 2 tig and 2 tig + 1,
//      which split by byte into the B fragments of two 8-column tiles
//      (column 16 c + 2 n + e of tile 2 c + e, q8_output_column). dq4 makes
//      four codes exact f32 by byte permutes, multiplies each by its key's
//      scale and rounds once to bf16.
//   3. Once per tile. A decode item's four warps each hold one kv head; a
//      chunk item's four warps share one (RT > 1: kShare), and each builds a
//      quarter of the tile's fragments (k steps and V column pairs equal to
//      rt mod RT) into a double-buffered exchange in shared memory, then one
//      named barrier, then every warp reads them all. Those are the
//      fragments a lone warp builds, in the same order, so a decode row at
//      length p + 1 still equals the chunk row at p bitwise.
//   4. The staging tiles' shared memory went to the ring: as many stages, up
//      to 8, as keep two CTAs per SM (6 of 17,408 bytes at a llama-1b
//      decode step, 8 of 5,120 at a chunk).
// What bounds it on an H100 (PERF.md): at a decode step the copies and how
// evenly the items fall on the CTAs (with its consumers idle the kernel
// takes two thirds of its time), then the consumers' instructions (about
// four per code to dequantize); at a chunk of one sequence the latency of
// the 8 tiles an item walks in series.
//
// C entry points return cudaGetLastError() after their launches (or the
// error that kept them from launching); they launch on the given stream
// and never synchronize.

#include <cuda.h>
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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

// Four values of a pool row as f32, from element `off` of the pool whose
// row (slot, kv head) is `srow`: a float pool as stored; an int8 pool times
// the row's f32 scale (the product, whose rounding to an f32 model is
// exact: the plain version's dequantize).
__device__ __forceinline__ void load_kv4(const float* pool, const float*,
                                         size_t off, size_t, float* dst) {
  load_vec(pool + off, dst);
}

__device__ __forceinline__ void load_kv4(const int8_t* pool,
                                         const float* scales, size_t off,
                                         size_t srow, float* dst) {
  const char4 c = *reinterpret_cast<const char4*>(pool + off);
  const float s = scales[srow];
  dst[0] = (float)c.x * s; dst[1] = (float)c.y * s;
  dst[2] = (float)c.z * s; dst[3] = (float)c.w * s;
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
// a visible key in the tile. P: the pool's type (float, or int8 with
// per-row scales).
template <typename P>
__device__ __forceinline__ void attend_tile(const P* kpool, const P* vpool,
                                            const float* kscale,
                                            const float* vscale,
                                            const int* table_row, int nb,
                                            int bs, int n_kv, int kv, int d,
                                            int t0, int tile_end, int rows,
                                            const Smem& s, float* acc) {
  constexpr int kVec = 4;
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
      const size_t srow = (size_t)(blk * bs + p % bs) * n_kv + kv;
      load_kv4(kpool, kscale, srow * d + i, srow, kb);
      load_kv4(vpool, vscale, srow * d + i, srow, vb);
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
    s.sc[r * kTileK + lane] = p;
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

// Pass 1 for f32, decode (causal = 0) and chunk (causal = 1): grid
// (n_split, ceil(C / qpos), b * n_kv). The CTA holds rows = qpos * g query
// rows: position i = blockIdx.y * qpos + r / g of the chunk (C = 1 for
// decode), head kv * g + r % g, and attends to the keys of its span
// [split * split_keys, (split + 1) * split_keys) that the row sees: below
// the length (decode) or at most offset + i (chunk). Writes (acc[0..d), m,
// l) of each row into part[(row * n_split + split) * (d + 2)], row = the
// query row's index in [b, C, H]; m is in the natural-log domain.
template <typename P>
__global__ void __launch_bounds__(kThreads)
    paged_partial_kernel(const float* q, const P* kpool, const P* vpool,
                         const float* kscale, const float* vscale,
                         const int* tables,
                         const int* per_seq, float* part, int C, int W, int H,
                         int n_kv, int d, int nb, int bs, int qpos,
                         int split_keys, int causal, float scale) {
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
    s.qs[e] = i < C ? q[(((size_t)b * C + i) * H + kv * g + r % g) * d +
                        e % d] * scale
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
    attend_tile(kpool, vpool, kscale, vscale, table_row, nb, bs, n_kv, kv, d,
                t0, min(t0 + kTileK, max_lim), rows, s, acc);

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

// Pass 2: grid (rows); merges the partials of one query row in span order
// over the spans that hold a key the row sees, and writes out[row, :] (the
// [b, C, H, d] output). The loops over spans are unrolled so that the
// loads of several spans are in flight at once. kLog2: the partials' m is
// in the log2 domain.
template <typename T, bool kLog2>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* part, T* out, const int* per_seq, int C,
                         int H, int d, int n_split, int split_keys,
                         int n_keys, int causal) {
  const size_t row = blockIdx.x;
  const int b = (int)(row / ((size_t)C * H));
  const int i = (int)((row / H) % C);
  int lim = causal ? per_seq[b] + i + 1 : per_seq[b];
  lim = max(0, min(lim, n_keys));
  const int n_live = (lim + split_keys - 1) / split_keys;
  const float* base = part + row * n_split * (d + 2);
  auto ex = [](float x) { return kLog2 ? exp2f(x) : expf(x); };
  float M = kNegInf;
#pragma unroll 8
  for (int sp = 0; sp < n_live; ++sp)
    M = fmaxf(M, base[sp * (d + 2) + d]);
  float L = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < n_live; ++sp)
    L += base[sp * (d + 2) + d + 1] * ex(base[sp * (d + 2) + d] - M);
  const float den = fmaxf(L, 1e-30f);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp)
      o += base[sp * (d + 2) + c] * ex(base[sp * (d + 2) + d] - M);
    out[row * d + c] = from_f<T>(o / den);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor-core tiles fed by a TMA mbarrier ring.

namespace hopper {

constexpr int kTile = 16;            // positions per K/V tile (one mma k)
constexpr int kStages = 3;           // ring depth
constexpr int kConsumerWarps = 4;    // one 16-row tile of one kv head each
constexpr int kThreadsB = 32 * (kConsumerWarps + 1);  // + one producer warp
constexpr int kPanelCols = 64;       // bf16 columns of one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kMaxHeadPanels = 8;    // kv heads x 64-column panels per item
constexpr int kMaxBoxes = 128;       // boxes of one span (table entries)
// K + V of one stage, at most: 2 panels of 16 boxes in 1 KB slots.
constexpr int kMaxStageBytes = 2 * 2 * 16 * 1024;
constexpr int kChunkRows = 64;       // query rows of one kv head per item
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxStagesQ8 = 8;      // int8 ring depth, at most
constexpr int kBarBytes = 128;       // full and empty barriers of the ring
constexpr int kSmemPerCta = 233472 / 2 - 1024;  // two CTAs per SM
constexpr int kXchGroupBytes = 32 * 16;  // four fragment words of each lane

// How a call is cut into work items. An item holds qpos positions of the
// chunk (1 for decode) of HB kv heads over one key span: R = qpos * g
// query rows per kv head in RT 16-row tiles, HB * RT <= kConsumerWarps.
// K/V move as TMA boxes of (64 columns, box_pos positions of one pool
// block, HB heads), 128-byte swizzled: box_pos = gcd(bs, kTile), so a box
// never straddles two blocks, kTile / box_pos of them per tile and
// 64-column panel, each in its own 1024-byte-aligned slot.
// int8 pools: a stage holds K's raw rows, then V's, each kTile / box_pos
// boxes of (box_pos positions x HB heads) rows of dr bytes (d rounded up to
// 16), box j at j * slot; then the rows' f32 scales [K or V][head]
// [position]. The ring is `stages` deep (3 for bf16), and xch_bytes is the
// shared-fragment exchange of kShare builds (0 otherwise).
struct Geo {
  int B, C, W, H, n_kv, d, nb, bs;
  int g, qpos, R, RT, HB, split, n_split, causal;
  int n_panels, box_pos, slot, panel_bytes, stage_bytes, stages;
  int dr, q8_tma, q8_swz, xch_bytes;
  float scale;
};

// An int8 pool pair [nb, bs, n_kv, d] and its per-(slot, kv head) f32
// scales [nb, bs, n_kv] (the kQ8 kernels; null otherwise).
struct Q8Pools {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
};

__host__ __device__ __forceinline__ int q8_row_bytes(int d) {
  return (d + 15) & ~15;
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Ring of a call's geometry (HB, RT, box_pos, n_panels, d and panel_bytes
// set). A bf16 pool: three stages of K and V panels. An int8 pool: boxes by
// TMA where d % 16 == 0 (rows of d bytes, 128-byte swizzled at d = 128, so
// slots and stages are 1024-byte aligned), else by cp.async; as many
// stages, up to kMaxStagesQ8, as leave two CTAs per SM (the SM's 228 KB,
// 1 KB reserved per CTA); where several warps share a kv head (RT > 1), a
// double-buffered exchange of one tile's dequantized fragments per head.
inline void set_ring(Geo& gm, bool q8) {
  gm.xch_bytes = 0;
  if (!q8) {
    gm.stage_bytes = 2 * gm.n_panels * gm.panel_bytes;
    gm.stages = kStages;
    return;
  }
  gm.dr = q8_row_bytes(gm.d);
  gm.q8_tma = gm.d % 16 == 0;
  gm.q8_swz = gm.q8_tma && gm.dr == kRowBytes ? 7 : 0;
  const int box = gm.box_pos * gm.HB * gm.dr;
  gm.slot = gm.q8_tma ? round_up(box, gm.q8_swz ? 1024 : 128) : box;
  gm.stage_bytes = round_up(
      2 * (kTile / gm.box_pos) * gm.slot + 2 * gm.HB * kTile * 4, 1024);
  const int nt = gm.d <= 64 ? 8 : 16;
  if (gm.RT > 1) gm.xch_bytes = 2 * gm.HB * nt * kXchGroupBytes;
  gm.stages = min(kMaxStagesQ8,
                  (kSmemPerCta - kBarBytes - gm.xch_bytes - 1024) /
                      gm.stage_bytes);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One arrival on `bar` when every cp.async this thread started so far has
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
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

// Code i of the four int8 codes of w, as f32. A code x becomes the f32
// 2^23 + (x + 128) by one XOR and one byte permute, less 2^23 + 128:
// exactly x, without the conversion unit's quarter rate.
__device__ __forceinline__ float code_f32(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7540 + i)) -
         8388736.0f;
}

// The four int8 codes of w, each times s in f32 and rounded once to bf16
// (the plain version's dequantize), as two bf16 pairs.
__device__ __forceinline__ uint2 dq4(uint32_t w, float s) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = code_f32(w, i) * s;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// An ldmatrix.trans register over int8 V rows (bytes: key k columns c,
// c + 1, then key k + 1 columns c, c + 1), dequantized with the two keys'
// scales as dq4 does, into the B-fragment halves of two 8-column n-tiles:
// x = column c (keys k, k + 1), y = column c + 1.
__device__ __forceinline__ uint2 dq4_keys(uint32_t w, float s_lo,
                                          float s_hi) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = code_f32(w, i) * (i < 2 ? s_lo : s_hi);
  return make_uint2(pack_bf16(f[0], f[2]), pack_bf16(f[1], f[3]));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The consumer warps' barrier (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One work item: one key span of one group of query rows of HB kv heads.
// Items are numbered span-major, so CTA c's items lie about gridDim.x /
// (items per span) spans apart and mix early spans, which every sequence
// reaches, with late ones.
struct Item {
  int b, kv0, i0, seq, k_begin, k_end, n_tiles;
};

__device__ __forceinline__ Item item_at(int it, const Geo& gm,
                                        const int* per_seq) {
  const int ny = (gm.C + gm.qpos - 1) / gm.qpos;
  const int groups = gm.n_kv / gm.HB;
  const int per_span = ny * groups * gm.B;
  const int span = it / per_span;
  const int rest = it % per_span;
  Item w;
  const int z = rest % (groups * gm.B);
  w.b = z / groups;
  w.kv0 = (z % groups) * gm.HB;
  w.i0 = (rest / (groups * gm.B)) * gm.qpos;
  w.seq = per_seq[w.b];  // decode: length; chunk: offset
  w.k_begin = span * gm.split;
  w.k_end = min(w.k_begin + gm.split, gm.W * gm.bs);
  const int last_i = min(w.i0 + gm.qpos, gm.C) - 1;
  const int max_lim = max(
      w.k_begin, min(gm.causal ? w.seq + last_i + 1 : w.seq, w.k_end));
  // No tile when no row of the item sees a key of the span.
  w.n_tiles = (max_lim - w.k_begin + kTile - 1) / kTile;
  w.k_end = max_lim;  // from here on: the end of the keys to load
  return w;
}

// Byte offset, inside one panel of a stage, of the 128-byte row of
// position p (of the tile) and item head h.
__device__ __forceinline__ uint32_t row_offset(const Geo& gm, int p, int h) {
  return (p / gm.box_pos) * gm.slot +
         (h * gm.box_pos + p % gm.box_pos) * kRowBytes;
}

// The pool block of each box of item w's span, up to four boxes per lane
// (box lane + 32 u in blk[u]), loaded together: one latency per item.
__device__ __forceinline__ void span_blocks(int (&blk)[kMaxBoxes / 32],
                                            const Item& w, const int* trow,
                                            const Geo& gm, int lane) {
#pragma unroll
  for (int u = 0; u < kMaxBoxes / 32; ++u) {
    const int p = w.k_begin + (lane + 32 * u) * gm.box_pos;
    const int e = p < w.k_end ? trow[p / gm.bs] : 0;
    blk[u] = e < 0 ? 0 : (e >= gm.nb ? gm.nb - 1 : e);
  }
}

// int8 pools: byte offset, inside K's (or V's) half of a stage, of the row
// of position p (of the tile) and item head h.
__device__ __forceinline__ uint32_t row_q8(const Geo& gm, int p, int h) {
  return (p / gm.box_pos) * gm.slot +
         (h * gm.box_pos + p % gm.box_pos) * gm.dr;
}

// The pool block of position t0 + p of item w, from the span's boxes
// (blk, as span_blocks loads them). Every lane of the warp must call it.
__device__ __forceinline__ int block_at(const int (&blk)[kMaxBoxes / 32],
                                        const Item& w, int t0, int p,
                                        const Geo& gm) {
  const int bx = (t0 - w.k_begin + p) / gm.box_pos;
  const int e0 = __shfl_sync(0xffffffffu, blk[0], bx & 31);
  const int e1 = __shfl_sync(0xffffffffu, blk[1], bx & 31);
  const int e2 = __shfl_sync(0xffffffffu, blk[2], bx & 31);
  const int e3 = __shfl_sync(0xffffffffu, blk[3], bx & 31);
  return bx < 32 ? e0 : bx < 64 ? e1 : bx < 96 ? e2 : e3;
}

// int8 pools, producer: start the cp.async copies of the f32 scales of the
// tile [t0, t0 + kTile) of item w into `scales` ([K or V][head][position]):
// lane l takes position l % 16 of every other (K or V, head) row. Positions
// at or past the item's last key are not copied: they keep earlier finite
// values (or the zeros of the start), which P = 0 multiplies away.
__device__ __forceinline__ void copy_scales_q8(
    uint32_t scales, const Item& w, int t0, const int (&blk)[kMaxBoxes / 32],
    const Geo& gm, const Q8Pools& q8, int lane) {
  const int p = lane & 15;
  const int e = block_at(blk, w, t0, p, gm);
  const int pos = t0 + p;
  if (pos >= w.k_end) return;
  const size_t slot = (size_t)e * gm.bs + pos % gm.bs;
  for (int hw = lane >> 4; hw < 2 * gm.HB; hw += 2) {  // (K or V) * HB + h
    const int which = hw >= gm.HB ? 1 : 0;
    const size_t row = slot * gm.n_kv + w.kv0 + hw - which * gm.HB;
    cp_async4(scales + 4 * (hw * kTile + p), (which ? q8.vs : q8.ks) + row);
  }
}

// int8 pools where d % 16 != 0 (no TMA: a row is not a whole number of
// 16-byte units), producer: the cp.async copies of the tile's raw rows, laid
// out as the TMA path lays them (row_q8). Lanes 2 p and 2 p + 1 take
// position t0 + p, alternate 8-byte pieces of each of its rows.
__device__ __forceinline__ void copy_rows_q8(
    uint32_t st, const Item& w, int t0, const int (&blk)[kMaxBoxes / 32],
    const Geo& gm, const Q8Pools& q8, int lane) {
  const int d = gm.d, ppr = d / 8;
  const int p = lane >> 1, sub = lane & 1;
  const int e = block_at(blk, w, t0, p, gm);
  const int pos = t0 + p;
  if (pos >= w.k_end) return;
  const size_t slot = (size_t)e * gm.bs + pos % gm.bs;
  const uint32_t half = (kTile / gm.box_pos) * gm.slot;
  for (int hw = 0; hw < 2 * gm.HB; ++hw) {
    const int which = hw >= gm.HB ? 1 : 0, h = hw - which * gm.HB;
    const int8_t* src =
        (which ? q8.v : q8.k) + (slot * gm.n_kv + w.kv0 + h) * d;
    const uint32_t dst = st + which * half + row_q8(gm, p, h);
    for (int c = sub; c < ppr; c += 2) cp_async8(dst + 8 * c, src + 8 * c);
  }
}

// Pass 1 for bf16, persistent: a grid of as many CTAs as fit on the card
// at once (two per SM at llama-1b), CTA c taking work items c,
// c + gridDim.x, ... and
// skipping those whose rows see no key of their span. Warp kConsumerWarps
// is the producer: one lane issues the TMA boxes of the live items' K/V
// tiles into the ring, running ahead across items, the warp loading each
// span's table entries together. Warps 0..HB*RT-1 are consumers, warp w
// holding row tile w % RT of kv head kv0 + w / RT of every item; they walk
// the same items and load an item's q before they wait for its first tile.
// Rows are numbered r = position-in-item * g + head-in-group, as in the f32
// kernel, and the partial layout is the same, with m in the log2 domain.
// kNT: 8-column tiles of the head dim (d <= 8 * kNT). kQ8: int8 pools (the
// header's int8 design): lane 0 loads each tile's rows by TMA (all lanes by
// cp.async where d % 16 != 0) and every producer lane copies scales by
// cp.async, so a full barrier takes one arrival per producer lane plus the
// expect-tx arrival where the TMA loads; the consumers build bf16 B
// fragments from the int8 rows in registers. kShare (int8, RT > 1): the RT
// warps of a kv head each build 1 / RT of the tile's fragments and exchange
// them through shared memory.
template <int kNT, bool kQ8, bool kShare>
__global__ void __launch_bounds__(kThreadsB, 2)
    paged_partial_mma_kernel(__grid_constant__ const CUtensorMap k_map,
                             __grid_constant__ const CUtensorMap v_map,
                             const __nv_bfloat16* __restrict__ q,
                             const int* __restrict__ tables,
                             const int* __restrict__ per_seq, float* part,
                             Geo gm, Q8Pools q8) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const int n_items = gm.n_split * ((gm.C + gm.qpos - 1) / gm.qpos) *
                      (gm.n_kv / gm.HB) * gm.B;
  const int consumers = gm.HB * gm.RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = gm.d;
  const int stages = kQ8 ? gm.stages : kStages;
  const int ring = stages * gm.stage_bytes;
  const int half = kQ8 ? (kTile / gm.box_pos) * gm.slot  // K, then V
                       : gm.stage_bytes / 2;

  const uint32_t bar0 = base + ring;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (stages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // int8: the TMA's expect-tx arrival (where it loads the rows) and one
      // cp.async arrival per producer lane.
      mbar_init(full(s), kQ8 ? 32 + gm.q8_tma : 1);
      mbar_init(empty(s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zero the ring: rows and columns a tile does not load then hold finite
  // values.
  for (int o = 16 * threadIdx.x; o < ring; o += 16 * kThreadsB)
    *reinterpret_cast<uint4*>(smem + o) = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  int g = 0;  // tiles of this CTA so far (the ring's stage and phase)
  if (warp == kConsumerWarps) {
    if (lane == 0 && (!kQ8 || gm.q8_tma)) {
      prefetch_map(&k_map);
      prefetch_map(&v_map);
    }
    const uint32_t box_bytes =
        gm.box_pos * gm.HB * (kQ8 ? gm.dr : kRowBytes);
    const int tile_boxes = kTile / gm.box_pos;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const Item w = item_at(it, gm, per_seq);
      if (w.n_tiles == 0) continue;
      int blk[kMaxBoxes / 32];
      span_blocks(blk, w, tables + (size_t)w.b * gm.W, gm, lane);
      for (int t = 0; t < w.n_tiles; ++t) {
        const int s = g % stages, use = g / stages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        ++g;
        const int t0 = w.k_begin + t * kTile;
        const uint32_t st = base + s * gm.stage_bytes;
        if (kQ8 && !gm.q8_tma) {
          copy_rows_q8(st, w, t0, blk, gm, q8, lane);
        } else {
          const int boxes = (min(kTile, w.k_end - t0) + gm.box_pos - 1) /
                            gm.box_pos;
          if (lane == 0)
            mbar_expect_tx(full(s), 2 * (kQ8 ? 1 : gm.n_panels) * boxes *
                                        box_bytes);
          for (int j = 0; j < boxes; ++j) {
            const int bx = t * tile_boxes + j;  // box of the span
            const int mine = bx < 32   ? blk[0]
                             : bx < 64 ? blk[1]
                             : bx < 96 ? blk[2]
                                       : blk[3];
            const int e = __shfl_sync(0xffffffffu, mine, bx & 31);
            if (lane == 0) {
              const int p0 = (t0 + j * gm.box_pos) % gm.bs;
              const uint32_t dst = st + j * gm.slot;
              if (kQ8) {
                tma_load_4d(dst, &k_map, full(s), 0, p0, w.kv0, e);
                tma_load_4d(dst + half, &v_map, full(s), 0, p0, w.kv0, e);
              } else {
                for (int pn = 0; pn < gm.n_panels; ++pn) {
                  tma_load_4d(dst + pn * gm.panel_bytes, &k_map, full(s),
                              pn * kPanelCols, p0, w.kv0, e);
                  tma_load_4d(dst + half + pn * gm.panel_bytes, &v_map,
                              full(s), pn * kPanelCols, p0, w.kv0, e);
                }
              }
            }
          }
        }
        if (kQ8) {
          copy_scales_q8(st + 2 * half, w, t0, blk, gm, q8, lane);
          cp_async_arrive(full(s));
        }
      }
    }
    if (kQ8) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (warp >= consumers) return;

  // Consumer: 16 query rows of kv head kv0 + hl of each item. Fragment
  // rows of this thread: gid and gid + 8 of the tile; columns 2 tig,
  // 2 tig + 1 of each 8-column accumulator tile.
  const int hl = warp / gm.RT, rt = warp % gm.RT;
  const int gid = lane >> 2, tig = lane & 3;
  const int nt = d / 8;
  // ldmatrix: lane supplies the address of row lane % 8 of matrix lane / 8.
  // bf16: K matrices: keys 8 (mi >> 1) + 0..7, columns 16 ks + 8 (mi & 1) +
  // 0..7; V matrices (transposed): keys 8 (mi & 1) + 0..7, columns
  // 16 np + 8 (mi >> 1) + 0..7. The 16-byte chunk c of a row sits at chunk
  // c ^ (row & 7) (the 128-byte swizzle; slots are 1024-byte aligned).
  // int8: V matrices (transposed, the bytes read as b16 pairs): keys
  // 8 (mi & 1) + 0..7, bytes 32 G + 16 (mi >> 1) + 0..15; K rows are read
  // by each lane itself, keys gid and 8 + gid. Chunks swizzled alike where
  // the TMA swizzles (q8_swz).
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t k_row = kQ8 ? 0u : row_offset(gm, 8 * (mi >> 1) + mr, hl);
  const uint32_t v_row = kQ8 ? row_q8(gm, 8 * (mi & 1) + mr, hl)
                             : row_offset(gm, 8 * (mi & 1) + mr, hl);
  const uint32_t panel = gm.panel_bytes;
  const uint32_t k_swz = (k_row >> 7) & 7;
  const uint32_t v_swz = (v_row >> 7) & (kQ8 ? gm.q8_swz : 7);
  // int8: lane (gid, tig)'s K bytes are kSeg of each of its keys' rows from
  // byte kSeg * tig: word ks of them, codes of d = kSeg tig + 4 ks + 0..3,
  // is the B fragment (b0: 0, 1; b1: 2, 3) of k step ks; q's A fragments
  // take the same d (q8_column).
  constexpr int kSeg = 2 * kNT;
  uint32_t kq_row[2] = {0u, 0u}, kq_swz[2] = {0u, 0u};
  if (kQ8) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kq_row[j] = row_q8(gm, 8 * j + gid, hl);
      kq_swz[j] = (kq_row[j] >> 7) & gm.q8_swz;
    }
  }
  const uint32_t xch_head =
      base + ring + kBarBytes + hl * kNT * kXchGroupBytes + lane * 16;
  const uint32_t xch_buf = gm.HB * kNT * kXchGroupBytes;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item w = item_at(it, gm, per_seq);
    if (w.n_tiles == 0) continue;
    const int kv = w.kv0 + hl;
    int lim[2];
    bool row_ok[2];
    size_t row_idx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = rt * 16 + gid + 8 * i;
      const int pos = w.i0 + rr / gm.g;
      row_ok[i] = rr < gm.R && pos < gm.C;
      const int bound = gm.causal ? w.seq + pos + 1 : w.seq;
      lim[i] = row_ok[i] ? max(w.k_begin, min(bound, w.k_end)) : w.k_begin;
      row_idx[i] = ((size_t)w.b * gm.C + pos) * gm.H + kv * gm.g + rr % gm.g;
    }
    // qs = q * d^-0.5 rounded to bf16, as A fragments: register x of k
    // step ks is row gid + 8 (x & 1), columns 16 ks + 8 (x >> 1) + 2 tig,
    // + 1 (int8: kSeg tig + 4 ks + 2 (x >> 1), + 1).
    uint32_t qa[kNT / 2][4];
#pragma unroll
    for (int ks = 0; ks < kNT / 2; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = x & 1;
        const int col = kQ8 ? kSeg * tig + 4 * ks + 2 * (x >> 1)
                            : 16 * ks + 8 * (x >> 1) + 2 * tig;
        float lo = 0.f, hi = 0.f;
        if (row_ok[i] && col < d) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              q + row_idx[i] * d + col);
          lo = __bfloat162float(v.x) * gm.scale;
          hi = __bfloat162float(v.y) * gm.scale;
        }
        qa[ks][x] = pack_bf16(lo, hi);
      }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int t = 0; t < w.n_tiles; ++t, ++g) {
      const int s = g % stages;
      mbar_wait(full(s), (g / stages) & 1);
      const int t0 = w.k_begin + t * kTile;
      const uint32_t kst = base + s * gm.stage_bytes, vst = kst + half;

      // int8, each warp alone: the raw K codes (kraw[j][ks]: key 8 j + gid)
      // and the keys' scales into registers; V's ldmatrix registers (vraw)
      // at the P.V product, after which the stage is free.
      // int8, kShare: this warp's share of the fragments (k steps and V
      // column groups G equal to rt modulo RT) into the exchange, then the
      // stage is free; after the consumers' barrier each warp reads them all.
      uint32_t kraw[2][kNT / 2];
      uint32_t vraw[4];
      float sk[2], sv[4];
      const uint32_t xch = xch_head + (g & 1) * xch_buf;
      if (kQ8) {
        const uint32_t scl = kst + 2 * half;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sk[j] = __uint_as_float(lds32(scl + 4 * (hl * kTile + 8 * j + gid)));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = __uint_as_float(lds32(
              scl + 4 * ((gm.HB + hl) * kTile + 2 * tig + (j & 1) +
                         8 * (j >> 1))));
        if (!kShare) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int u = 0; u < kNT / 8; ++u) {
              const int c = (kNT / 8) * tig + u;
              const uint4 v =
                  16 * c < gm.dr
                      ? lds128(kst + kq_row[j] + ((c ^ kq_swz[j]) << 4))
                      : make_uint4(0u, 0u, 0u, 0u);
              kraw[j][4 * u] = v.x;
              kraw[j][4 * u + 1] = v.y;
              kraw[j][4 * u + 2] = v.z;
              kraw[j][4 * u + 3] = v.w;
            }
        } else {
          for (int ks = rt; ks < kNT / 2; ks += gm.RT) {
            const int b = kSeg * tig + 4 * ks;
            uint32_t wd[2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wd[j] = b < gm.dr ? lds32(kst + kq_row[j] +
                                        (((b >> 4) ^ kq_swz[j]) << 4) +
                                        (b & 15))
                                : 0u;
            const uint2 f0 = dq4(wd[0], sk[0]), f1 = dq4(wd[1], sk[1]);
            sts128(xch + ks * kXchGroupBytes,
                   make_uint4(f0.x, f0.y, f1.x, f1.y));
          }
          for (int G = rt; G < kNT / 4 && 32 * G < gm.dr; G += gm.RT) {
            const int c0 = 2 * G + (mi >> 1);
            const int c = 16 * c0 < gm.dr ? c0 : 0;
            uint32_t r[4];
            ldmatrix_x4_trans(r, vst + v_row + ((c ^ v_swz) << 4));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint2 lo = dq4_keys(r[2 * h], sv[0], sv[1]);
              const uint2 hi = dq4_keys(r[2 * h + 1], sv[2], sv[3]);
              sts128(xch + (kNT / 2 + 2 * G + h) * kXchGroupBytes,
                     make_uint4(lo.x, hi.x, lo.y, hi.y));
            }
          }
        }
        if (kShare) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(s));
          consumers_sync(32 * consumers);
        }
      }

      // S = qs K^T: score tile j covers keys 8 j .. 8 j + 7 of the tile;
      // bf16: ldmatrix registers 0, 1 are tile 0's B fragment, 2, 3 tile 1's.
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kNT / 2; ++ks) {
        if (kQ8 || 16 * ks < d) {
          uint32_t kb[4];
          if (!kQ8) {
            const int pn = ks >> 2, chunk = 2 * (ks & 3) + (mi & 1);
            ldmatrix_x4(kb, kst + pn * panel + k_row +
                                ((chunk ^ k_swz) << 4));
          } else if (!kShare) {
            const uint2 f0 = dq4(kraw[0][ks], sk[0]);
            const uint2 f1 = dq4(kraw[1][ks], sk[1]);
            kb[0] = f0.x; kb[1] = f0.y; kb[2] = f1.x; kb[3] = f1.y;
          } else {
            const uint4 f = lds128(xch + ks * kXchGroupBytes);
            kb[0] = f.x; kb[1] = f.y; kb[2] = f.z; kb[3] = f.w;
          }
          mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
          mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
        }
      }

      // Online softmax in the log2 domain. Element e of score tile j is
      // row gid + 8 (e >> 1), key t0 + 8 j + 2 tig + (e & 1).
      float tile_m[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = t0 + 8 * j + 2 * tig + (e & 1);
          const float v = key < lim[i] ? sc[j][e] * kLog2e : kNegInf;
          sc[j][e] = v;
          tile_m[i] = fmaxf(tile_m[i], v);
        }
      float corr[2], row_sum[2] = {0.f, 0.f};
      bool rescale = false;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tile_m[i] =
            fmaxf(tile_m[i], __shfl_xor_sync(0xffffffffu, tile_m[i], 1));
        tile_m[i] =
            fmaxf(tile_m[i], __shfl_xor_sync(0xffffffffu, tile_m[i], 2));
        const float m_new = fmaxf(m[i], tile_m[i]);
        // A row with no visible key yet rescales nothing; a tile that
        // moves no max (a wholly masked one among them) rescales by
        // exactly 1.
        corr[i] = m[i] == kNegInf
                      ? 0.f
                      : (m[i] == m_new ? 1.f : ex2(m[i] - m_new));
        rescale |= m[i] != kNegInf && corr[i] != 1.f;
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = tile_m[i] == kNegInf ? 0.f : ex2(sc[j][e] - m[i]);
          sc[j][e] = p;
          row_sum[i] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + row_sum[i];
      // int8: skip the rescale when no row of the warp moved a max it had
      // (acc times 1, or an acc still 0): the same bits, fewer instructions.
      if (!kQ8 || __any_sync(0xffffffffu, rescale)) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
      }
      // P as the bf16 A fragment of P.V: keys 2 tig.. of tile 0, then of
      // tile 1 (8 + 2 tig..), rows gid and gid + 8.
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};

      // O += P V. bf16: ldmatrix registers 0, 1 are the B fragment of
      // column tile 2 np, 2, 3 of tile 2 np + 1. int8: accumulator tile
      // 2 c + e holds the columns 16 c + 2 n + e (n its column), c a
      // 16-byte chunk of the rows (q8_output_column): lane gid's B fragment
      // is column 16 c + 2 gid + e of the chunk's ldmatrix registers.
      if (!kQ8) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          if (2 * np < nt) {
            const int pn = np >> 2, chunk = 2 * (np & 3) + (mi >> 1);
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vst + pn * panel + v_row +
                                      ((chunk ^ v_swz) << 4));
            mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
            mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      } else {
#pragma unroll
        for (int c = 0; c < kNT / 2; ++c) {
          if (16 * c < gm.dr) {
            uint32_t vb[4];
            if (!kShare) {
              if ((c & 1) == 0) {
                const int c1 = 16 * (c + (mi >> 1)) < gm.dr ? c + (mi >> 1)
                                                           : 0;
                ldmatrix_x4_trans(vraw, vst + v_row + ((c1 ^ v_swz) << 4));
              }
              const uint2 lo = dq4_keys(vraw[2 * (c & 1)], sv[0], sv[1]);
              const uint2 hi = dq4_keys(vraw[2 * (c & 1) + 1], sv[2], sv[3]);
              vb[0] = lo.x; vb[1] = hi.x; vb[2] = lo.y; vb[3] = hi.y;
            } else {
              const uint4 f = lds128(xch + (kNT / 2 + c) * kXchGroupBytes);
              vb[0] = f.x; vb[1] = f.y; vb[2] = f.z; vb[3] = f.w;
            }
            mma_bf16(acc[2 * c], pa, vb[0], vb[1]);
            mma_bf16(acc[2 * c + 1], pa, vb[2], vb[3]);
          }
        }
        if (!kShare) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(s));
        }
      }
    }

    // (acc, m, l) of each valid row, l summed over the quad.
    const int span = w.k_begin / gm.split;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (!row_ok[i]) continue;
      float* out = part + (row_idx[i] * gm.n_split + span) * (d + 2);
      if (!kQ8) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          if (n < nt)
            *reinterpret_cast<float2*>(out + 8 * n + 2 * tig) =
                make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      } else {
#pragma unroll
        for (int c = 0; c < kNT / 2; ++c)
          if (16 * c + 4 * tig < d) {
            float* o = out + 16 * c + 4 * tig;
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[2 * c][2 * i], acc[2 * c + 1][2 * i]);
            *reinterpret_cast<float2*>(o + 2) =
                make_float2(acc[2 * c][2 * i + 1], acc[2 * c + 1][2 * i + 1]);
          }
      }
      if (tig == 0) {
        out[d] = m[i];
        out[d + 1] = l[i];
      }
    }
  }
}

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

// One layer's pool [nb, bs, n_kv, d] as a rank-4 tensor map over (d,
// position in block, kv head, block), boxes of (64 columns, box_pos
// positions, HB heads, one block), 128-byte swizzled; columns past d load
// as zeros. An int8 pool (q8): boxes of whole rows (d bytes, d % 16 == 0),
// 128-byte swizzled where d = 128.
cudaError_t make_pool_map(CUtensorMap* map, const void* pool, const Geo& gm,
                          bool q8) {
  EncodeTiled encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t elt = q8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)gm.d, (cuuint64_t)gm.bs,
                              (cuuint64_t)gm.n_kv, (cuuint64_t)gm.nb};
  const cuuint64_t strides[3] = {(cuuint64_t)gm.n_kv * gm.d * elt,
                                 (cuuint64_t)gm.d * elt,
                                 (cuuint64_t)gm.bs * gm.n_kv * gm.d * elt};
  const cuuint32_t box[4] = {q8 ? (cuuint32_t)gm.d : (cuuint32_t)kPanelCols,
                             (cuuint32_t)gm.box_pos, (cuuint32_t)gm.HB, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(pool), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      q8 && !gm.q8_swz ? CU_TENSOR_MAP_SWIZZLE_NONE
                       : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The ring, its barriers, the int8 fragment exchange, and the slack of the
// 1024-byte alignment.
int smem_bytes(const Geo& gm) {
  return gm.stages * gm.stage_bytes + kBarBytes + gm.xch_bytes + 1024;
}
constexpr int kMaxSmemBytes = kStages * kMaxStageBytes + kBarBytes + 1024;

template <int kNT, bool kQ8, bool kShare>
cudaError_t launch_partial(const CUtensorMap (&maps)[2], const Q8Pools& q8,
                           const void* q, const int* tables,
                           const int* per_seq, float* part, const Geo& gm,
                           int n_items, cudaStream_t stream) {
  static int n_sm = 0;  // once per instantiation and process
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(paged_partial_mma_kernel<kNT, kQ8, kShare>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmemBytes);
    if (err != cudaSuccess) {
      n_sm = 0;
      return err;
    }
  }
  // CTAs resident at once: two per SM where their shared memory fits
  // (the SM's 228 KB, 1 KB reserved per CTA), else one.
  const int smem = smem_bytes(gm);
  const int per_sm = 2 * (smem + 1024) <= 233472 ? 2 : 1;
  paged_partial_mma_kernel<kNT, kQ8, kShare>
      <<<min(n_items, per_sm * n_sm), kThreadsB, smem, stream>>>(
          maps[0], maps[1], static_cast<const __nv_bfloat16*>(q), tables,
          per_seq, part, gm, q8);
  return cudaGetLastError();
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The work items and ring of a bf16 call over [b, C, H, d] queries and a
// pool of bf16 or (q8) int8 rows; false if the split is not one the kernel
// takes.
bool make_geo(Geo& gm, int b, int C, int W, int H, int n_kv, int d, int nb,
              int bs, int split_keys, int causal, float scale, bool q8) {
  gm.B = b; gm.C = C; gm.W = W; gm.H = H; gm.n_kv = n_kv; gm.d = d;
  gm.nb = nb; gm.bs = bs; gm.split = split_keys; gm.causal = causal;
  gm.scale = scale;
  gm.n_split = (W * bs + split_keys - 1) / split_keys;
  gm.g = H / n_kv;
  gm.qpos = max(1, min(C, kChunkRows / gm.g));
  gm.R = gm.qpos * gm.g;
  gm.RT = (gm.R + 15) / 16;
  gm.n_panels = (d + kPanelCols - 1) / kPanelCols;
  gm.HB = 1;
  for (int hb = n_kv; hb > 1; --hb)
    if (n_kv % hb == 0 && hb * gm.RT <= kConsumerWarps &&
        hb * gm.n_panels <= kMaxHeadPanels) {
      gm.HB = hb;
      break;
    }
  gm.box_pos = gcd(bs, kTile);
  if (split_keys % kTile != 0 || split_keys / gm.box_pos > kMaxBoxes)
    return false;
  gm.slot = (gm.box_pos * gm.HB * kRowBytes + 1023) / 1024 * 1024;
  gm.panel_bytes = kTile / gm.box_pos * gm.slot;
  set_ring(gm, q8);
  return gm.stages >= 2;
}

template <int kNT>
cudaError_t launch_q8(const CUtensorMap (&maps)[2], const Q8Pools& q8,
                      const void* q, const int* tables, const int* per_seq,
                      float* part, const Geo& gm, int n_items,
                      cudaStream_t stream) {
  if (gm.RT > 1)
    return launch_partial<kNT, true, true>(maps, q8, q, tables, per_seq,
                                           part, gm, n_items, stream);
  return launch_partial<kNT, true, false>(maps, q8, q, tables, per_seq, part,
                                          gm, n_items, stream);
}

// Pass 1 for bf16 over [b, C, H, d] queries; returns the launch error.
// With scales (ks, vs non-null) k and v are int8 pools.
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs,
                        const int* tables, const int* per_seq, float* part,
                        int b, int C, int W, int H, int n_kv, int d, int nb,
                        int bs, int split_keys, int causal, float scale,
                        cudaStream_t stream) {
  const bool q8 = ks != nullptr;
  Geo gm;
  if (!make_geo(gm, b, C, W, H, n_kv, d, nb, bs, split_keys, causal, scale,
                q8))
    return cudaErrorInvalidValue;
  const int n_items =
      gm.n_split * ((C + gm.qpos - 1) / gm.qpos) * (n_kv / gm.HB) * b;
  CUtensorMap maps[2] = {};
  if (!q8 || gm.q8_tma) {
    cudaError_t err = make_pool_map(&maps[0], k, gm, q8);
    if (err == cudaSuccess) err = make_pool_map(&maps[1], v, gm, q8);
    if (err != cudaSuccess) return err;
  }
  if (q8) {
    const Q8Pools pools = {static_cast<const int8_t*>(k),
                           static_cast<const int8_t*>(v), ks, vs};
    if (d <= 64)
      return launch_q8<8>(maps, pools, q, tables, per_seq, part, gm, n_items,
                          stream);
    return launch_q8<16>(maps, pools, q, tables, per_seq, part, gm, n_items,
                         stream);
  }
  const Q8Pools none = {nullptr, nullptr, nullptr, nullptr};
  if (d <= 64)
    return launch_partial<8, false, false>(maps, none, q, tables, per_seq,
                                           part, gm, n_items, stream);
  return launch_partial<16, false, false>(maps, none, q, tables, per_seq,
                                          part, gm, n_items, stream);
}

}  // namespace hopper

namespace {

bool bad_geometry(int H, int n_kv, int d, int W, int nb, int bs) {
  return d <= 0 || d > kMaxD || d % 8 != 0 || n_kv <= 0 || H % n_kv != 0 ||
         H / n_kv > kMaxRows || W <= 0 || nb <= 0 || bs <= 0;
}

// Both passes over [b, C, H, d] queries: split-K partials, then the
// combine. part holds b * C * H * n_split * (d + 2) floats. With scales
// (ks, vs non-null) k and v are int8 pools.
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* tables, const void* per_seq,
             void* part, void* out, int dtype, int b, int C, int W, int H,
             int n_kv, int d, int nb, int bs, int split_keys, int causal,
             float scale, void* stream) {
  if (bad_geometry(H, n_kv, d, W, nb, bs) || b <= 0 || C <= 0 ||
      split_keys <= 0 || split_keys % kTileK != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(per_seq);
  float* p = static_cast<float*>(part);
  const int n_split = (W * bs + split_keys - 1) / split_keys;
  const unsigned rows = (unsigned)((size_t)b * C * H);
  const float* kscale = static_cast<const float*>(ks);
  const float* vscale = static_cast<const float*>(vs);
  cudaError_t err;
  if (dtype == 0) {
    const int g = H / n_kv;
    const int qpos = C == 1 ? 1 : kMaxRows / g;
    const dim3 grid(n_split, (C + qpos - 1) / qpos, b * n_kv);
    const size_t smem = smem_bytes(qpos * g, d);
    if (kscale != nullptr)
      paged_partial_kernel<int8_t><<<grid, kThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const int8_t*>(k),
          static_cast<const int8_t*>(v), kscale, vscale, t, ps, p, C, W, H,
          n_kv, d, nb, bs, qpos, split_keys, causal, scale);
    else
      paged_partial_kernel<float><<<grid, kThreads, smem, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), nullptr, nullptr, t, ps, p, C, W, H,
          n_kv, d, nb, bs, qpos, split_keys, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    paged_combine_kernel<float, false><<<rows, kThreads, 0, st>>>(
        p, static_cast<float*>(out), ps, C, H, d, n_split, split_keys,
        W * bs, causal);
  } else {
    err = hopper::launch_bf16(q, k, v, kscale, vscale, t, ps, p, b, C, W, H,
                              n_kv, d, nb, bs, split_keys, causal, scale, st);
    if (err != cudaSuccess) return (int)err;
    paged_combine_kernel<__nv_bfloat16, true><<<rows, kThreads, 0, st>>>(
        p, static_cast<__nv_bfloat16*>(out), ps, C, H, d, n_split,
        split_keys, W * bs, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Decode attention through the block tables. q, out: [B, 1, H, d]; k, v:
// one layer's pool [nb, bs, n_kv, d], of q's type, or int8 with ks, vs its
// f32 scales [nb, bs, n_kv] (null for a pool of q's type); tables [B, W]
// int32; lengths [B] int32 (counting the new token); part: f32 scratch of
// B * H * ceil(W * bs / split_keys) * (d + 2) elements. All contiguous;
// pools 16-byte aligned. dtype (of q) 0 = f32, 1 = bf16.
extern "C" int grove_paged_decode(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* tables, const void* lengths,
                                  void* part, void* out, int dtype, int B,
                                  int W, int H, int n_kv, int d, int nb,
                                  int bs, int split_keys, float scale,
                                  void* stream) {
  return dispatch(q, k, v, ks, vs, tables, lengths, part, out, dtype, B, 1,
                  W, H, n_kv, d, nb, bs, split_keys, 0, scale, stream);
}

// Chunked-prefill attention through the block tables. q, out:
// [b, C, H, d]; k, v, ks, vs: as for grove_paged_decode; tables [b, W]
// int32; offsets [b] int32 (absolute position of each sequence's row 0);
// part: f32 scratch of b * C * H * ceil(W * bs / split_keys) * (d + 2)
// elements. All contiguous; pools 16-byte aligned. dtype 0 = f32,
// 1 = bf16.
extern "C" int grove_paged_chunk(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* tables, const void* offsets,
                                 void* part, void* out, int dtype, int b,
                                 int C, int W, int H, int n_kv, int d, int nb,
                                 int bs, int split_keys, float scale,
                                 void* stream) {
  return dispatch(q, k, v, ks, vs, tables, offsets, part, out, dtype, b, C,
                  W, H, n_kv, d, nb, bs, split_keys, 1, scale, stream);
}

// Per-thread registers, local (spill) bytes, dynamic shared memory per CTA
// and ring stages of a built kernel, into out[4]: which = 0 the partial
// kernel that takes dtype at head dim d (bf16: the d <= 64 or d <= 128
// build) over a pool of q's type (q8 = 0) or an int8 pool (q8 = 1), as a
// decode step of 8 kv heads x 2 query heads at block size 16 runs it;
// which = 2 the same for a chunk of 32 positions (int8: the kShare build);
// which = 1 the combine kernel for dtype.
extern "C" int grove_paged_info(int which, int dtype, int d, int q8,
                                int* out) {
  const void* fn = nullptr;
  int smem = 0, stages = 0;
  if ((which == 0 || which == 2) && dtype == 0) {
    fn = q8 ? reinterpret_cast<const void*>(paged_partial_kernel<int8_t>)
            : reinterpret_cast<const void*>(paged_partial_kernel<float>);
    smem = (int)smem_bytes(kMaxRows, d);
  } else if ((which == 0 || which == 2) && dtype == 1) {
    hopper::Geo gm;
    if (!hopper::make_geo(gm, 1, which == 2 ? 32 : 1, 1, 16, 8, d, 1, 16,
                          128, which == 2, 1.f, q8 != 0))
      return (int)cudaErrorInvalidValue;
    const bool share = q8 && gm.RT > 1;
    using hopper::paged_partial_mma_kernel;
    if (q8 && share)
      fn = d <= 64 ? reinterpret_cast<const void*>(
                         paged_partial_mma_kernel<8, true, true>)
                   : reinterpret_cast<const void*>(
                         paged_partial_mma_kernel<16, true, true>);
    else if (q8)
      fn = d <= 64 ? reinterpret_cast<const void*>(
                         paged_partial_mma_kernel<8, true, false>)
                   : reinterpret_cast<const void*>(
                         paged_partial_mma_kernel<16, true, false>);
    else
      fn = d <= 64 ? reinterpret_cast<const void*>(
                         paged_partial_mma_kernel<8, false, false>)
                   : reinterpret_cast<const void*>(
                         paged_partial_mma_kernel<16, false, false>);
    smem = hopper::smem_bytes(gm);
    stages = gm.stages;
  } else if (which == 1 && dtype == 0) {
    fn = reinterpret_cast<const void*>(paged_combine_kernel<float, false>);
  } else if (which == 1 && dtype == 1) {
    fn = reinterpret_cast<const void*>(
        paged_combine_kernel<__nv_bfloat16, true>);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = stages;
  return 0;
}

extern "C" const char* grove_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
