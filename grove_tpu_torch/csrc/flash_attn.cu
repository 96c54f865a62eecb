// Causal GQA flash attention, forward, for prefill on Hopper (sm_90a).
//
// Replaces grove_tpu/ops/pallas_flash.py::_flash_kernel and computes its
// function:
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/g] * d^-0.5) v[b, j, h/g]
// over j <= i, with g = H / KVH query heads per kv head. The online-softmax
// state (row max m, row sum l, accumulator acc) is f32; masked scores are
// NEG_INF = -1e30 and a tile whose row is wholly masked contributes p = 0
// (the TPU kernel's rules); the output is acc / max(l, 1e-30) rounded once
// to the input type (bf16: by the reciprocal, below). Inputs are read through their [b, s, h, d] strides (no
// head-major transpose); rows and keys past the sequence end are masked
// here, so any sequence length works. Supported: d <= 128, d % 8 == 0.
//
// Two kernels, chosen by dtype in the C entry point:
//
// bfloat16 (the serving path): flash_fwd_bf16_kernel, both products on the
// tensor cores. What bounds it at the serving shape (b=32, s=128, h=16,
// n_kv=8, d=128) is bytes: 50.3 MB at 3.35 TB/s, 15 us, against 2.2 GFLOP
// at 989 TFLOP/s, 2.2 us; at a long prompt (s=2048) it is operations. The
// CUDA-core kernel it replaces lost 14x to the byte bound for four
// reasons, and the design answers each:
//   1. Products in f32 on the CUDA cores. Here S = Q K^T is a wgmma
//      (m64n64k16, bf16 operands from 128-byte-swizzled shared memory, f32
//      accumulators); bf16 x bf16 products are exact in f32, so S differs
//      from the TPU kernel's f32 upcast only in summation order. d^-0.5 *
//      log2(e) scales S in f32 (not q: a bf16 q * scale would add a rounding
//      the TPU kernel's f32 q * scale does not have), and ex2 does the
//      exponentials. The online softmax runs on the accumulator fragments,
//      the row max and sum reducing over the four lanes that share a row;
//      P is rounded to bf16 in registers and is the register A operand of
//      O += P V (m64n128k16, V read from shared memory with the transpose
//      flag for its [k, d] layout), the bf16 P of the JAX package's MXU
//      matmuls. l sums the f32 p.
//   2. No load overlapped compute. All tiles move by TMA: K and V into a
//      four-stage ring with full/empty mbarriers (V's barrier its own, so
//      the score product starts while V is in flight), Q into one of two
//      buffers. The kernel is persistent (one CTA per SM walking its
//      tiles), and one producer thread loads the next tile's Q and K/V
//      while the consumers compute this one; the consumers write each
//      tile's O over its Q buffer and the producer stores it by TMA. A CTA
//      therefore pays the load latency once, not once per tile.
//   3. Tiles staged as f32 (74 KB for one 64-row CTA). Tiles stay bf16:
//      two 32 KB Q/O buffers and 32 KB per ring stage, 192 KB for 128 rows.
//   4. K/V read once per query head. A tile is 128 rows of the flattened
//      (position, head-in-group) axis of one kv head, P = 128 / g whole
//      positions of all g heads (adjacent in [b, s, h, d]), so one K/V
//      tile serves all g heads and two consumer warpgroups of 64 rows. At
//      the serving shape that is 512 tiles of 64 positions x 2 heads on
//      132 CTAs, heavy tiles (late positions, more keys) dealt first.
// Q and O go through rank-5 tensor maps over (d, head-in-group, kv head, s,
// b), K and V through rank-4 maps over (d, kv head, s, b): a box past a
// ragged sequence end or a head dim below the 64-column panel zero-fills on
// load (never reading the next sequence) and is clipped on store. The
// causal mask is applied only on tiles that cross a warpgroup's first row;
// keys past the end lie above every valid row's diagonal. The loop stops at
// the tile's last row (the TPU kernel's pl.when skip). The output is acc
// times the f32 reciprocal of max(l, 1e-30) (within an f32 ulp of the
// quotient) rounded once. Tensor maps are encoded on the host per call
// through cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint (no
// -lcuda), and passed as __grid_constant__ parameters.
//
// float32: flash_fwd_kernel, the f32 CUDA-core kernel (the TPU kernel's
// f32 semantics): one CTA per (64-row q tile, head, batch), four warps of
// kBlockQ / 4 rows, K and V staged in shared memory as f32 (74 KB at
// d = 128, dynamic), scores one key per lane, output four columns per lane,
// probabilities through a per-warp shared tile.
//
// C entry point: grove_flash_attn_fwd, returning cudaGetLastError() after
// the launch (or the error that kept it from launching).

#include <cuda.h>
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

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KVH, int d, const Strides& st,
                       float scale, cudaStream_t stream) {
  static bool smem_raised = false;  // once per process
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const size_t smem = smem_bytes(d);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KVH, d, st,
      scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA.

namespace hopper {

constexpr int kBlockM = 128;         // q rows per tile: 64 per warpgroup
constexpr int kBlockN = 64;          // keys per k tile
constexpr int kStages = 4;           // K/V ring depth
constexpr int kWarpgroups = 2;       // consumer warpgroups
constexpr int kPanelCols = 64;       // bf16 columns in one 128-byte row
constexpr int kPanelBytes = 64 * 128;        // 64 rows x 128 bytes
constexpr int kTileBytes = 2 * kPanelBytes;  // 64 rows x 128 bf16 columns
constexpr int kQPanelBytes = kBlockM * 128;  // 128 rows x 128 bytes
constexpr int kQBufBytes = 2 * kQPanelBytes;
constexpr int kQOff = 0;                     // two Q (and O) buffers
constexpr int kKOff = kQOff + 2 * kQBufBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kBarOff = kVOff + kStages * kTileBytes;
constexpr int kNumBars = 3 * kStages + 4;
constexpr int kSmemBytes = kBarOff + 8 * kNumBars + 1024;  // + alignment
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreadsH = kConsumers + 32;  // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// How a call's rows are cut into tiles. The rows of a kv head are its
// (position, head-in-group) pairs, adjacent in [b, s, h, d]; a tile holds
// P whole positions of Gb heads of one group (P * Gb <= kBlockM), so one
// box of a rank-5 tensor map over (d, head-in-group, kv head, s, b) is its
// Q or O. Gb = g and P = kBlockM / g up to g = kBlockM; past that a
// position's heads split into blocks of kBlockM.
struct Geom {
  int S, G, Gb, P, n_pb, n_jb, KVH, n_tiles;
};

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

// Shared-memory matrix descriptor for a 128-byte-swizzled operand. For a
// K-major operand (Q, K) `lbo` is unused and `sbo` is the 8-row stride;
// for an MN-major one (V) `lbo` is the stride between 64-column panels and
// `sbo` the 8-row stride along K.
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

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B
// MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Start S = Q K^T for one k tile, 16 head-dim columns per step (not waited
// on; the caller fences). Q and K are K-major, 128-byte swizzled, in
// 64-column panels of kQPanelBytes and kPanelBytes bytes.
template <int kPanels>
__device__ __forceinline__ void start_scores(float (&sc)[32], uint32_t q_tile,
                                             uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < 4 * kPanels; ++ks) {
    const uint32_t col = (ks & 3) * 32;
    wgmma_m64n64k16_ss(
        sc, sw128_desc(q_tile + (ks >> 2) * kQPanelBytes + col, 16, 1024),
        sw128_desc(k_tile + (ks >> 2) * kPanelBytes + col, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// Start O += P V for one k tile, 16 keys per step (not waited on; the
// caller fences). P (bf16) is the register A operand, whose fragment for
// keys 16kk..16kk+15 is score columns 2kk, 2kk+1; V is MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void start_pv(float (&acc)[64],
                                         const uint32_t (&pa)[kBlockN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_m64n128k16_rs(acc, pa[kk],
                        sw128_desc(v_tile + kk * 16 * 128, kPanelBytes, 1024));
  wgmma_commit();
}

// Online softmax of one k tile's scores (keys k0..k0+63) on the fragments,
// in the log2 domain: element 4j + 2i + c of sc is row i (row_pos[i]),
// key k0 + 8j + col0 + c. Updates the row max m and this thread's share of
// the row sum l (of the f32 p), and returns the factor for the earlier
// accumulator in corr and the probabilities as bf16 A fragments in pa.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[32], int k0, bool masked, const int (&row_pos)[2], int col0,
    float scale_log2, float (&m)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&pa)[kBlockN / 16][4]) {
  float tile_m[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        float t = sc[e] * scale_log2;
        if (masked && k0 + 8 * j + col0 + c > row_pos[i]) t = kNegInf;
        sc[e] = t;
        tile_m[i] = fmaxf(tile_m[i], t);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tile_m[i] = fmaxf(tile_m[i], __shfl_xor_sync(0xffffffffu, tile_m[i], 1));
    tile_m[i] = fmaxf(tile_m[i], __shfl_xor_sync(0xffffffffu, tile_m[i], 2));
    const float m_new = fmaxf(m[i], tile_m[i]);
    corr[i] = (m[i] == kNegInf) ? 0.f : ex2(m[i] - m_new);
    m[i] = m_new;
  }
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float p = (tile_m[i] == kNegInf) ? 0.f : ex2(sc[e] - m[i]);
        sc[e] = p;
        row_sum[i] += p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + row_sum[i];
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

struct Tile {
  int p0, jb, kvh, b, n_kt;  // first position, head block, kv head, batch
};

// Tile `it` of this CTA, or n_kt = 0 past the last. Tiles are numbered
// heavy first (late positions, more k tiles) and dealt to the CTAs in
// snake order (0..n-1, then n-1..0, ...), which evens out their work.
__device__ __forceinline__ Tile tile_at(int it, const Geom& gm) {
  const int n = gridDim.x;
  const int t = it * n + ((it & 1) ? n - 1 - blockIdx.x : blockIdx.x);
  Tile w;
  w.n_kt = 0;
  if (t >= gm.n_tiles) return w;
  const int per_pb = gm.n_tiles / gm.n_pb;
  int rest = t % per_pb;
  w.p0 = (gm.n_pb - 1 - t / per_pb) * gm.P;
  w.jb = rest % gm.n_jb;
  rest /= gm.n_jb;
  w.kvh = rest % gm.KVH;
  w.b = rest / gm.KVH;
  const int last_pos = min(w.p0 + gm.P, gm.S) - 1;
  w.n_kt = last_pos / kBlockN + 1;  // k tiles up to the tile's last row
  return w;
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Persistent: each CTA walks its tiles. Warps 0-7 are two consumer
// warpgroups of 64 rows each; warp 8 is the producer. Its lane 0 loads
// each tile's Q by TMA into one of two buffers and keeps the K/V ring
// filled, a tile ahead of the consumers; the consumers leave each tile's
// O in its Q buffer and the producer stores it by TMA before that buffer
// takes the next Q. kPanels 64-column panels of the head dim: 1 for
// d <= 64, else 2.
template <int kPanels>
__global__ void __launch_bounds__(kThreadsH, 1)
flash_fwd_bf16_kernel(__grid_constant__ const CUtensorMap q_map,
                      __grid_constant__ const CUtensorMap k_map,
                      __grid_constant__ const CUtensorMap v_map,
                      __grid_constant__ const CUtensorMap o_map, Geom gm,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar0 = base + kBarOff;
  auto full_k = [&](int s) { return bar0 + 8 * s; };
  auto full_v = [&](int s) { return bar0 + 8 * (kStages + s); };
  auto empty = [&](int s) { return bar0 + 8 * (2 * kStages + s); };
  auto q_full = [&](int i) { return bar0 + 8 * (3 * kStages + i); };
  auto o_full = [&](int i) { return bar0 + 8 * (3 * kStages + 2 + i); };
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(o_full(i), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread.
    if (lane != 0) return;
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    prefetch_map(&o_map);
    const uint32_t q_bytes = kPanels * 128 * gm.P * gm.Gb;
    constexpr uint32_t kv_bytes = kPanels * kPanelBytes;
    // Store the O of tile `it` (if this CTA has one) from its buffer.
    auto store_o = [&](int it) {
      const Tile w = tile_at(it, gm);
      if (w.n_kt == 0) return;
      const int qi = it & 1;
      mbar_wait(o_full(qi), (it >> 1) & 1);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_store_5d(&o_map, base + kQOff + qi * kQBufBytes +
                                 p * kQPanelBytes,
                     p * kPanelCols, w.jb * gm.Gb, w.kvh, w.p0, w.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    };
    int g = 0;  // k tiles requested so far
    int it = 0;
    for (;; ++it) {
      const Tile w = tile_at(it, gm);
      if (w.n_kt == 0) break;
      const int qi = it & 1;
      if (it >= 2) {
        // The buffer's O (tile it - 2) must be stored, and read out of
        // shared memory, before this tile's Q overwrites it.
        store_o(it - 2);
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_expect_tx(q_full(qi), q_bytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load_5d(base + kQOff + qi * kQBufBytes + p * kQPanelBytes,
                    &q_map, q_full(qi), p * kPanelCols, w.jb * gm.Gb, w.kvh,
                    w.p0, w.b);
      for (int kt = 0; kt < w.n_kt; ++kt, ++g) {
        const int s = g % kStages;
        const int use = g / kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const int k0 = kt * kBlockN;
        mbar_expect_tx(full_k(s), kv_bytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(base + kKOff + s * kTileBytes + p * kPanelBytes,
                      &k_map, full_k(s), p * kPanelCols, w.kvh, k0, w.b);
        mbar_expect_tx(full_v(s), kv_bytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(base + kVOff + s * kTileBytes + p * kPanelBytes,
                      &v_map, full_v(s), p * kPanelCols, w.kvh, k0, w.b);
      }
    }
    if (it >= 2) store_o(it - 2);
    if (it >= 1) store_o(it - 1);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // Consumer warpgroup `wg`: rows 64 wg .. 64 wg + 63 of each tile.
  const int wg = warp >> 2;
  const int wl = warp & 3;  // warp within the warpgroup
  // Accumulator fragment: element 4j + 2i + c of a thread is row
  // 16 wl + lane / 4 + 8 i of the warpgroup's 64, column 8 j + col0 + c.
  const int col0 = 2 * (lane & 3);
  int g = 0;  // k tiles consumed so far
  for (int it = 0;; ++it) {
    const Tile w = tile_at(it, gm);
    if (w.n_kt == 0) break;
    const int first_pos = w.p0 + (64 * wg) / gm.Gb;
    int row_pos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      row_pos[i] = w.p0 + (64 * wg + 16 * wl + (lane >> 2) + 8 * i) / gm.Gb;
    const int qi = it & 1;
    const uint32_t q_buf = base + kQOff + qi * kQBufBytes;
    const uint32_t q_tile = q_buf + wg * kPanelBytes;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    mbar_wait(q_full(qi), (it >> 1) & 1);

    for (int kt = 0; kt < w.n_kt; ++kt, ++g) {
      const int s = g % kStages;
      const uint32_t parity = (g / kStages) & 1;
      const int k0 = kt * kBlockN;
      float sc[32];
      float corr[2];
      uint32_t pa[kBlockN / 16][4];
      mbar_wait(full_k(s), parity);
      fence_regs(sc);
      wgmma_fence();
      start_scores<kPanels>(sc, q_tile, base + kKOff + s * kTileBytes);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, k0, k0 + kBlockN - 1 > first_pos, row_pos, col0,
                   scale_log2, m, l, corr, pa);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] *= corr[i];
          acc[4 * j + 2 * i + 1] *= corr[i];
        }
      mbar_wait(full_v(s), parity);
      fence_regs(acc);
      wgmma_fence();
      start_pv(acc, pa, base + kVOff + s * kTileBytes);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

    // Epilogue: acc times 1 / max(l, 1e-30), rounded once, written over
    // the warpgroup's Q rows (its products are done) in the same swizzled
    // layout; the producer stores the tile by TMA.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    uint8_t* const o_buf = smem + (q_buf - base);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 64 * wg + 16 * wl + (lane >> 2) + 8 * i;  // tile row
#pragma unroll
      for (int j = 0; j < 8 * kPanels; ++j)
        *reinterpret_cast<uint32_t*>(o_buf + (j >> 3) * kQPanelBytes +
                                     r * 128 + (((j & 7) ^ (r & 7)) << 4) +
                                     2 * col0) =
            pack_bf16(acc[4 * j + 2 * i] * inv[i],
                      acc[4 * j + 2 * i + 1] * inv[i]);
    }
    // The store reads O through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(o_full(qi));
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

// A bf16 tensor map of `rank` dims (innermost first, element strides of
// dims 1.. in `strides`), 128-byte swizzled boxes of 64 columns, zero
// outside the tensor on loads and clipped on stores.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rank,
                     const long long* dims, const long long* strides,
                     const int* box) {
  EncodeTiled encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    bdim[i] = (cuuint32_t)box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      gdim, gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kPanels>
cudaError_t launch(const CUtensorMap (&maps)[4], const Geom& gm,
                   float scale, cudaStream_t stream) {
  static int n_sm = 0;  // once per instantiation and process
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<kPanels>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) {
      n_sm = 0;
      return err;
    }
  }
  flash_fwd_bf16_kernel<kPanels>
      <<<min(gm.n_tiles, n_sm), kThreadsH, kSmemBytes, stream>>>(
          maps[0], maps[1], maps[2], maps[3], gm, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KVH, int d,
                        const Strides& st, float scale, cudaStream_t stream) {
  Geom gm;
  gm.S = S;
  gm.G = H / KVH;
  gm.Gb = min(gm.G, kBlockM);
  gm.P = kBlockM / gm.Gb;
  gm.n_pb = (S + gm.P - 1) / gm.P;
  gm.n_jb = (gm.G + gm.Gb - 1) / gm.Gb;
  gm.KVH = KVH;
  gm.n_tiles = gm.n_pb * gm.n_jb * KVH * B;
  // q and o as (d, head-in-group, kv head, s, b); k and v as (d, kv head,
  // s, b).
  const long long qo_dims[5] = {d, gm.G, KVH, S, B};
  const int qo_box[5] = {kPanelCols, gm.Gb, 1, gm.P, 1};
  const long long kv_dims[4] = {d, KVH, S, B};
  const int kv_box[4] = {kPanelCols, 1, kBlockN, 1};
  const long long q_str[4] = {st.qh, st.qh * gm.G, st.qs, st.qb};
  const long long o_str[4] = {st.oh, st.oh * gm.G, st.os, st.ob};
  const long long k_str[3] = {st.kh, st.ks, st.kb};
  const long long v_str[3] = {st.vh, st.vs, st.vb};
  CUtensorMap maps[4];
  cudaError_t err = make_map(&maps[0], q, 5, qo_dims, q_str, qo_box);
  if (err == cudaSuccess)
    err = make_map(&maps[1], k, 4, kv_dims, k_str, kv_box);
  if (err == cudaSuccess)
    err = make_map(&maps[2], v, 4, kv_dims, v_str, kv_box);
  if (err == cudaSuccess)
    err = make_map(&maps[3], o, 5, qo_dims, o_str, qo_box);
  if (err != cudaSuccess) return err;
  if (d <= kPanelCols) return launch<1>(maps, gm, scale, stream);
  return launch<2>(maps, gm, scale, stream);
}

}  // namespace hopper

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
    return (int)launch_f32(q, k, v, o, B, S, H, KVH, d, st, scale, s);
  if (dtype == 1)
    return (int)hopper::launch_bf16(q, k, v, o, B, S, H, KVH, d, st, scale,
                                    s);
  return (int)cudaErrorInvalidValue;
}

// Per-thread registers, local (spill) bytes and the dynamic shared memory
// of the kernel a launch with this dtype and head dim takes, into out[3].
extern "C" int grove_flash_attn_info(int dtype, int d, int* out) {
  cudaFuncAttributes attr;
  const void* fn = nullptr;
  int smem = 0;
  if (dtype == 0) {
    fn = reinterpret_cast<const void*>(flash_fwd_kernel<float>);
    smem = (int)smem_bytes(d);
  } else if (dtype == 1) {
    fn = d <= hopper::kPanelCols
             ? reinterpret_cast<const void*>(hopper::flash_fwd_bf16_kernel<1>)
             : reinterpret_cast<const void*>(
                   hopper::flash_fwd_bf16_kernel<2>);
    smem = hopper::kSmemBytes;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  return 0;
}

extern "C" const char* grove_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
