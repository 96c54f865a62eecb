"""Attention through a paged KV cache's block tables: two CUDA kernels for
Hopper and their plain PyTorch versions.

The JAX package runs no Pallas kernel on its paged path:
``decode_step_paged`` and ``prefill_chunk_paged``
(``grove_tpu/models/llama.py``) gather each layer's block pool into a dense
cache (``_paged_gather``) and hand it to XLA's ``decode_attention`` and
``causal_attention``. Here those two compositions are kernels written by
hand (``grove_tpu_torch/csrc/paged_attn.cu``, built by ``ops/_build.py``,
bound through plain C entry points with ctypes) that follow the table
entries to the pool's rows and never write the gathered cache:

- ``paged_decode_attention(q, k_pool, v_pool, tables, lengths)``: one
  query token per sequence over its first ``lengths`` positions;
- ``paged_chunk_attention(q, k_pool, v_pool, tables, offsets)``: a chunk
  of queries at absolute positions ``offsets[b] + i``, causal.

What bounds them on an H100 is bytes (every live K/V row is read once per
kv head; about one flop per byte at llama-1b). For bfloat16, the serving
type, both products run on the tensor cores (``mma.sync``, f32
accumulation, P rounded to bf16 as the P.V operand) while one producer warp
per CTA streams K/V tiles by TMA, through the block table, into a
three-stage mbarrier ring, so loads overlap compute; the kernel is
persistent, a decode work item holds up to four kv heads of one sequence
and a chunk item all 64 query rows of one kv head. float32 takes a
CUDA-core kernel (32-key tiles staged as f32). Both are split-K over fixed
spans of ``SPLIT_KEYS`` positions from 0, then a combine pass; a
row's numbers depend only on its position, never on the table width or the
chunk's boundaries (and in bf16 a decode row at length p + 1 equals the
chunk row at position p bitwise). The source's header has the details.

int8 pools (``GROVE_KV_QUANT=int8``: int8 rows with a per-(slot, kv head)
f32 scale, ops/kvquant.py) go through ``paged_decode_attention_q8`` and
``paged_chunk_attention_q8``. Their plain versions dequantize the gathered
rows as the JAX package's ``_paged_gather_q`` does (``paged_gather_q``: f32
product, one rounding to the query's type), then attend as above. The
kernels dequantize the same way: in bf16 the producer warp loads the raw
int8 rows by TMA (``cp.async`` where d % 16 != 0) and their scales by
``cp.async`` into a ring as deep as shared memory allows, and the consumers
build the bf16 mma operands from the int8 codes in registers (a chunk's
warps each build a quarter of a tile's and share them), with their own
column maps (``q8_column``, ``q8_output_column``; ``q8_geometry`` mirrors
the ring); f32 dequantizes in its tile loads.

Each wrapper takes its kernel for CUDA tensors and the plain version for
CPU tensors; anything else raises, and so does an input that requires grad
(``ops/_grad.py``: the kernels have no backward). ``launches`` on each
wrapper counts its launches (one per call: the split-K pass and its
combine).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops._grad import refuse_grad
from grove_tpu_torch.ops.attention import causal_attention, decode_attention

MAX_HEAD_DIM = 128
MAX_GROUP = 16       # query heads per kv head the kernels hold per CTA
SPLIT_KEYS = 128     # positions per key span (a multiple of 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gather(cache_blocks: torch.Tensor,
                 tables: torch.Tensor) -> torch.Tensor:
    """Gather a batch's KV sequences out of the block pool.

    cache_blocks: [num_blocks, bs, n_kv, d]; tables: [b, w] int32 ->
    [b, w * bs, n_kv, d] in position order (table order is sequence order).
    Table entries are clamped into the pool, as the JAX gather clamps them;
    padded rows point at the null block and the attention mask discards
    what lives there."""
    b, w = tables.shape
    nb, bs, n_kv, d = cache_blocks.shape
    idx = tables.to(torch.long).clamp(0, nb - 1)
    return cache_blocks[idx].reshape(b, w * bs, n_kv, d)


def paged_gather_q(cache_blocks: torch.Tensor, scales: torch.Tensor,
                   tables: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dequantizing variant of ``paged_gather`` (the JAX package's
    ``_paged_gather_q``): int8 rows [nb, bs, n_kv, d] times their f32
    scales [nb, bs, n_kv], the product rounded once to ``dtype`` ->
    [b, w * bs, n_kv, d]."""
    b, w = tables.shape
    nb, bs, n_kv, d = cache_blocks.shape
    idx = tables.to(torch.long).clamp(0, nb - 1)
    vals = cache_blocks[idx].reshape(b, w * bs, n_kv, d)
    s = scales[idx].reshape(b, w * bs, n_kv)
    return (vals.to(torch.float32) * s[..., None]).to(dtype)


def _gathered(q, k_pool, v_pool, tables, k_scale, v_scale):
    if k_scale is None:
        return paged_gather(k_pool, tables), paged_gather(v_pool, tables)
    return (paged_gather_q(k_pool, k_scale, tables, q.dtype),
            paged_gather_q(v_pool, v_scale, tables, q.dtype))


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, tables: torch.Tensor,
                               lengths: torch.Tensor,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version: ``decode_attention`` over the gathered cache (the JAX
    package's composition in ``decode_step_paged``). q: [b, 1, h, d];
    pools: [nb, bs, n_kv, d]; tables: [b, w]; lengths: [b], counting the
    new token. With ``k_scale``/``v_scale`` [nb, bs, n_kv] the pools are
    int8 and gather through ``paged_gather_q``."""
    k, v = _gathered(q, k_pool, v_pool, tables, k_scale, v_scale)
    return decode_attention(q, k, v, lengths)


def paged_chunk_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, tables: torch.Tensor,
                              offsets: torch.Tensor,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain version: ``causal_attention`` over the gathered cache with a
    per-sequence q offset (``prefill_chunk_paged``'s composition). q:
    [b, c, h, d]; pools: [nb, bs, n_kv, d]; tables: [b, w]; offsets: [b]
    int32, the absolute position of each sequence's row 0. Scales as in
    ``paged_decode_attention_ref``."""
    k, v = _gathered(q, k_pool, v_pool, tables, k_scale, v_scale)
    return causal_attention(q, k, v, q_offset=offsets)


def _check(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           tables: torch.Tensor, per_seq: torch.Tensor, name: str,
           k_scale: torch.Tensor | None = None,
           v_scale: torch.Tensor | None = None) -> None:
    """Shapes and types; with scales, the pools must be int8 and the scales
    float32 [nb, bs, n_kv]."""
    if q.dim() != 4 or k_pool.dim() != 4 or tables.dim() != 2:
        raise ValueError("q must be [b, s, h, d], pools [nb, bs, n_kv, d] "
                         "and tables [b, w]")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != q.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k pool "
                         f"{tuple(k_pool.shape)}, v pool "
                         f"{tuple(v_pool.shape)}")
    if q.shape[2] % k_pool.shape[2] != 0:
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k_pool.shape[2]} kv heads")
    b = q.shape[0]
    if tables.shape[0] != b or tuple(per_seq.shape) != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} and {name} "
                         f"{tuple(per_seq.shape)} do not match a batch of "
                         f"{b}")
    if tables.dtype != torch.int32 or per_seq.dtype != torch.int32:
        raise ValueError(f"tables and {name} must be int32")
    pool_dtype = q.dtype if k_scale is None else torch.int8
    if not (k_pool.dtype == v_pool.dtype == pool_dtype):
        raise ValueError(f"dtype mismatch: q {q.dtype}, pools "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if k_scale is not None:
        want = tuple(k_pool.shape[:3])
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want \
                or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise ValueError(f"scales must be float32 {list(want)}, got "
                             f"{k_scale.dtype} {tuple(k_scale.shape)}, "
                             f"{v_scale.dtype} {tuple(v_scale.shape)}")


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry points and helpers, typed once."""
    lib = _build.load("paged_attn")
    decode = lib.grove_paged_decode
    decode.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    decode.restype = ctypes.c_int
    chunk = lib.grove_paged_chunk
    chunk.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    chunk.restype = ctypes.c_int
    err_str = lib.grove_paged_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    info = lib.grove_paged_info
    info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    info.restype = ctypes.c_int
    return decode, chunk, err_str, info


def kernel_info(which: str, dtype: torch.dtype,
                head_dim: int = MAX_HEAD_DIM,
                int8_pool: bool = False) -> dict[str, int]:
    """Registers and local (spill) bytes per thread, dynamic shared memory
    per CTA and ring stages of a built kernel (needs the card): ``partial``
    (pass 1) as a decode step of llama-1b's heads (8 kv heads x 2) runs it,
    ``partial_chunk`` as a chunk of 32 positions does (over an int8 pool,
    the build whose warps share each tile's fragments), or ``combine``
    (pass 2), for query ``dtype``, ``head_dim`` and a model-dtype or int8
    pool."""
    _, _, err_str, info = _kernel()
    out = (ctypes.c_int * 4)()
    err = info({"partial": 0, "combine": 1, "partial_chunk": 2}[which],
               _DTYPE_CODES[dtype], head_dim, int(int8_pool), out)
    if err != 0:
        raise RuntimeError(f"paged kernel info failed: "
                           f"{err_str(err).decode()} ({err})")
    return {"registers": out[0], "local_bytes": out[1], "smem_bytes": out[2],
            "stages": out[3]}


# ---- the int8 kernel's geometry and fragment maps (csrc/paged_attn.cu) ----

TILE = 16                 # positions per K/V tile (one mma k step)
CONSUMER_WARPS = 4
CHUNK_ROWS = 64           # query rows of one kv head per chunk work item
MAX_STAGES_Q8 = 8
SMEM_PER_CTA = 233472 // 2 - 1024   # two CTAs per SM, 1 KB reserved each
BAR_BYTES = 128


def q8_geometry(c: int, h: int, n_kv: int, d: int, bs: int) -> dict:
    """The bf16 kernel's work item and ring over an int8 pool, as
    ``make_geo`` in csrc/paged_attn.cu computes them for a call of ``c``
    query positions per sequence: kv heads per item (``hb``), 16-row tiles
    per head (``rt``; > 1 is the build whose warps share each tile's
    fragments), positions per TMA box, stage bytes, ring stages, exchange
    bytes, dynamic shared memory and CTAs per SM. ``tma``: rows by TMA
    (d % 16 == 0), else by cp.async; ``swizzle``: 128-byte swizzled rows
    (d = 128)."""
    g = h // n_kv
    qpos = max(1, min(c, CHUNK_ROWS // g))
    rt = -(-qpos * g // 16)
    panels = -(-d // 64)
    hb = next((x for x in range(n_kv, 1, -1) if n_kv % x == 0
               and x * rt <= CONSUMER_WARPS and x * panels <= 8), 1)
    box_pos = math.gcd(bs, TILE)
    dr = -(-d // 16) * 16
    tma = d % 16 == 0
    swizzle = tma and dr == 128
    box = box_pos * hb * dr
    align = 1024 if swizzle else 128
    slot = -(-box // align) * align if tma else box
    stage = -(-(2 * (TILE // box_pos) * slot + 2 * hb * TILE * 4) // 1024)
    stage *= 1024
    nt = 8 if d <= 64 else 16
    xch = 2 * hb * nt * 512 if rt > 1 else 0
    stages = min(MAX_STAGES_Q8, (SMEM_PER_CTA - BAR_BYTES - xch - 1024)
                 // stage)
    smem = stages * stage + BAR_BYTES + xch + 1024
    return {"hb": hb, "rt": rt, "box_pos": box_pos, "tma": tma,
            "swizzle": swizzle, "slot": slot, "stage_bytes": stage,
            "stages": stages, "xch_bytes": xch, "smem_bytes": smem,
            "ctas_per_sm": 2 if 2 * (smem + 1024) <= 233472 else 1}


def q8_column(tig: int, ks: int, j: int, d: int) -> int:
    """The head-dim column that lane 4 gid + tig's score fragments hold
    in k step ``ks``, element ``j`` (0, 1: register b0 of
    K's B fragment and a0 / a1 of q's A fragment; 2, 3: b1 and a2 / a3):
    each lane reads its own 2 * kNT bytes of a key's int8 row, so k step
    ks takes the columns 2 kNT tig + 4 ks + 0..3 of the four lanes. Both
    operands use the map, so a score still sums q[c] k[c] over every c."""
    nt = 8 if d <= 64 else 16
    return 2 * nt * tig + 4 * ks + j


def q8_output_column(c: int, e: int, n: int) -> int:
    """The head-dim column of column ``n`` (0..7) of the int8 kernel's P.V
    accumulator tile 2 c + e: ldmatrix.trans over a 16-byte chunk ``c`` of
    int8 V rows hands lane gid columns 16 c + 2 gid and + 1 of two keys,
    the B fragments of tiles 2 c (e = 0) and 2 c + 1 (e = 1)."""
    return 16 * c + 2 * n + e


def _kernel_args(q, k_pool, v_pool, tables, per_seq, scales):
    """Validate what the kernels take; returns contiguous q, tables and the
    per-sequence vector. The pools (and scales) are never copied: one that
    is not contiguous raises."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged kernels take float32 or bfloat16, not "
                         f"{q.dtype}")
    d = q.shape[3]
    if d > MAX_HEAD_DIM or d % 8 != 0:
        raise ValueError(f"paged kernels need head_dim <= {MAX_HEAD_DIM} "
                         f"and head_dim % 8 == 0, got {d}")
    if q.shape[2] // k_pool.shape[2] > MAX_GROUP:
        raise ValueError(f"paged kernels hold at most {MAX_GROUP} query "
                         f"heads per kv head")
    pools = (k_pool, v_pool, *scales)
    devs = {t.device for t in (q, *pools, tables, per_seq)}
    if len(devs) != 1:
        raise ValueError(f"paged attention inputs span devices {devs}")
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("paged kernels read contiguous pools")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged kernels copy pool rows in 16-byte units: "
                         "the pools must start 16-byte aligned")
    if any(t.data_ptr() % 4 for t in scales):
        raise ValueError("the scales must start 4-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:  # a view at an odd offset: the kernels load pairs
        q = q.clone()
    return q, tables.contiguous(), per_seq.contiguous()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        _, _, err_str, _ = _kernel()
        raise RuntimeError(f"paged {what} kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")


def n_spans(w: int, bs: int) -> int:
    """Key spans of a table ``w`` blocks of ``bs`` positions wide: the
    split-K passes' count, fixed by the width, not by the lengths."""
    return -(-w * bs // SPLIT_KEYS)


def scratch_elems(b: int, c: int, h: int, d: int, w: int, bs: int) -> int:
    """f32 elements of the split-K scratch: (acc[d], m, l) for every query
    row and key span."""
    return b * c * h * n_spans(w, bs) * (d + 2)


def _scratch(q: torch.Tensor, w: int, bs: int) -> torch.Tensor:
    """The split-K partials of every query row: (acc, m, l) per key span."""
    return torch.empty((scratch_elems(*q.shape, w, bs),),
                       dtype=torch.float32, device=q.device)


def _launch(entry: int, q, k_pool, v_pool, tables, per_seq,
            scales=()) -> torch.Tensor:
    """Launch the decode (entry 0) or chunk (entry 1) kernels; ``scales``
    (k_scale, v_scale) for int8 pools."""
    q, tables, per_seq = _kernel_args(q, k_pool, v_pool, tables, per_seq,
                                      scales)
    b, c, h, d = q.shape
    nb, bs, n_kv, _ = k_pool.shape
    w = tables.shape[1]
    part = _scratch(q, w, bs)
    out = torch.empty_like(q)
    fn = _kernel()[entry]
    shape = (b, w, h, n_kv, d, nb, bs) if entry == 0 else \
        (b, c, w, h, n_kv, d, nb, bs)
    ks, vs = (t.data_ptr() for t in scales) if scales else (None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
                 tables.data_ptr(), per_seq.data_ptr(), part.data_ptr(),
                 out.data_ptr(), _DTYPE_CODES[q.dtype], *shape, SPLIT_KEYS,
                 d ** -0.5, stream)
    _raise_on(err, ("decode", "chunk")[entry])
    return out


def _route(q: torch.Tensor, others) -> str:
    if all(t.device.type == "cpu" for t in (q, *others)):
        return "cpu"
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    return "cuda"


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention through block tables. q: [b, 1, h, d]; pools:
    one layer's [nb, bs, n_kv, d]; tables: [b, w] int32; lengths: [b] int32
    (counting the new token; read on the device). Returns [b, 1, h, d].

    CUDA tensors run the hand-written kernel; CPU tensors run
    ``paged_decode_attention_ref``. Anything else raises."""
    refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, tables, lengths, "lengths")
    _one_query(q)
    if _route(q, (k_pool, v_pool, tables, lengths)) == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths)
    out = _launch(0, q, k_pool, v_pool, tables, lengths)
    paged_decode_attention.launches += 1
    return out


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Causal chunk attention through block tables. q: [b, c, h, d]; pools:
    one layer's [nb, bs, n_kv, d]; tables: [b, w] int32; offsets: [b] int32
    (row i of sequence b sits at position offsets[b] + i and sees positions
    <= it). Returns [b, c, h, d].

    CUDA tensors run the hand-written kernel; CPU tensors run
    ``paged_chunk_attention_ref``. Anything else raises."""
    refuse_grad("paged_chunk_attention", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, tables, offsets, "offsets")
    if _route(q, (k_pool, v_pool, tables, offsets)) == "cpu":
        return paged_chunk_attention_ref(q, k_pool, v_pool, tables, offsets)
    out = _launch(1, q, k_pool, v_pool, tables, offsets)
    paged_chunk_attention.launches += 1
    return out


def paged_decode_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention`` over int8 pools [nb, bs, n_kv, d] with
    their f32 scales [nb, bs, n_kv]: K/V dequantize to q's type (f32
    product, one rounding) before attention.

    CUDA tensors run the hand-written kernel; CPU tensors run
    ``paged_decode_attention_ref`` with the scales. Anything else raises."""
    refuse_grad("paged_decode_attention_q8", q, k_scale, v_scale)
    _check(q, k_pool, v_pool, tables, lengths, "lengths", k_scale, v_scale)
    _one_query(q)
    if _route(q, (k_pool, v_pool, k_scale, v_scale, tables,
                  lengths)) == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths,
                                          k_scale, v_scale)
    out = _launch(0, q, k_pool, v_pool, tables, lengths, (k_scale, v_scale))
    paged_decode_attention_q8.launches += 1
    return out


def paged_chunk_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, tables: torch.Tensor,
                             offsets: torch.Tensor) -> torch.Tensor:
    """``paged_chunk_attention`` over int8 pools with their f32 scales (as
    ``paged_decode_attention_q8``).

    CUDA tensors run the hand-written kernel; CPU tensors run
    ``paged_chunk_attention_ref`` with the scales. Anything else raises."""
    refuse_grad("paged_chunk_attention_q8", q, k_scale, v_scale)
    _check(q, k_pool, v_pool, tables, offsets, "offsets", k_scale, v_scale)
    if _route(q, (k_pool, v_pool, k_scale, v_scale, tables,
                  offsets)) == "cpu":
        return paged_chunk_attention_ref(q, k_pool, v_pool, tables, offsets,
                                         k_scale, v_scale)
    out = _launch(1, q, k_pool, v_pool, tables, offsets, (k_scale, v_scale))
    paged_chunk_attention_q8.launches += 1
    return out


def _one_query(q: torch.Tensor) -> None:
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query per sequence, got "
                         f"{q.shape[1]}")


paged_decode_attention.launches = 0
paged_chunk_attention.launches = 0
paged_decode_attention_q8.launches = 0
paged_chunk_attention_q8.launches = 0
