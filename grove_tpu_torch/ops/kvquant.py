"""The paged KV cache's write: one layer's rope and its K/V rows scattered
through the block tables into the layer's pools, as one CUDA kernel for
Hopper, and its plain PyTorch version.

The paged model functions rotate q and k (``apply_rope``, ops/rope.py) and
write k and v into the pools; ``paged_rope_scatter`` (a pool of the model's
type) and ``paged_rope_scatter_q`` (an int8 pool) do both in one launch
(``grove_tpu_torch/csrc/kv_quant.cu``) on CUDA tensors and return the
roped q; on CPU tensors they run ``paged_rope_scatter_ref``: ``apply_rope``
on q and on k, then ``paged_scatter_ref`` or ``paged_scatter_q_ref`` on
each pool. The kernel rounds every product and sum of the rope to f32 on
its own, as PyTorch's elementwise kernels do, and quantizes k after its
rounding to the rows' type, so the two agree bit for bit.
``paged_scatter`` and ``paged_scatter_q`` are the same kernel with rope off
(the write alone).

With ``GROVE_KV_QUANT=int8`` the paged pools hold int8 rows and a per-(slot,
kv head) f32 scale beside them (serving/kvcache.py). Per slot, not per
block: a decode step writes one row of a block at a time and cannot see the
block's other rows. The JAX package quantizes in ``_paged_scatter_q``
(``grove_tpu/models/llama.py:525``, an XLA composition):
``scale = max(amax, 1e-8) / 127`` over the head dim, ``code =
clip(round_half_even(x / scale), -127, 127)``, in f32. XLA folds the
division by the constant 127 into a product with its f32 reciprocal, so
that is what the port computes; ``x / scale`` stays an IEEE division.
``paged_scatter_q_ref`` is that function in PyTorch, with the port's
null-block routing (``scatter_slots``). A row's codes and scale depend only
on that row.

A model-dtype pool takes the rows as they are: the JAX package's
``_paged_scatter`` (``grove_tpu/models/llama.py:482``), whose plain version
here is ``paged_scatter_ref`` (an index computation and one ``index_copy_``
per pool). ``launches`` on each wrapper counts its launches. Each wrapper
raises on rows that require grad (``ops/_grad.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops._grad import refuse_grad
from grove_tpu_torch.ops.rope import apply_rope

KV_SCALE_EPS = 1e-8
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scatter_slots(tables: torch.Tensor, positions: torch.Tensor, bs: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Flat pool slots (int64, ``[b * s]``) of token ``positions`` [b, s]
    through the block ``tables`` [b, w]: ``table[p // bs] * bs + p % bs``.

    A position past the table's width lands in the null block, at slot
    ``positions % bs``: that is where the JAX package's write goes, since
    its ``take_along_axis`` fills an out-of-range column with the int32
    minimum, which times an even block size wraps to block 0 (its scatter
    drops the write for an odd one). ``valid`` [b, s] bool, when given,
    reroutes masked-out rows to the same null-block slot: without it a
    padded chunk tail past the table's backed capacity would write into a
    live block. Rerouted rows are the only ones that can share a slot, and
    only inside the null block, so an order-undefined duplicate write on
    CUDA lands nowhere live."""
    w = tables.shape[1]
    col = torch.div(positions, bs, rounding_mode="floor")
    block = torch.gather(tables, 1, col.clamp(0, w - 1).to(torch.long))
    slot = positions % bs
    flat = block.to(positions.dtype) * bs + slot
    keep = col < w if valid is None else (col < w) & valid
    return torch.where(keep, flat, slot).reshape(-1).to(torch.long)


def paged_scatter_ref(cache_blocks: torch.Tensor, kv: torch.Tensor,
                      tables: torch.Tensor, positions: torch.Tensor,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version for one pool: write ``kv`` [b, s, n_kv, d] at token
    ``positions`` [b, s] through the block tables [b, w] (one flat index
    write into ``cache_blocks`` [nb, bs, n_kv, d], in place; returns it).
    Positions in a table's padding resolve to the null block; positions past
    the table's width, and rows that ``valid`` [b, s] masks out, land in the
    null block at slot ``positions % bs`` (``scatter_slots`` says why)."""
    nb, bs = cache_blocks.shape[0], cache_blocks.shape[1]
    flat = cache_blocks.view((nb * bs,) + tuple(cache_blocks.shape[2:]))
    flat.index_copy_(0, scatter_slots(tables, positions, bs, valid),
                     kv.reshape((-1,) + tuple(kv.shape[2:])).to(flat.dtype))
    return cache_blocks


def quantize_rows(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``kv`` [..., d] -> (int8 codes [..., d], f32 scales [...]): absmax /
    127 per row, round half to even, clip to +-127, as the JAX package's
    ``_paged_scatter_q`` computes it under XLA: the scale is the f32
    product with f32(1 / 127) (XLA's folding of a division by a
    constant; an IEEE division rounds some scales one ulp apart), the
    codes an IEEE division by the scale."""
    f = kv.to(torch.float32)
    amax = torch.clamp_min(f.abs().amax(dim=-1), KV_SCALE_EPS)
    scale = amax * (1.0 / 127.0)
    q = torch.round(f / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def paged_scatter_q_ref(pool: torch.Tensor, scales: torch.Tensor,
                        kv: torch.Tensor, tables: torch.Tensor,
                        positions: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version for one pool: quantize ``kv`` [b, s, n_kv, d] and write
    its codes into ``pool`` [nb, bs, n_kv, d] int8 and its scales into
    ``scales`` [nb, bs, n_kv] f32 at the slots of ``scatter_slots``, in
    place (returns ``pool``)."""
    nb, bs, n_kv, d = pool.shape
    idx = scatter_slots(tables, positions, bs, valid)
    q, scale = quantize_rows(kv)
    pool.view(nb * bs, n_kv, d).index_copy_(0, idx, q.reshape(-1, n_kv, d))
    scales.view(nb * bs, n_kv).index_copy_(0, idx, scale.reshape(-1, n_kv))
    return pool


def paged_rope_scatter_ref(k_pool: torch.Tensor, v_pool: torch.Tensor,
                           k_scale: torch.Tensor | None,
                           v_scale: torch.Tensor | None, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           tables: torch.Tensor, positions: torch.Tensor,
                           valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the fused write: ``apply_rope`` on ``q`` and on
    ``k``, then ``paged_scatter_ref`` of k and v into the pools of the
    model's type (``k_scale`` None) or ``paged_scatter_q_ref`` into the
    int8 pools and their scales. Returns the roped q."""
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if k_scale is None:
        paged_scatter_ref(k_pool, k, tables, positions, valid)
        paged_scatter_ref(v_pool, v, tables, positions, valid)
    else:
        paged_scatter_q_ref(k_pool, k_scale, k, tables, positions, valid)
        paged_scatter_q_ref(v_pool, v_scale, v, tables, positions, valid)
    return q


class _Args(ctypes.Structure):
    """``RopeScatterArgs`` of csrc/kv_quant.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "q_out", "kpool", "vpool", "kscale", "vscale", "cos",
        "sin", "tables", "positions", "valid")]
        + [("rows", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("s", "w", "n_q", "n_kv", "d", "nb",
                                        "bs", "max_len")])


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("kv_quant")
    fn = lib.grove_rope_scatter
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = lib.grove_rope_scatter_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info.restype = ctypes.c_int
    err_str = lib.grove_kv_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, info, err_str


def kernel_info(dtype: torch.dtype, int8_pool: bool) -> dict:
    """Registers and local (spill) bytes per thread of one build of the
    write kernel (needs the card)."""
    _, info, err_str = _kernel()
    out = (ctypes.c_int * 2)()
    err = info(_DTYPE_CODES[dtype], int(int8_pool), out)
    if err != 0:
        raise RuntimeError(f"kv write kernel info failed: "
                           f"{err_str(err).decode()} ({err})")
    return {"registers": out[0], "local_bytes": out[1]}


def _check_rows(k_pool, v_pool, k, v, tables, positions, valid) -> None:
    if k_pool.dim() != 4 or k.dim() != 4 or tables.dim() != 2:
        raise ValueError("pools must be [nb, bs, n_kv, d], rows [b, s, n_kv, "
                         "d] and tables [b, w]")
    nb, bs, n_kv, d = k_pool.shape
    if v_pool.shape != k_pool.shape or tuple(k.shape[2:]) != (n_kv, d) or \
            v.shape != k.shape:
        raise ValueError(f"shape mismatch: pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}; rows {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s = k.shape[:2]
    if tables.shape[0] != b or tuple(positions.shape) != (b, s) or (
            valid is not None and tuple(valid.shape) != (b, s)):
        raise ValueError(f"tables {tuple(tables.shape)}, positions "
                         f"{tuple(positions.shape)} do not match rows "
                         f"[{b}, {s}]")


def _check_scales(k_pool, v_pool, k_scale, v_scale) -> None:
    nb, bs, n_kv, d = k_pool.shape
    if tuple(k_scale.shape) != (nb, bs, n_kv) or \
            v_scale.shape != k_scale.shape:
        raise ValueError(f"scales must be [{nb}, {bs}, {n_kv}], got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or \
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("int8 pools with float32 scales expected")


def _check_rope(q, k, v, cos, sin) -> None:
    if q.dim() != 4 or tuple(q.shape[:2]) != tuple(k.shape[:2]) or \
            q.shape[3] != k.shape[3]:
        raise ValueError(f"q must be [b, s, h, d] beside k "
                         f"{tuple(k.shape)}, got {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k and v must share one type, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    half = q.shape[3] // 2
    if cos.dim() != 2 or cos.shape[1] != half or sin.shape != cos.shape or \
            cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError(f"rope tables must be float32 [max_len, {half}], "
                         f"got {tuple(cos.shape)} {cos.dtype}, "
                         f"{tuple(sin.shape)} {sin.dtype}")


def _route(tensors, valid) -> bool:
    """True for the kernel (CUDA tensors on one device), False for the
    plain version (all on the CPU); raises otherwise."""
    devs = {t.device for t in (*tensors, *([] if valid is None else [valid]))}
    if all(d.type == "cpu" for d in devs):
        return False
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"the kv write runs on cuda or cpu tensors, not "
                         f"{sorted(map(str, devs))}")
    if len(devs) != 1:
        raise ValueError(f"kv write inputs span devices {devs}")
    return True


_plans: dict[tuple, tuple] = {}
MAX_PLANS = 64


def _make_plan(k_pool, v_pool, k_scale, v_scale, q, k, cos, sin) -> tuple:
    """The launch's fixed part: an ``_Args`` with the pools, scales, rope
    tables and sizes filled in, the rows' type code and the pool kind.
    Checks everything the kernel needs of them."""
    nb, bs, n_kv, d = k_pool.shape
    if k.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kv write kernel takes float32 or bfloat16 "
                         f"rows, not {k.dtype}")
    if d > MAX_HEAD_DIM or d % 4 != 0:
        raise ValueError(f"the kv write kernel needs head_dim <= "
                         f"{MAX_HEAD_DIM} and head_dim % 4 == 0, got {d}")
    quant = k_scale is not None
    # Each tensor with the alignment of the kernel's widest access to it.
    fixed = [(k_pool, 2 * k_pool.element_size()),
             (v_pool, 2 * v_pool.element_size())]
    fixed += [(k_scale, 4), (v_scale, 4)] if quant else []
    fixed += [(cos, 8), (sin, 8)] if cos is not None else []
    if not all(t.is_contiguous() for t, _ in fixed):
        raise ValueError("the kv write kernel takes contiguous pools, "
                         "scales and rope tables")
    if any(t.data_ptr() % align for t, align in fixed):
        raise ValueError("the pools and rope tables must start aligned to "
                         "two of their elements, the scales to one")
    a = _Args(kpool=k_pool.data_ptr(), vpool=v_pool.data_ptr(),
              n_kv=n_kv, d=d, nb=nb, bs=bs)
    if quant:
        a.kscale, a.vscale = k_scale.data_ptr(), v_scale.data_ptr()
    if cos is not None:
        a.cos, a.sin = cos.data_ptr(), sin.data_ptr()
        a.n_q, a.max_len = q.shape[2], cos.shape[0]
    return a, _DTYPE_CODES[k.dtype], int(quant)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and aligned to two of its elements (the kernel's
    loads), copied only where it is not."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % (2 * x.element_size()) else x


def _launch(k_pool, v_pool, k_scale, v_scale, q, k, v, cos, sin, tables,
            positions, valid) -> torch.Tensor | None:
    """One launch of the write kernel (rope too when ``cos`` is given);
    returns the roped q, or None without rope."""
    key = (k_pool.device, k.dtype) + tuple(
        (t.data_ptr(), t.shape, t.stride(), t.dtype) if t is not None
        else None for t in (k_pool, v_pool, k_scale, v_scale, cos, sin)) + (
        None if q is None else q.shape[2],)
    plan = _plans.get(key)
    if plan is None:
        plan = _make_plan(k_pool, v_pool, k_scale, v_scale, q, k, cos, sin)
        if len(_plans) >= MAX_PLANS:
            _plans.clear()
        _plans[key] = plan
    fixed, dtype, quant = plan
    a = _Args.from_buffer_copy(fixed)
    k, v = _aligned(k), _aligned(v)
    tables = tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    a.k, a.v = k.data_ptr(), v.data_ptr()
    a.tables, a.positions = tables.data_ptr(), positions.data_ptr()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
        a.valid = valid.data_ptr()
    q_out = None
    if q is not None:
        q = _aligned(q)
        q_out = torch.empty_like(q)
        a.q, a.q_out = q.data_ptr(), q_out.data_ptr()
    b, s = k.shape[:2]
    a.rows, a.s, a.w = b * s, s, tables.shape[1]
    fn, _, err_str = _kernel()
    err = fn(ctypes.byref(a), dtype, quant,
             torch._C._cuda_getCurrentRawStream(k.get_device()))
    if err != 0:
        raise RuntimeError(f"kv write kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    return q_out


def paged_rope_scatter(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       tables: torch.Tensor, positions: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rope ``q`` [b, s, h, d] and ``k`` [b, s, n_kv, d] at token
    ``positions`` [b, s] (the f32 tables ``cos``/``sin`` [max_len, d / 2];
    a position past them takes their last row), write the roped k and
    ``v`` into the pools [nb, bs, n_kv, d] of the rows' type in place
    through ``tables`` [b, w] (``valid`` [b, s] bool reroutes rows to the
    null block; see ``scatter_slots``), and return the roped q.

    CUDA tensors run the hand-written kernel (one launch); CPU tensors run
    ``paged_rope_scatter_ref``. Anything else raises, and so does an input
    that requires grad (the kernel has no backward)."""
    refuse_grad("paged_rope_scatter", q, k, v)
    _check_rows(k_pool, v_pool, k, v, tables, positions, valid)
    _check_rope(q, k, v, cos, sin)
    if k_pool.dtype != k.dtype or v_pool.dtype != k.dtype:
        raise ValueError(f"the fused write takes pools of the rows' type "
                         f"{k.dtype}, not {k_pool.dtype}, {v_pool.dtype}")
    if not _route((k_pool, v_pool, q, k, v, cos, sin, tables, positions),
                  valid):
        return paged_rope_scatter_ref(k_pool, v_pool, None, None, q, k, v,
                                      cos, sin, tables, positions, valid)
    q = _launch(k_pool, v_pool, None, None, q, k, v, cos, sin, tables,
                positions, valid)
    paged_rope_scatter.launches += 1
    return q


def paged_rope_scatter_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         tables: torch.Tensor, positions: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """``paged_rope_scatter`` into int8 pools [nb, bs, n_kv, d] and their
    f32 scales [nb, bs, n_kv]: the roped k (rounded to the rows' type
    first) and v are quantized as ``quantize_rows`` does it. Returns the
    roped q."""
    refuse_grad("paged_rope_scatter_q", q, k, v)
    _check_rows(k_pool, v_pool, k, v, tables, positions, valid)
    _check_scales(k_pool, v_pool, k_scale, v_scale)
    _check_rope(q, k, v, cos, sin)
    if not _route((k_pool, v_pool, k_scale, v_scale, q, k, v, cos, sin,
                   tables, positions), valid):
        return paged_rope_scatter_ref(k_pool, v_pool, k_scale, v_scale, q, k,
                                      v, cos, sin, tables, positions, valid)
    q = _launch(k_pool, v_pool, k_scale, v_scale, q, k, v, cos, sin, tables,
                positions, valid)
    paged_rope_scatter_q.launches += 1
    return q


def paged_scatter_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor,
                    valid: torch.Tensor | None = None) -> None:
    """Quantize one layer's new ``k``/``v`` [b, s, n_kv, d] and write them
    into the int8 pools [nb, bs, n_kv, d] and their f32 scales [nb, bs,
    n_kv] in place, at token ``positions`` [b, s] through ``tables`` [b, w]
    (``valid`` [b, s] bool reroutes rows to the null block; see
    ``scatter_slots``).

    CUDA tensors run the write kernel with rope off (one launch for K and
    V); CPU tensors run ``paged_scatter_q_ref`` on each pool. Anything else
    raises."""
    refuse_grad("paged_scatter_q", k, v)
    _check_rows(k_pool, v_pool, k, v, tables, positions, valid)
    _check_scales(k_pool, v_pool, k_scale, v_scale)
    if not _route((k_pool, v_pool, k_scale, v_scale, k, v, tables,
                   positions), valid):
        paged_scatter_q_ref(k_pool, k_scale, k, tables, positions, valid)
        paged_scatter_q_ref(v_pool, v_scale, v, tables, positions, valid)
        return
    _launch(k_pool, v_pool, k_scale, v_scale, None, k, v, None, None, tables,
            positions, valid)
    paged_scatter_q.launches += 1


def paged_scatter(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, tables: torch.Tensor,
                  positions: torch.Tensor,
                  valid: torch.Tensor | None = None) -> None:
    """Write one layer's new ``k``/``v`` [b, s, n_kv, d] into the pools
    [nb, bs, n_kv, d] of the model's type (float32 or bfloat16) in place,
    at token ``positions`` [b, s] through ``tables`` [b, w] (``valid``
    [b, s] bool reroutes rows to the null block; see ``scatter_slots``).
    Rows of another type are cast to the pools' first, as the plain version
    casts them.

    CUDA tensors run the write kernel with rope off (one launch for K and
    V); CPU tensors run ``paged_scatter_ref`` on each pool. Anything else
    raises."""
    refuse_grad("paged_scatter", k, v)
    _check_rows(k_pool, v_pool, k, v, tables, positions, valid)
    if k_pool.dtype not in _DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"the scatter writes float32 or bfloat16 pools of "
                         f"one type, not {k_pool.dtype}, {v_pool.dtype}")
    if not _route((k_pool, v_pool, k, v, tables, positions), valid):
        paged_scatter_ref(k_pool, k, tables, positions, valid)
        paged_scatter_ref(v_pool, v, tables, positions, valid)
        return
    _launch(k_pool, v_pool, None, None, None, k.to(k_pool.dtype),
            v.to(k_pool.dtype), None, None, tables, positions, valid)
    paged_scatter.launches += 1


paged_rope_scatter.launches = 0
paged_rope_scatter_q.launches = 0
paged_scatter_q.launches = 0
paged_scatter.launches = 0
