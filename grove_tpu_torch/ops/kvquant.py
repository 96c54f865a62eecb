"""The paged KV cache's writes: the quantizing scatter of an int8 pool and
the plain scatter of a model-dtype pool, CUDA kernels for Hopper and their
plain PyTorch versions.

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
null-block routing (``scatter_slots``); ``paged_scatter_q`` runs the kernel
(``grove_tpu_torch/csrc/kv_quant.cu``) on CUDA tensors, one launch for K and
V of a layer, and the plain version on CPU tensors. The two agree bit for
bit: a row's codes and scale depend only on that row.

A model-dtype pool takes the rows as they are: the JAX package's
``_paged_scatter`` (``grove_tpu/models/llama.py:482``), whose plain version
here is ``paged_scatter_ref`` (an index computation and one ``index_copy_``
per pool); ``paged_scatter`` runs the same file's copy kernel on CUDA
tensors, one launch for K and V of a layer, bitwise the plain version's
result (it is a copy). ``launches`` on each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grove_tpu_torch.ops import _build

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


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("kv_quant")
    fn = lib.grove_kv_scatter_q
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plain = lib.grove_kv_scatter
    plain.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    plain.restype = ctypes.c_int
    err_str = lib.grove_kv_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, plain, err_str


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


def _check(k_pool, v_pool, k_scale, v_scale, k, v, tables, positions, valid):
    _check_rows(k_pool, v_pool, k, v, tables, positions, valid)
    nb, bs, n_kv, d = k_pool.shape
    if tuple(k_scale.shape) != (nb, bs, n_kv) or \
            v_scale.shape != k_scale.shape:
        raise ValueError(f"scales must be [{nb}, {bs}, {n_kv}], got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or \
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("int8 pools with float32 scales expected")


def _launch(k_pool, v_pool, k_scale, v_scale, k, v, tables, positions,
            valid) -> None:
    if k.dtype not in _DTYPE_CODES:
        raise ValueError(f"the scatter kernel takes float32 or bfloat16 rows, "
                         f"not {k.dtype}")
    nb, bs, n_kv, d = k_pool.shape
    if d > MAX_HEAD_DIM or d % 4 != 0:
        raise ValueError(f"the scatter kernel needs head_dim <= "
                         f"{MAX_HEAD_DIM} and head_dim % 4 == 0, got {d}")
    pools = (k_pool, v_pool, k_scale, v_scale)
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("the scatter kernel writes contiguous pools")
    if any(t.data_ptr() % 4 for t in pools):
        raise ValueError("the pools must start 4-byte aligned")
    devs = {t.device for t in (*pools, k, v, tables, positions)}
    if len(devs) != 1:
        raise ValueError(f"scatter inputs span devices {devs}")
    k, v = k.contiguous(), v.contiguous()
    if k.data_ptr() % 16:
        k = k.clone()
    if v.data_ptr() % 16:
        v = v.clone()
    tables = tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    b, s = k.shape[:2]
    fn, _, err_str = _kernel()
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = fn(k.data_ptr(), v.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                 tables.data_ptr(), positions.data_ptr(),
                 valid.data_ptr() if valid is not None else None,
                 _DTYPE_CODES[k.dtype], b, s, tables.shape[1], n_kv, d, nb,
                 bs, stream)
    if err != 0:
        raise RuntimeError(f"kv scatter kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")


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

    CUDA tensors run the hand-written kernel (one launch for K and V); CPU
    tensors run ``paged_scatter_q_ref`` on each pool. Anything else
    raises."""
    _check(k_pool, v_pool, k_scale, v_scale, k, v, tables, positions, valid)
    tensors = (k_pool, v_pool, k_scale, v_scale, k, v, tables, positions)
    if all(t.device.type == "cpu" for t in tensors):
        paged_scatter_q_ref(k_pool, k_scale, k, tables, positions, valid)
        paged_scatter_q_ref(v_pool, v_scale, v, tables, positions, valid)
        return
    if k.device.type != "cuda":
        raise ValueError(f"the scatter runs on cuda or cpu tensors, not "
                         f"{k.device}")
    _launch(k_pool, v_pool, k_scale, v_scale, k, v, tables, positions, valid)
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

    CUDA tensors run the hand-written kernel (one launch for K and V); CPU
    tensors run ``paged_scatter_ref`` on each pool. Anything else raises."""
    _check_rows(k_pool, v_pool, k, v, tables, positions, valid)
    if k_pool.dtype not in _DTYPE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"the scatter writes float32 or bfloat16 pools of "
                         f"one type, not {k_pool.dtype}, {v_pool.dtype}")
    tensors = (k_pool, v_pool, k, v, tables, positions)
    if all(t.device.type == "cpu" for t in tensors):
        paged_scatter_ref(k_pool, k, tables, positions, valid)
        paged_scatter_ref(v_pool, v, tables, positions, valid)
        return
    if k.device.type != "cuda":
        raise ValueError(f"the scatter runs on cuda or cpu tensors, not "
                         f"{k.device}")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"scatter inputs span devices {devs}")
    nb, bs, n_kv, d = k_pool.shape
    row_bytes = n_kv * d * k_pool.element_size()
    if row_bytes % 16:
        raise ValueError(f"the scatter kernel copies 16-byte chunks: a row "
                         f"of {row_bytes} bytes does not divide")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or \
            k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the scatter kernel writes contiguous pools that "
                         "start 16-byte aligned")
    rows = []
    for x in (k, v):
        x = x.to(k_pool.dtype).contiguous()
        rows.append(x.clone() if x.data_ptr() % 16 else x)
    tables = tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    b, s = k.shape[:2]
    _, plain, err_str = _kernel()
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = plain(rows[0].data_ptr(), rows[1].data_ptr(),
                    k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
                    positions.data_ptr(),
                    valid.data_ptr() if valid is not None else None, b, s,
                    tables.shape[1], row_bytes, nb, bs, stream)
    if err != 0:
        raise RuntimeError(f"kv scatter kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    paged_scatter.launches += 1


paged_scatter_q.launches = 0
paged_scatter.launches = 0
