"""The int8-weight projection (W8A16 GEMM): a CUDA kernel for Hopper and its
plain PyTorch version.

With int8 weights (``quant="int8"``, serving/quant.py) every matmul weight
is an int8 tensor with one bf16 scale per output column. The JAX package
reads it through ``_w`` (``grove_tpu/models/llama.py:157``):
``QTensor.materialize`` (``grove_tpu/serving/quant.py:42``), the product
``q * scale`` rounded to bf16, then the einsum, and XLA fuses the upcast
and the scale into the matmul's operand read, so the weight crosses device
memory as int8. ``w8a16_matmul_ref`` is that function in PyTorch: the
materialized weight (one rounding of ``f32(q) * f32(scale)`` to bf16),
then the product at JAX's promoted type (bf16 for the layer projections of
a bf16 model, f32 for the LM head's ``preferred_element_type=f32`` and for
an f32 model). ``w8a16_matmul`` runs the kernel
(``grove_tpu_torch/csrc/w8a16_gemm.cu``) on CUDA tensors, which forms the
same bf16 weight in shared memory and never writes it to device memory,
and the plain version on CPU tensors. ``launches`` on the wrapper counts
its launches.

Shapes: x [M, K], the weight [K, N] as stored (the JAX layout: ``wq`` is
[d, h * hd], ``wo`` [h * hd, d], ``lm_head`` [d, V]; none is transposed),
its scales [N]. The kernel takes K % 64 == 0 and N % 16 == 0.
``w8a16_matmul_group`` multiplies one x by up to three such weights in one
launch (``wq``/``wk``/``wv``; ``w_gate``/``w_up``), each read and written as
stored, no concatenated copy made.

Row invariance. For every M up to ``ROW_INVARIANT_M`` (256: decode, the
prefill chunk, the lanes decode and the verify chunk of speculative
decoding) the partition of K (``split_count``: the split count and the
64-deep k-step), the order of the k-steps and the order of the split sum
depend on K and the launch's weights only, so an output row's bits depend
only on its own input row and never on M. Above 256 (the lanes prefill, M = 4,096) the kernel
takes 128 x 128 tiles and no split, and a row's bits may differ from the
same row's at M <= 256 (by the split sum's rounding).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grove_tpu_torch.ops import _build

BK = 64                 # k-step depth; K must be a multiple
SMALL_TILE = (32, 64)   # rows x columns per CTA for M <= ROW_INVARIANT_M
WIDE_TILE = (128, 128)  # above it (bf16 activations)
ROW_INVARIANT_M = 256
FILL_CTAS = 264         # two CTAs per SM of an H100's 132
MIN_SPLIT_STEPS = 2     # k-steps per split at least
MAX_COUNTERS = 4096     # split-K arrival counters per device
MAX_WEIGHTS = 3         # weights sharing x in one launch
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def w8a16_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``x`` [M, K] times the dequantized weight
    (``QTensor.materialize``: ``q`` [K, N] int8 in the scale's type times
    ``scale`` [N]) at the promoted type of x, the weight and ``out_dtype``,
    returned as ``out_dtype``."""
    w = q.to(scale.dtype) * scale
    ct = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                             out_dtype)
    return (x.to(ct) @ w.to(ct)).to(out_dtype)


def column_tiles(ns, bn: int = SMALL_TILE[1]) -> int:
    """Column tiles of a launch over weights of ``ns`` columns each."""
    return sum(-(-n // bn) for n in ns)


def w8a16_matmul_group_ref(x: torch.Tensor, weights,
                           out_dtype: torch.dtype) -> list[torch.Tensor]:
    """Plain version of a grouped call: ``w8a16_matmul_ref`` per weight."""
    return [w8a16_matmul_ref(x, q, s, out_dtype) for q, s in weights]


def split_count(K: int, ns) -> int:
    """How many parts K splits into for M <= ROW_INVARIANT_M: from K and
    the launch's weights (``ns``, their column counts) alone. Enough
    (column tile, split) CTAs to fill the card, with at least
    ``MIN_SPLIT_STEPS`` k-steps each."""
    want = -(-FILL_CTAS // column_tiles(ns))
    return max(1, min(want, (K // BK) // MIN_SPLIT_STEPS))


def partition(M: int, K: int, ns,
              x_dtype: torch.dtype) -> tuple[bool, int, tuple[int, int]]:
    """(wide tile, split count, CTA tile) of a launch over weights of
    ``ns`` columns. f32 activations take the CUDA-core kernel, whose tile is
    the small one at every M."""
    small = M <= ROW_INVARIANT_M
    wide = not small and x_dtype == torch.bfloat16
    return (wide, split_count(K, ns) if small else 1,
            WIDE_TILE if wide else SMALL_TILE)


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("w8a16_gemm")
    fn = lib.grove_w8a16_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.grove_w8a16_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    info = lib.grove_w8a16_info
    info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    info.restype = ctypes.c_int
    return fn, err_str, info


def kernel_info(which: str) -> dict[str, int]:
    """Tile, registers and local (spill) bytes per thread and dynamic shared
    memory per CTA of the built ``small`` or ``wide`` tensor-core kernel or
    the ``fma`` kernel (needs the card)."""
    _, err_str, info = _kernel()
    out = (ctypes.c_int * 5)()
    err = info({"small": 0, "wide": 1, "fma": 2}[which], out)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel info failed: "
                           f"{err_str(err).decode()} ({err})")
    return {"tile": (out[0], out[1]), "registers": out[2],
            "local_bytes": out[3], "smem_bytes": out[4]}


_counters: dict[torch.device, torch.Tensor] = {}


def _counter_buf(device: torch.device) -> torch.Tensor:
    """The split-K arrival counters of ``device``: zeroed once, and every
    launch leaves them zero (the last CTA of a tile resets its own). Made at
    the first split call, which must not be inside a graph capture (the
    engines run each step eagerly before capturing it)."""
    buf = _counters.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the w8a16 split-K counters must exist before "
                               "a CUDA graph capture: run the call once "
                               "eagerly first")
        buf = torch.zeros((MAX_COUNTERS,), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _check(x: torch.Tensor, weights, out_dtype: torch.dtype) -> None:
    """Shapes, types and devices, for both routes."""
    if not 1 <= len(weights) <= MAX_WEIGHTS:
        raise ValueError(f"w8a16 takes 1 to {MAX_WEIGHTS} weights per call, "
                         f"got {len(weights)}")
    if x.dim() != 2:
        raise ValueError("x must be [M, K], the int8 weight [K, N] and its "
                         "scales [N]")
    for q, scale in weights:
        if q.dim() != 2 or scale.dim() != 1:
            raise ValueError("x must be [M, K], the int8 weight [K, N] and "
                             "its scales [N]")
        if x.shape[1] != q.shape[0] or scale.shape[0] != q.shape[1]:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, weight "
                             f"{tuple(q.shape)}, scales "
                             f"{tuple(scale.shape)}")
        if q.dtype != torch.int8 or scale.dtype != torch.bfloat16:
            raise ValueError(f"the weight must be int8 with bfloat16 scales, "
                             f"got {q.dtype}, {scale.dtype}")
    if x.dtype not in _X_CODES or out_dtype not in _OUT_CODES or (
            x.dtype == torch.float32 and out_dtype != torch.float32):
        raise ValueError(f"w8a16 takes bfloat16 activations with a bfloat16 "
                         f"or float32 output, or float32 activations with a "
                         f"float32 output; got {x.dtype} -> {out_dtype}")
    devs = {t.device for w in weights for t in w} | {x.device}
    if len(devs) != 1:
        raise ValueError(f"w8a16 inputs span devices {devs}")


def _launch(x, weights, out_dtype) -> list[torch.Tensor]:
    M, K = x.shape
    ns = [q.shape[1] for q, _ in weights]
    if K % BK or any(n % 16 for n in ns):
        raise ValueError(f"the w8a16 kernel takes K % {BK} == 0 and N % 16 "
                         f"== 0, got K={K}, N={ns}")
    for q, scale in weights:
        if not (q.is_contiguous() and scale.is_contiguous()):
            raise ValueError("the w8a16 kernel reads a contiguous weight and "
                             "scales (it never copies them)")
        if q.data_ptr() % 16 or scale.data_ptr() % 16:
            raise ValueError("the int8 weight and its scales must start "
                             "16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: rows load by 16 bytes
        x = x.clone()
    outs = [torch.empty((M, n), dtype=out_dtype, device=x.device)
            for n in ns]
    wide, split, (bm, bn) = partition(M, K, ns, x.dtype)
    part = counters = None
    if split > 1:
        tiles = -(-M // bm) * column_tiles(ns, bn)
        if tiles > MAX_COUNTERS:
            raise ValueError(f"{tiles} split tiles exceed the {MAX_COUNTERS} "
                             f"counters")
        counters = _counter_buf(x.device)
        part = torch.empty((tiles * split * bm * bn,), dtype=torch.float32,
                           device=x.device)
    count = len(weights)
    ptrs = ctypes.c_void_p * count
    fn, err_str, _ = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), ptrs(*(q.data_ptr() for q, _ in weights)),
                 ptrs(*(s.data_ptr() for _, s in weights)),
                 ptrs(*(o.data_ptr() for o in outs)),
                 (ctypes.c_int * count)(*ns), count,
                 None if part is None else part.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 _X_CODES[x.dtype], _OUT_CODES[out_dtype], int(wide), M, K,
                 split, stream)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    return outs


def w8a16_matmul_group(x: torch.Tensor, weights,
                       out_dtype: torch.dtype | None = None
                       ) -> list[torch.Tensor]:
    """``x`` [M, K] times each int8 weight of ``weights`` (1 to 3 pairs of
    ``q`` [K, N_i] with bf16 ``scale`` [N_i]), as ``out_dtype`` (default:
    x's type promoted with the scales', as JAX's einsum promotes): one
    output [M, N_i] per weight.

    CUDA tensors run the hand-written kernel, one launch for all of them;
    CPU tensors run ``w8a16_matmul_ref`` on each. Anything else raises, on
    either route: mixed devices, other types, and on the card a shape the
    kernel does not take."""
    weights = list(weights)
    if out_dtype is None and weights:
        out_dtype = torch.promote_types(x.dtype, weights[0][1].dtype)
    _check(x, weights, out_dtype)
    if x.device.type == "cpu":
        return w8a16_matmul_group_ref(x, weights, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16 runs on cuda or cpu tensors, not "
                         f"{x.device}")
    if x.shape[0] == 0:
        return [torch.empty((0, q.shape[1]), dtype=out_dtype,
                            device=x.device) for q, _ in weights]
    outs = _launch(x, weights, out_dtype)
    w8a16_matmul.launches += 1
    return outs


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [M, K] times the int8 weight ``q`` [K, N] with bf16 ``scale``
    [N] per column, as ``out_dtype``: ``w8a16_matmul_group`` of one weight.
    ``launches`` counts the kernel launches of both."""
    return w8a16_matmul_group(x, [(q, scale)], out_dtype)[0]


w8a16_matmul.launches = 0
