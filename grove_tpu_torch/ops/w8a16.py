"""The projections: the int8-weight GEMM (W8A16) and its dense bf16-weight
build, CUDA kernels for Hopper, and their plain PyTorch versions.

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
same bf16 weight in registers (or, above 256 rows, in shared memory) and
never writes it to device memory, and the plain version on CPU tensors.
``launches`` on the wrapper counts its launches.

Shapes: x [M, K], the weight [K, N] as stored (the JAX layout: ``wq`` is
[d, h * hd], ``wo`` [h * hd, d], ``lm_head`` [d, V]; none is transposed),
its scales [N]. The int8 build takes K % 64 == 0 and N % 16 == 0, the
bf16-weight build K % 8 == 0 and N % 8 == 0.
``w8a16_matmul_group`` multiplies one x by up to three such weights in one
launch (``wq``/``wk``/``wv``; ``w_gate``/``w_up``), each read and written as
stored, no concatenated copy made.

Dense weights. A model served without weight quantization (the engine's
default) multiplies by its bf16 weights as stored: ``dense_matmul_group``
runs the dense kernel on CUDA tensors (``wgmma`` with the weight tile as A,
read as stored, and the tokens as n, 64 per token tile of the launch;
every CTA reads its weight tile once for all the rows it serves,
``dense_geometry``: above 192 rows a column tile runs whole or as two
halves of 128 rows, whichever fills the card's waves; one grouped launch
for QKV and for gate/up, the LM head with an f32 output) and
``dense_matmul_ref`` (``x.to(ct) @ w.to(ct)``, bitwise the model's einsum
on the CPU, which the model keeps there) on CPU tensors. It replaces the
einsum on dense weights (``_w`` + einsum, ``grove_tpu/models/llama.py:157``)
and the LM head's ``preferred_element_type=f32`` product. An f32 model's
dense f32 weights take the CUDA-core kernel. ``dense_matmul.launches``
counts its launches, ``dense_matmul.launches_by_build`` each build's
(``dense1`` .. ``dense4`` by token tiles, ``fma`` for f32).

Row invariance. For every M up to ``ROW_INVARIANT_M`` (256: decode, the
prefill chunk, the lanes decode and the verify chunk of speculative
decoding) the partition of K (``split_count``: the split count and the
64-deep k-step), the order of the k-steps and the order of the split sum
depend on K, the launch's weights and the build only, so an output row's
bits depend only on its own input row and never on M. Above 256 a call
either runs as consecutive slabs of at most 256 rows (``slabs``: one
small-kernel launch each, over row offsets of x and of the one output
buffer), which keeps every row's bits, or (the int8 weights of the lanes
prefill, M = 4,096) takes 128 x 256 ``wgmma`` tiles and no split, whose
rows may differ from the same rows at M <= 256 (by the split sum's
rounding). The dense build always slabs.

Host time. A launch's weight-side arguments (pointers, column counts, the
weights' TMA tensor maps) are a plan, made once and cached by the weights'
pointers, shapes and strides and the launch's types; a call then allocates
one output buffer and makes one foreign call, which also encodes x's map.
No allocation besides the output and no host sync, so a call is safe
inside a CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops._grad import refuse_grad

BK = 64                 # k-step depth; K must be a multiple
SMALL_TILE = (32, 128)  # tokens x weight columns per CTA up to 256 rows
DENSE_N = 64            # tokens per token tile of the dense kernel
DENSE_TILE = (DENSE_N, 128)  # ... x weight columns per CTA, which loops over
# every token tile of the launch
WIDE_TILE = (128, 256)  # above it (bf16 activations)
FMA_TILE = (32, 64)     # f32 activations (the CUDA-core kernel)
ROW_INVARIANT_M = 256
SMS = 132               # streaming multiprocessors of an H100
RESIDENT_CTAS = 3 * SMS  # small-kernel CTAs resident at once (3 per SM)
# ... per build, the split's one constant. The dense kernel runs one CTA per
# SM, and each CTA pays its ring's fill and the cluster epilogue once: on the
# card, llama-1b's launches ran fastest at every M <= 256 with the splits
# that a constant in [64, 128) gives (QKV 2, wo and w_down 4, gate/up and
# the head 1), between 64 and 250 CTAs a launch (PERF.md section 6).
RESIDENT = {"int8": RESIDENT_CTAS, "bf16": 96}
DENSE_RING = 200 * 1024  # the dense kernel's ring, at most (one CTA per SM)
DENSE4_RING = 192 * 1024  # ... and its ring at four token tiles, exactly
MAX_SPLIT = 8           # the split's CTAs are one cluster: 8 is portable
MIN_SPLIT_STEPS = 2     # k-steps per split at least
MAX_WEIGHTS = 3         # weights sharing x in one launch
MAX_PLANS = 4096        # cached launch plans
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BUILD_CODES = {"int8": 0, "bf16": 1, "f32": 2}  # the weight's type
# What each build needs of K and N: int8 whole 64-deep k-steps and 16-column
# scale pairs; bf16 16-byte rows for TMA (a last partial k-step reads
# zeros); f32 nothing.
_MULTIPLES = {"int8": (BK, 16), "bf16": (8, 8), "f32": (1, 1)}
_INFO = {"small": 0, "wide": 1, "fma": 2, "dense1": 3, "dense2": 4,
         "dense3": 5, "dense4": 6}


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


def fragment_column(r: int) -> int:
    """The weight column, within its 16-column mma tile, that row ``r``
    (0..15) of the small kernel's swapped A fragment holds (and that row
    ``r`` of its accumulator belongs to).

    The int8 tile [k][n] is read by ``ldmatrix.trans`` as b16 pairs of
    columns: lane (gid = lane // 4, tig = lane % 4) gets the codes of
    columns 2 gid and 2 gid + 1 at k = 2 tig and 2 tig + 1. A byte permute
    pairs them by column: column 2 gid becomes fragment row gid (A
    registers a0, a2) and column 2 gid + 1 row gid + 8 (a1, a3), the rows
    m16n8k16's A layout gives that lane. ``csrc/w8a16_gemm.cu`` cites this
    map."""
    return 2 * (r % 8) + r // 8


def split_count(K: int, ns, build: str = "int8") -> int:
    """How many parts K splits into for M <= ROW_INVARIANT_M: from K, the
    launch's weights (``ns``, their column counts) and the build (``int8``
    or ``bf16`` weights: its residency) alone, never M. The parts of
    one column tile are one thread-block cluster, which sums them in
    distributed shared memory, each rank owning 128 / split columns of the
    tile: so the split is a power of two up to ``MAX_SPLIT`` (whole
    16-column mma tiles per rank, the portable cluster size). It doubles
    while the doubled (column tile, split) CTAs still fit in one wave
    (``RESIDENT[build]``) and each part keeps at least ``MIN_SPLIT_STEPS``
    k-steps: more CTAs keep more weight bytes in flight per SM."""
    tiles, steps = column_tiles(ns), -(-K // BK)
    split = 1
    while (split < MAX_SPLIT and 2 * split * tiles <= RESIDENT[build]
           and 2 * split * MIN_SPLIT_STEPS <= steps):
        split *= 2
    return split


def partition(M: int, K: int, ns, x_dtype: torch.dtype,
              build: str = "int8",
              slabbed: bool = False) -> tuple[bool, int, tuple[int, int]]:
    """(wide tile, split count, CTA tile) of a launch over weights of
    ``ns`` columns. f32 activations take the CUDA-core kernel, unsplit, at
    every M. bf16 activations over int8 weights take the small kernel up to
    256 rows, and above it when the call runs in slabs (``slabbed``), else
    the wide tile; over bf16 weights the dense kernel (``DENSE_TILE``: its
    wgmma's tokens by the CTA's columns), always in slabs."""
    if x_dtype != torch.bfloat16:
        return False, 1, FMA_TILE
    if build == "bf16":
        return False, split_count(K, ns, build), DENSE_TILE
    if M <= ROW_INVARIANT_M or slabbed:
        return False, split_count(K, ns, build), SMALL_TILE
    return True, 1, WIDE_TILE


def dense_whole(K: int, ns) -> int:
    """The column tiles a four-tile dense launch (193 to 256 rows) runs
    whole, one CTA for all its rows; every other tile runs as two CTAs of
    128 rows each, side by side. From the weights alone, to fill the card's
    waves (``SMS`` CTAs, one per SM): every tile halved where the halves fit
    one wave and their clusters of ``split`` fit beside each other (split
    <= 2: at one CTA per SM not every cluster of 4 is co-resident); every
    tile whole where those fit one wave, or need more than half a wave
    beyond it; between, half the tiles whole, so that the halves fill what
    the whole tiles leave. Only which CTA computes an element follows from
    it, never the element's sum."""
    tiles, split = column_tiles(ns), split_count(K, ns, "bf16")
    ctas = tiles * split
    if 2 * ctas <= SMS and split <= 2:
        return 0
    if ctas <= SMS or 2 * ctas > 3 * SMS:
        return tiles
    return tiles // 2


def dense_geometry(M: int, K: int, ns) -> dict:
    """The dense kernel's launch of ``M`` <= 256 rows over weights of
    ``ns`` columns, as ``csrc/w8a16_gemm.cu`` (``DenseGeom``,
    ``launch_dense_rows``; four token tiles: ``Dense4Part``,
    ``launch_dense4``) runs it: the build (``kernel_info``'s name), the
    token tiles of 64 rows (ceil(M / 64)) and the wgmma's n (64 per tile
    a CTA serves), the columns per CTA, the split of K, the CTAs, the
    ring's stages (four tiles: of a whole tile, and ``half_stages`` of a
    half), the dynamic shared memory and the CTAs per SM (one). Up to
    three tiles a CTA serves every row (column tiles x split CTAs: no M
    axis, so each weight tile is read once); at four, ``whole`` tiles
    (``dense_whole``) do and the others run as two halves of 128 rows.
    Only the split and the k order enter a row's sums, and they never
    follow M; n, the ring and the CTAs follow the token tiles alone."""
    if not 1 <= M <= ROW_INVARIANT_M:
        raise ValueError(f"the dense kernel takes 1 to {ROW_INVARIANT_M} "
                         f"rows a launch, got {M}")
    tiles = -(-M // DENSE_N)
    split = split_count(K, ns, "bf16")
    n_tiles = column_tiles(ns, DENSE_TILE[1])

    def stage(t):
        return DENSE_TILE[1] * BK * 2 + t * DENSE_N * BK * 2

    geo = {"build": f"dense{tiles}", "token_tiles": tiles,
           "n": DENSE_N * tiles, "columns": DENSE_TILE[1], "split": split,
           "ctas": n_tiles * split, "per_sm": 1}
    if tiles < 4:
        stages = DENSE_RING // stage(tiles)
        return geo | {"stages": stages,
                      "smem_bytes": stages * (stage(tiles) + 16) + 1024}
    whole = dense_whole(K, ns)
    return geo | {"whole": whole, "ctas": (2 * n_tiles - whole) * split,
                  "stages": DENSE4_RING // stage(4),
                  "half_stages": DENSE4_RING // stage(2),
                  "smem_bytes": DENSE4_RING + 16 * (DENSE4_RING // stage(2))
                  + 1024}


def slabs(M: int) -> list[tuple[int, int]]:
    """The (first row, rows) of each small-kernel launch of an M-row call
    that runs in slabs: consecutive slabs of ``ROW_INVARIANT_M`` rows, the
    last one ragged (csrc/w8a16_gemm.cu's ``grove_w8a16_run`` loop)."""
    return [(r0, min(ROW_INVARIANT_M, M - r0))
            for r0 in range(0, M, ROW_INVARIANT_M)]


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("w8a16_gemm")
    plan = lib.grove_w8a16_plan
    plan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    plan.restype = ctypes.c_int
    run = lib.grove_w8a16_run
    run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    run.restype = ctypes.c_int
    lib.grove_w8a16_plan_bytes.restype = ctypes.c_int
    err_str = lib.grove_w8a16_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    info = lib.grove_w8a16_info
    info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    info.restype = ctypes.c_int
    return plan, run, lib.grove_w8a16_plan_bytes(), err_str, info


def kernel_info(which: str) -> dict:
    """Tile, registers and local (spill) bytes per thread, dynamic shared
    memory per CTA, the largest cluster, the residency (``small``, the
    int8-weight build, and ``dense1`` .. ``dense4``, the dense kernel for
    1 to 4 token tiles: clusters of that size resident at once; ``wide``
    and ``fma``: CTAs per SM), CTAs per SM and ring stages of the built
    kernel (needs the card)."""
    *_, err_str, info = _kernel()
    out = (ctypes.c_int * 9)()
    err = info(_INFO[which], out)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel info failed: "
                           f"{err_str(err).decode()} ({err})")
    return {"tile": (out[0], out[1]), "registers": out[2],
            "local_bytes": out[3], "smem_bytes": out[4], "cluster": out[5],
            "resident": out[6], "per_sm": out[7], "stages": out[8]}


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


def _check_dense(x: torch.Tensor, weights, out_dtype: torch.dtype) -> None:
    """Shapes, types and devices of a dense call, for both routes."""
    if not 1 <= len(weights) <= MAX_WEIGHTS:
        raise ValueError(f"dense_matmul takes 1 to {MAX_WEIGHTS} weights "
                         f"per call, got {len(weights)}")
    if x.dim() != 2 or any(w.dim() != 2 for w in weights):
        raise ValueError("x must be [M, K] and each weight [K, N]")
    for w in weights:
        if x.shape[1] != w.shape[0]:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, weight "
                             f"{tuple(w.shape)}")
    devs = {w.device for w in weights} | {x.device}
    if len(devs) != 1:
        raise ValueError(f"dense_matmul inputs span devices {devs}")


def _dense_build(x: torch.Tensor, weights, out_dtype: torch.dtype) -> str:
    """The kernel build of a dense call on the card: ``bf16`` (bf16 x and
    weights, a bf16 or f32 output: the tensor-core small kernel) or ``f32``
    (f32 x, weights and output: the CUDA-core kernel)."""
    wt = {w.dtype for w in weights}
    if x.dtype == torch.bfloat16 and wt == {torch.bfloat16} and \
            out_dtype in _OUT_CODES:
        return "bf16"
    if x.dtype == torch.float32 and wt == {torch.float32} and \
            out_dtype == torch.float32:
        return "f32"
    raise ValueError(f"the dense kernel takes bfloat16 x and weights with a "
                     f"bfloat16 or float32 output, or float32 x, weights "
                     f"and output; got {x.dtype} x {sorted(map(str, wt))} "
                     f"-> {out_dtype}")


def _make_plan(x, ws, scales, out_dtype, build: str, wide: bool) -> tuple:
    """The launch plan of x's shape and type over the weights ``ws`` (int8
    codes with ``scales``, or dense weights with ``scales`` None): (the C
    plan's address, the weights' column counts, the first column of each
    among all outputs, their total, the buffer that holds the plan).
    Checks everything the kernel needs of the weights."""
    M, K = x.shape
    ns = [w.shape[1] for w in ws]
    k_mult, n_mult = _MULTIPLES[build]
    if K % k_mult or any(n % n_mult for n in ns):
        raise ValueError(f"the {build}-weight GEMM kernel takes K % {k_mult}"
                         f" == 0 and N % {n_mult} == 0, got K={K}, N={ns}")
    for t in [*ws, *(scales or [])]:
        if not t.is_contiguous():
            raise ValueError("the GEMM kernel reads a contiguous weight and "
                             "scales (it never copies them)")
        if t.data_ptr() % 16:
            raise ValueError("the weight and its scales must start 16-byte "
                             "aligned")
    _, split, _ = partition(M, K, ns, x.dtype, build, slabbed=not wide)
    whole = dense_whole(K, ns) if build == "bf16" else 0
    plan, _, nbytes, err_str, _ = _kernel()
    count = len(ws)
    ptrs = ctypes.c_void_p * count
    buf = ctypes.create_string_buffer(nbytes)
    err = plan(ptrs(*(w.data_ptr() for w in ws)),
               ptrs(*(s.data_ptr() for s in scales) if scales else
                    [None] * count),
               (ctypes.c_int * count)(*ns), count, K, _X_CODES[x.dtype],
               _BUILD_CODES[build], _OUT_CODES[out_dtype], int(wide), split,
               whole, buf)
    if err != 0:
        raise RuntimeError(f"GEMM launch plan failed: "
                           f"{err_str(err).decode()} ({err})")
    offs = [sum(ns[:i]) for i in range(count)]
    return ctypes.addressof(buf), ns, offs, sum(ns), buf


_plans: dict[tuple, tuple] = {}


def _plan_key(x, ws, scales, out_dtype, build: str, wide: bool) -> tuple:
    """What a launch plan depends on: x's device, type, K and kernel (wide
    or not), the build, the output type, and each weight's (and scale's)
    pointer, shape, strides and type."""
    return (x.get_device(), x.dtype, out_dtype, build, wide, x.shape[1]) + \
        tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
              for t in [*ws, *(scales or [])])


def _launch(x, ws, scales, out_dtype, build: str, slabbed: bool,
            check=None) -> tuple[list[torch.Tensor], int]:
    """The outputs of one foreign call and the kernel launches it made:
    one, or one per slab of ``slabs(M)`` where a bf16-activation call above
    256 rows runs in slabs. ``check()`` runs before a new plan is made."""
    M = x.shape[0]
    wide = (x.dtype == torch.bfloat16 and M > ROW_INVARIANT_M
            and partition(M, x.shape[1], [w.shape[1] for w in ws], x.dtype,
                          build, slabbed)[0])
    key = _plan_key(x, ws, scales, out_dtype, build, wide)
    plan = _plans.get(key)
    if plan is None:
        if check is not None:
            check()
        plan = _make_plan(x, ws, scales, out_dtype, build, wide)
        if len(_plans) >= MAX_PLANS:
            _plans.clear()
        _plans[key] = plan
    addr, ns, offs, total, _ = plan
    if not x.is_contiguous():
        x = x.contiguous()
    elif x.data_ptr() % 16:  # a view at an odd offset: TMA reads 16-byte rows
        x = x.clone()
    slab = ROW_INVARIANT_M if x.dtype == torch.bfloat16 and not wide else 0
    # One allocation for all outputs; each is a contiguous [M, n] view.
    shape = (M, total) if len(ns) == 1 else (M * total,)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    _, run, _, err_str, _ = _kernel()
    err = run(addr, x.data_ptr(), out.data_ptr(), M, slab,
              torch._C._cuda_getCurrentRawStream(key[0]))
    if err != 0:
        raise RuntimeError(f"GEMM kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    n_launch = len(slabs(M)) if slab else 1
    if len(ns) == 1:
        return [out], n_launch
    return [out.as_strided((M, n), (n, 1), M * o)
            for n, o in zip(ns, offs)], n_launch


def w8a16_matmul_group(x: torch.Tensor, weights,
                       out_dtype: torch.dtype | None = None,
                       slabbed: bool = False) -> list[torch.Tensor]:
    """``x`` [M, K] times each int8 weight of ``weights`` (1 to 3 pairs of
    ``q`` [K, N_i] with bf16 ``scale`` [N_i]), as ``out_dtype`` (default:
    x's type promoted with the scales', as JAX's einsum promotes): one
    output [M, N_i] per weight.

    CUDA tensors run the hand-written kernel, one launch for all of them
    (with ``slabbed`` and bf16 x above 256 rows, one per slab of 256 rows,
    each row with the bits it has at M <= 256); CPU tensors run
    ``w8a16_matmul_ref`` on each. Anything else raises, on either route:
    mixed devices, other types, and on the card a shape the kernel does not
    take (checked when the launch's plan is made; a plan is reused only for
    the same pointers, shapes, strides and types), and an input that
    requires grad (the kernel has no backward)."""
    weights = list(weights)
    refuse_grad("w8a16_matmul", x, *(s for _, s in weights))
    if out_dtype is None and weights:
        out_dtype = torch.promote_types(x.dtype, weights[0][1].dtype)
    if x.is_cuda and weights and x.dim() == 2 and x.shape[0]:
        outs, n = _launch(x, [q for q, _ in weights],
                          [s for _, s in weights], out_dtype, "int8",
                          slabbed, lambda: _check(x, weights, out_dtype))
        w8a16_matmul.launches += n
        return outs
    _check(x, weights, out_dtype)
    if x.device.type == "cpu":
        return w8a16_matmul_group_ref(x, weights, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16 runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return [torch.empty((0, q.shape[1]), dtype=out_dtype, device=x.device)
            for q, _ in weights]


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [M, K] times the int8 weight ``q`` [K, N] with bf16 ``scale``
    [N] per column, as ``out_dtype``: ``w8a16_matmul_group`` of one weight.
    ``launches`` counts the kernel launches of both."""
    return w8a16_matmul_group(x, [(q, scale)], out_dtype)[0]


w8a16_matmul.launches = 0


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``x`` [M, K] times the dense weight ``w`` [K, N] at
    the promoted type of x, w and ``out_dtype``, returned as
    ``out_dtype``: the model's einsum on dense weights (and the LM head's
    f32 product)."""
    ct = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                             out_dtype)
    return (x.to(ct) @ w.to(ct)).to(out_dtype)


def dense_builds(M: int, build: str) -> list[str]:
    """The kernel build of each launch of a dense call of ``M`` rows on
    the card (``kernel_info``'s names): the f32 build one ``fma`` launch,
    the bf16 build one launch per slab of ``slabs(M)``, ``dense1`` ..
    ``dense4`` by its token tiles."""
    if build == "f32":
        return ["fma"]
    return [f"dense{-(-rows // DENSE_N)}" for _, rows in slabs(M)]


def dense_matmul_group(x: torch.Tensor, weights,
                       out_dtype: torch.dtype | None = None
                       ) -> list[torch.Tensor]:
    """``x`` [M, K] times each dense weight of ``weights`` (1 to 3 of
    [K, N_i]), as ``out_dtype`` (default: the promoted type of x and the
    weights): one output [M, N_i] per weight.

    CUDA tensors run the hand-written kernel: bf16 x and weights the dense
    kernel (one launch for all weights up to 256 rows, one per slab of 256
    rows above, so a row's bits never depend on M),
    f32 the CUDA-core kernel (one launch). CPU tensors run
    ``dense_matmul_ref`` on each. Anything else raises: mixed devices,
    other types, an input that requires grad and, on the card, bf16 shapes
    with K % 8 or N % 8."""
    weights = list(weights)
    refuse_grad("dense_matmul", x, *weights)
    if out_dtype is None and weights:
        out_dtype = torch.promote_types(x.dtype, weights[0].dtype)
    _check_dense(x, weights, out_dtype)
    if x.device.type == "cpu":
        return [dense_matmul_ref(x, w, out_dtype) for w in weights]
    if x.device.type != "cuda":
        raise ValueError(f"dense_matmul runs on cuda or cpu tensors, not "
                         f"{x.device}")
    build = _dense_build(x, weights, out_dtype)
    if not x.shape[0]:
        return [torch.empty((0, w.shape[1]), dtype=out_dtype,
                            device=x.device) for w in weights]
    outs, n = _launch(x, weights, None, out_dtype, build, True)
    dense_matmul.launches += n
    for name in dense_builds(x.shape[0], build):
        dense_matmul.launches_by_build[name] += 1
    return outs


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [M, K] times the dense weight ``w`` [K, N] as ``out_dtype``:
    ``dense_matmul_group`` of one weight. ``launches`` counts the kernel
    launches of both."""
    return dense_matmul_group(x, [w], out_dtype)[0]


dense_matmul.launches = 0
dense_matmul.launches_by_build = dict.fromkeys(
    ("dense1", "dense2", "dense3", "dense4", "fma"), 0)
