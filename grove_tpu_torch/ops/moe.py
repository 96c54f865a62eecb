"""The routed expert layer of a Mixtral-shaped model on the serving path:
routing, the grouped expert GEMM and the weighted combine, CUDA kernels for
Hopper (``grove_tpu_torch/csrc/moe_gemm.cu``) and their plain versions.

The layer (``expert_layer``) takes the normed rows ``h`` [M, d] and one
layer's router [d, E] and stacked experts (``we_gate`` and ``we_up`` [E, d,
F], ``we_down`` [E, F, d]), and computes what the JAX package's
``_moe_block`` (``grove_tpu/models/moe.py:97``) computes for each token:

1. the router's logits in f32 from bf16 ``h`` (the dense GEMM's f32
   output: bf16 products, f32 sums);
2. the k largest in descending order and a softmax over those k;
3. each chosen expert's SwiGLU, bf16 inputs with f32 sums, bf16 out;
4. the k weighted outputs summed in f32 in the order of the k, then bf16.

Only the work differs: the JAX package runs every expert for every token
and masks by weight (static shapes for the TPU); here each token reaches
its k experts. ``moe_route`` sorts the M k assignments by expert on the
device (a counting sort, token-major within an expert) and copies the rows
into that order; ``expert_matmul_group`` multiplies each expert's rows by
its own weights, reading the row ranges from the device offsets the route
wrote, on a grid fixed by the launch's rows (one CUDA graph per bucket
holds every routing); ``moe_combine`` gathers each token's k outputs back.
No step reads the routing back to the host. A token's bits depend on its
own row and its experts alone: the expert kernel splits no sum by M or by
the rows beside it, and the combine's order is fixed.

On CPU tensors each wrapper runs its plain version (the same permutation,
``dense_matmul_ref`` per expert, the combine's f32 ops); a CUDA tensor
launches the kernel or raises. ``launches`` on each wrapper counts its
launches (``expert_matmul.launches_by_build`` by token tiles: ``expert1``
up to 64 rows a launch, ``expert2`` above).

Counters: ``stats``, an int64 [E + 2] tensor on the device, gets each
expert's assignments, the experts that got any (summed over calls) and the
calls, added by the route kernel inside the graph; the engine reads it
only after its own fetches (``PagedDecodeEngine.payload()["moe"]``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd import profiler as autograd_profiler

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops._grad import refuse_grad
from grove_tpu_torch.ops.w8a16 import dense_matmul, dense_matmul_ref

MAX_EXPERTS = 64
MAX_K = 4
MAX_ASSIGN = 8192      # M k a route launch takes (its shared memory)
BK = 64                # the expert kernel's k-step: K % 64 == 0
ONE_TILE_ROWS = 64     # tokens a launch whose experts take one 64-row pass
_INFO = {"route": 0, "expert1": 1, "expert2": 2, "combine": 3}


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("moe_gemm")
    route = lib.grove_moe_route
    route.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    route.restype = ctypes.c_int
    plan = lib.grove_moe_plan
    plan.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    plan.restype = ctypes.c_int
    run = lib.grove_moe_expert_run
    run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    run.restype = ctypes.c_int
    combine = lib.grove_moe_combine
    combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    combine.restype = ctypes.c_int
    lib.grove_moe_plan_bytes.restype = ctypes.c_int
    info = lib.grove_moe_info
    info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    info.restype = ctypes.c_int
    err_str = lib.grove_moe_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return (route, plan, run, combine, lib.grove_moe_plan_bytes(), info,
            err_str)


def _raise(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{_kernel()[-1](err).decode()} ({err})")


def kernel_info(which: str) -> dict:
    """Registers and local (spill) bytes per thread, dynamic shared memory,
    CTAs per SM and ring stages of ``route``, ``expert1``, ``expert2`` or
    ``combine`` as built (needs the card)."""
    out = (ctypes.c_int * 5)()
    _raise("moe kernel info", _kernel()[5](_INFO[which], out))
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2], "per_sm": out[3], "stages": out[4]}


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _device_only(name: str, *tensors: torch.Tensor) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name} inputs span devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")


# ---- routing ----

def route_ref(logits: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the routing: each row's k largest logits in
    descending order (``torch.topk``, as ``lax.top_k``) and a softmax over
    them: (experts [M, k] int64, weights [M, k] f32)."""
    vals, idx = torch.topk(logits.to(torch.float32), k, dim=-1)
    return idx, torch.softmax(vals, dim=-1)


def moe_route_ref(logits: torch.Tensor, h: torch.Tensor, k: int,
                  stats: torch.Tensor | None = None) -> tuple:
    """Plain version of ``moe_route``: the same outputs from ``route_ref``
    and a stable sort of the assignments (token-major) by expert."""
    M, E = logits.shape
    idx, w = route_ref(logits, k)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    offsets = torch.zeros(E + 1, dtype=torch.int32, device=h.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    slot = torch.empty(M * k, dtype=torch.int32, device=h.device)
    slot[order] = torch.arange(M * k, dtype=torch.int32, device=h.device)
    x_perm = h.repeat_interleave(k, dim=0)[order]
    if stats is not None:
        stats[:E] += counts
        stats[E] += int((counts > 0).sum())
        stats[E + 1] += 1
    return x_perm, offsets, slot, w.reshape(-1).to(torch.float32)


def moe_route(logits: torch.Tensor, h: torch.Tensor, k: int,
              stats: torch.Tensor | None = None) -> tuple:
    """Route the rows ``h`` [M, d] by their router ``logits`` [M, E] f32 to
    ``k`` experts each: (``x_perm`` [M k, d], the rows in expert order;
    ``offsets`` [E + 1] int32, expert e's rows ``offsets[e]`` to
    ``offsets[e + 1]``; ``slot`` [M k] int32, the row of assignment
    ``t k + j``, token t's j-th choice; the weights [M k] f32). ``stats``
    (int64 [E + 2]) takes the counters in place. One launch on the card."""
    refuse_grad("moe_route", logits, h)
    _device_only("moe_route", logits, h)
    M, E = logits.shape
    if h.dim() != 2 or h.shape[0] != M or not 1 <= k <= min(E, MAX_K) \
            or E > MAX_EXPERTS or logits.dtype != torch.float32:
        raise ValueError(f"moe_route takes f32 logits [M, E <= "
                         f"{MAX_EXPERTS}] and h [M, d], 1 <= k <= "
                         f"{MAX_K}; got {tuple(logits.shape)} "
                         f"{logits.dtype}, h {tuple(h.shape)}, k={k}")
    if stats is not None and (stats.shape != (E + 2,)
                              or stats.dtype != torch.int64):
        raise ValueError(f"stats must be int64 [{E + 2}]")
    if not logits.is_cuda:
        return moe_route_ref(logits, h, k, stats)
    d = h.shape[1]
    if h.dtype != torch.bfloat16 or d % 8 or M * k > MAX_ASSIGN:
        raise ValueError(f"the route kernel takes bf16 rows with d % 8 == 0 "
                         f"and M k <= {MAX_ASSIGN}; got {h.dtype}, d={d}, "
                         f"M k={M * k}")
    h = h.contiguous()
    logits = logits.contiguous()
    x_perm = torch.empty((M * k, d), dtype=h.dtype, device=h.device)
    offsets = torch.empty(E + 1, dtype=torch.int32, device=h.device)
    slot = torch.empty(M * k, dtype=torch.int32, device=h.device)
    w = torch.empty(M * k, dtype=torch.float32, device=h.device)
    _raise("moe route launch", _kernel()[0](
        logits.data_ptr(), h.data_ptr(), x_perm.data_ptr(),
        offsets.data_ptr(), slot.data_ptr(), w.data_ptr(),
        None if stats is None else stats.data_ptr(), M, E, k, d,
        _stream(h)))
    moe_route.launches += 1
    return x_perm, offsets, slot, w


moe_route.launches = 0


# ---- the grouped expert GEMM ----

def expert_matmul_ref(x: torch.Tensor, offsets: torch.Tensor, weights
                      ) -> list[torch.Tensor]:
    """Plain version: expert e's rows of ``x`` times its weight ``w[e]``
    (``dense_matmul_ref`` at the promoted type), for each weight."""
    bounds = offsets.tolist()
    outs = []
    for w in weights:
        dt = torch.promote_types(x.dtype, w.dtype)
        out = torch.empty((x.shape[0], w.shape[2]), dtype=dt,
                          device=x.device)
        for e in range(w.shape[0]):
            a, b = bounds[e], bounds[e + 1]
            if b > a:
                out[a:b] = dense_matmul_ref(x[a:b], w[e], dt)
        outs.append(out)
    return outs


_plans: dict[tuple, tuple] = {}


def _plan(weights) -> int:
    """The C plan of a launch over ``weights`` (their TMA maps), made once
    per pointers, shapes and strides."""
    key = tuple((w.data_ptr(), w.shape, w.stride()) for w in weights)
    entry = _plans.get(key)
    if entry is None:
        E, K, _ = weights[0].shape
        for w in weights:
            if w.shape[:2] != (E, K) or w.shape[2] % 8 or not \
                    w.is_contiguous() or w.data_ptr() % 16:
                raise ValueError("the expert kernel reads contiguous, "
                                 "16-byte aligned [E, K, N] weights with "
                                 "N % 8 == 0, all of one E and K")
        _, plan, _, _, nbytes, _, _ = _kernel()
        buf = ctypes.create_string_buffer(nbytes)
        count = len(weights)
        _raise("moe expert plan", plan(
            (ctypes.c_void_p * count)(*(w.data_ptr() for w in weights)),
            (ctypes.c_int * count)(*(w.shape[2] for w in weights)), count,
            E, K, buf))
        entry = (ctypes.addressof(buf), buf)
        if len(_plans) >= 4096:
            _plans.clear()
        _plans[key] = entry
    return entry[0]


def expert_build(rows: int) -> str:
    """The expert kernel's build for a launch whose tokens number ``rows``
    (its M, before the k copies): ``expert1`` (passes of 64 rows) up to 64
    tokens, where no expert gets more than 64 rows, else ``expert2``
    (passes of 128: a 256-row chunk's ~64 an expert in one pass). Only the
    passes follow it, never an element's sum."""
    return "expert1" if rows <= ONE_TILE_ROWS else "expert2"


def expert_matmul_group(x: torch.Tensor, offsets: torch.Tensor, weights,
                        rows: int) -> list[torch.Tensor]:
    """``x`` [A, K] (rows in expert order, ``moe_route``'s ``x_perm``)
    times each stacked expert weight of ``weights`` (1 or 2 of [E, K, N_i],
    sharing x): expert e's rows ``offsets[e]`` to ``offsets[e + 1]`` (a
    device tensor) times ``w[e]``, one output [A, N_i] per weight, bf16.
    ``rows`` is the launch's token count M (A = M k), which picks the
    build (``expert_build``). One launch on the card for all weights."""
    weights = list(weights)
    refuse_grad("expert_matmul", x, *weights)
    _device_only("expert_matmul", x, offsets, *weights)
    if not 1 <= len(weights) <= 2 or x.dim() != 2 or any(
            w.dim() != 3 or w.shape[1] != x.shape[1] for w in weights) or \
            offsets.shape != (weights[0].shape[0] + 1,):
        raise ValueError(f"expert_matmul takes x [A, K], offsets [E + 1] and "
                         f"1 or 2 weights [E, K, N]; got x {tuple(x.shape)}, "
                         f"offsets {tuple(offsets.shape)}, weights "
                         f"{[tuple(w.shape) for w in weights]}")
    if not x.is_cuda:
        return expert_matmul_ref(x, offsets, weights)
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16
                                        for w in weights) \
            or x.shape[1] % BK or offsets.dtype != torch.int32:
        raise ValueError(f"the expert kernel takes bf16 x and weights with "
                         f"K % {BK} == 0 and int32 offsets; got {x.dtype}, "
                         f"{[w.dtype for w in weights]}, K={x.shape[1]}")
    A = x.shape[0]
    ns = [w.shape[2] for w in weights]
    out = torch.empty(A * sum(ns), dtype=torch.bfloat16, device=x.device)
    if A:
        x = x.contiguous()
        if x.data_ptr() % 16:  # a view at an odd offset: TMA reads 16 bytes
            x = x.clone()
        build = expert_build(rows)
        _raise("moe expert launch", _kernel()[2](
            _plan(weights), x.data_ptr(), out.data_ptr(),
            offsets.data_ptr(), A, 1 if build == "expert1" else 2,
            _stream(x)))
        expert_matmul.launches += 1
        expert_matmul.launches_by_build[build] += 1
    at, outs = 0, []
    for n in ns:
        outs.append(out[at:at + A * n].view(A, n))
        at += A * n
    return outs


def expert_matmul(x: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """``expert_matmul_group`` of one weight; ``launches`` counts the
    launches of both."""
    return expert_matmul_group(x, offsets, [w], rows)[0]


expert_matmul.launches = 0
expert_matmul.launches_by_build = dict.fromkeys(("expert1", "expert2"), 0)


# ---- the combine ----

def moe_combine_ref(y: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Plain version: token t's k rows of ``y`` times its weights, each
    product in f32, summed in the order of the k, then in y's type."""
    M = slot.shape[0] // k
    rows = y[slot.long()].to(torch.float32).view(M, k, -1)
    wt = w.view(M, k, 1)
    acc = rows[:, 0] * wt[:, 0]
    for j in range(1, k):
        acc = acc + rows[:, j] * wt[:, j]
    return acc.to(y.dtype)


def moe_combine(y: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                k: int) -> torch.Tensor:
    """``out`` [M, d] = each token's k expert outputs (rows ``slot`` of
    ``y`` [M k, d]) weighted by ``w`` [M k] f32 and summed in f32 in the
    order of the k, in y's type. One launch on the card."""
    refuse_grad("moe_combine", y, w)
    _device_only("moe_combine", y, slot, w)
    if y.dim() != 2 or slot.shape != w.shape or slot.shape[0] % k or \
            not 1 <= k <= MAX_K:
        raise ValueError(f"moe_combine takes y [M k, d], slot and weights "
                         f"[M k]; got {tuple(y.shape)}, {tuple(slot.shape)}, "
                         f"{tuple(w.shape)}, k={k}")
    if not y.is_cuda:
        return moe_combine_ref(y, slot, w, k)
    M, d = slot.shape[0] // k, y.shape[1]
    if y.dtype != torch.bfloat16 or d % 2 or slot.dtype != torch.int32 or \
            w.dtype != torch.float32:
        raise ValueError("the combine kernel takes bf16 y with an even d, "
                         "int32 slots and f32 weights")
    out = torch.empty((M, d), dtype=y.dtype, device=y.device)
    if M:
        _raise("moe combine launch", _kernel()[3](
            y.contiguous().data_ptr(), slot.data_ptr(), w.data_ptr(),
            out.data_ptr(), M, k, d, _stream(y)))
        moe_combine.launches += 1
    return out


moe_combine.launches = 0


# ---- the layer ----

def expert_layer(h: torch.Tensor, router: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, k: int,
                 stats: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's routed experts over the normed rows ``h`` [..., d]:
    router [d, E], ``w_gate``/``w_up`` [E, d, F], ``w_down`` [E, F, d];
    returns [..., d] in h's type (the residual's ``add_rms_norm`` takes
    it). On the card: the router's dense GEMM (f32 out), ``moe_route``,
    gate and up in one ``expert_matmul_group`` launch, ``silu(gate) *
    up``, the down projection, ``moe_combine``; the plain versions on CPU
    tensors. While a profiler collects, the layer's host side is the range
    ``grove.moe`` (under a CUDA graph the capture's, not each replay's)."""
    ranged = (torch.profiler.record_function("grove.moe")
              if autograd_profiler._is_profiler_enabled
              else contextlib.nullcontext())
    with ranged:
        lead, d = h.shape[:-1], h.shape[-1]
        h2 = h.reshape(-1, d)
        M = h2.shape[0]
        logits = dense_matmul(h2, router, torch.float32)
        x, offsets, slot, w = moe_route(logits, h2, k, stats)
        gate, up = expert_matmul_group(x, offsets, [w_gate, w_up], M)
        y = expert_matmul(F.silu(gate) * up, offsets, w_down, M)
        return moe_combine(y, slot, w, k).reshape(*lead, d)
