"""Causal GQA flash attention for prefill: a CUDA kernel for Hopper and its
plain PyTorch version.

Replaces ``grove_tpu/ops/pallas_flash.py::_flash_kernel`` (launched by its
``flash_causal_attention`` through ``pl.pallas_call``). The kernel is
``grove_tpu_torch/csrc/flash_attn.cu``, built by ``ops/_build.py`` and bound
through a plain C entry point with ctypes.

What bounds it on an H100. At the serving shape (b=32, s=128, h=16,
n_kv=8, d=128, bf16) one call must move about 50 MB (q and out 16.8 MB
each, k and v 8.4 MB each) and do about 2.2 GFLOP below the diagonal: at
the data sheet's 3.35 TB/s and 989 TFLOP/s bf16 it is bound by bytes, about
15 us. At a long prompt (s=2048) the operations bound it.

What the design does about it. bfloat16 inputs take a Hopper kernel: both
products on the tensor cores (``wgmma``, f32 accumulation, P rounded to
bf16 as the JAX package's MXU matmuls round it), every tile moved by TMA
(K/V through a four-stage shared-memory ring), and persistent CTAs whose
producer thread loads the next tile while two consumer warpgroups compute
this one. A tile packs whole positions of all g query heads of a kv head,
so each K/V tile is loaded once for all of them; the probabilities never
leave the registers. float32 inputs take the f32 CUDA-core kernel, the
TPU kernel's f32 semantics. Both read q/k/v in place through their
[b, s, h, d] strides (the TPU kernel's head-major transposes existed only
for its (8, 128) tiling) and walk only the k tiles at or below the
diagonal. The source's header has the details.

``flash_causal_attention`` takes the kernel for CUDA tensors and the plain
version for CPU tensors; there is no other route. ``launches`` on it counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops._grad import refuse_grad

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_causal_attention_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, block_k: int = 128
                               ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: the same online
    softmax over k blocks of ``block_k`` keys, in f32, with the TPU
    kernel's NEG_INF rules. q: [b, s, h, d]; k/v: [b, s, n_kv, d].

    The probabilities are rounded to the input type before the P.V product
    (the kernel's bf16 tensor-core operand; a no-op for f32) while the row
    sum ``l`` keeps the f32 ``p``.

    Skipping a k block wholly in a row's future (the kernels' causal skip)
    and processing it with every score masked give the same bits (p = 0,
    correction 1), so the q rows need no blocking here."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = d ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, s, n_kv, g, d)
    qf = qf.permute(0, 2, 3, 1, 4)                     # [b, kv, g, s, d]
    kf = k.to(torch.float32).permute(0, 2, 1, 3)        # [b, kv, s, d]
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    m = torch.full((b, n_kv, g, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n_kv, g, s, d), dtype=torch.float32,
                      device=q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, block_k):
        kb = kf[:, :, None, k0:k0 + block_k]           # [b, kv, 1, bk, d]
        vb = vf[:, :, None, k0:k0 + block_k]
        sc = qf @ kb.transpose(-1, -2)                 # [b, kv, g, s, bk]
        kv_pos = k0 + torch.arange(kb.shape[3], device=q.device)[None, :]
        sc = torch.where(q_pos >= kv_pos, sc, NEG_INF)
        block_m = sc.amax(dim=-1)
        m_new = torch.maximum(m, block_m)
        p = torch.exp(sc - m_new[..., None])
        p = torch.where((block_m == NEG_INF)[..., None], 0.0, p)
        corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_new))
        m = m_new
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(q.dtype).to(torch.float32) @ vb
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [b, s, heads, d]")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads do not group over "
                         f"{k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors along the head dim (the bf16
    kernel's tensor maps need the same): a unit head-dim stride, other
    strides in whole vectors, and an aligned base. A view that breaks this
    is made contiguous (same values)."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and all(st % vec == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point and its error-string helper, typed once."""
    lib = _build.load("flash_attn")
    fn = lib.grove_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.grove_cuda_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    info = lib.grove_flash_attn_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info.restype = ctypes.c_int
    return fn, err_str, info


def kernel_info(dtype: torch.dtype, head_dim: int) -> dict[str, int]:
    """What the built kernel for ``dtype`` and ``head_dim`` takes per
    launch: registers per thread, local (spill) bytes per thread and
    dynamic shared memory bytes per CTA (needs the card)."""
    _, err_str, info = _kernel()
    out = (ctypes.c_int * 3)()
    err = info(_DTYPE_CODES[dtype], head_dim, out)
    if err != 0:
        raise RuntimeError(f"flash kernel info failed: "
                           f"{err_str(err).decode()} ({err})")
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2]}


def _launch_kernel(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d > MAX_HEAD_DIM or d % 8 != 0:
        raise ValueError(f"flash kernel needs head_dim <= {MAX_HEAD_DIM} "
                         f"and head_dim % 8 == 0, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    fn, err_str, _ = _kernel()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, s, h, k.shape[2], d, strides,
                 d ** -0.5, stream)
    if err != 0:
        msg = err_str(err).decode()
        raise RuntimeError(f"flash kernel launch failed: {msg} ({err})")
    flash_causal_attention.launches += 1
    return out


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal GQA flash attention. q: [b, s, h, d]; k/v: [b, s, n_kv, d].

    CUDA tensors run the hand-written kernel; CPU tensors run
    ``flash_causal_attention_ref``. Anything else raises, and so does an
    input that requires grad (the kernel has no backward)."""
    refuse_grad("flash_causal_attention", q, k, v)
    _check(q, k, v)
    dev = q.device.type
    if dev == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_causal_attention_ref(q, k, v)
    if dev != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    return _launch_kernel(q, k, v)


flash_causal_attention.launches = 0
