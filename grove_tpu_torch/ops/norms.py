"""RMS normalisation, alone or after the residual add: in f32, cast back to
the input's type.

``rms_norm`` and ``add_rms_norm`` run the hand-written kernel
(``grove_tpu_torch/csrc/rms_norm.cu``: one warp per row, the row's sum of
squares in a fixed order) on CUDA tensors and their plain versions on CPU
tensors: ``rms_norm_ref``, the JAX package's composition
(``grove_tpu/ops/norms.py``), and ``add_rms_norm_ref``, the residual add
``x + delta`` (the model's ``x + out.to(x.dtype)``) and then
``rms_norm_ref``. Anything else raises. The kernel's point is that a row's
bits depend on that row alone: PyTorch's mean splits a row's sum according
to how many rows the call holds, so the composition gave a row other bits
in a call of 16 rows than in one of 4, and speculative decoding's verify
chunk (k + 1 rows per sequence) must reproduce sequential decoding (one
row) bitwise. It is also one launch where the composition took nine, and
``add_rms_norm`` folds the residual add into the same pass (XLA fuses the
two on the TPU). ``launches`` on each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops._grad import refuse_grad

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Plain version: the JAX package's ``rms_norm`` in PyTorch."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(dtype)


def add_rms_norm_ref(x: torch.Tensor, delta: torch.Tensor,
                     weight: torch.Tensor, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``add_rms_norm``: ``s = x + delta`` (one rounding
    to x's type), then ``(s, rms_norm_ref(s, weight))``."""
    s = x + delta
    return s, rms_norm_ref(s, weight, eps)


@functools.lru_cache(maxsize=1)
def _kernel():
    lib = _build.load("rms_norm")
    fn = lib.grove_rms_norm
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = lib.grove_rms_norm_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
    info.restype = ctypes.c_int
    err_str = lib.grove_rms_norm_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, info, err_str


def kernel_info(dtype: torch.dtype, weight_dtype: torch.dtype,
                add: bool = False) -> dict:
    """Registers and local (spill) bytes per thread of one vectorized build
    (``add``: the residual-add build; needs the card)."""
    _, info, err_str = _kernel()
    out = (ctypes.c_int * 2)()
    err = info(_DTYPE_CODES[dtype], _DTYPE_CODES[weight_dtype], int(add),
               out)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel info failed: "
                           f"{err_str(err).decode()} ({err})")
    return {"registers": out[0], "local_bytes": out[1]}


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() < 1 or weight.dim() != 1 or weight.shape[0] != x.shape[-1]:
        raise ValueError(f"rms_norm takes x [..., d] and weight [d], got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")


def _route(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensors on one device), False for the
    plain version (both on the CPU); raises otherwise."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return False
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rms_norm runs on cuda or cpu tensors on one "
                         f"device, not {x.device} and {weight.device}")
    if x.dtype not in _DTYPE_CODES or weight.dtype not in _DTYPE_CODES:
        raise ValueError(f"the rms_norm kernel takes float32 or bfloat16, "
                         f"not {x.dtype} and {weight.dtype}")
    return True


def _launch(x: torch.Tensor, delta: torch.Tensor | None,
            weight: torch.Tensor, eps: float
            ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """One kernel launch: (s or None, out)."""
    x = x.contiguous()
    weight = weight.contiguous()
    out = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return s, out
    if delta is not None:
        delta = delta.contiguous()
    fn, _, err_str = _kernel()
    err = fn(x.data_ptr(), 0 if delta is None else delta.data_ptr(),
             weight.data_ptr(),
             0 if s is None else s.data_ptr(), out.data_ptr(), rows, d, eps,
             _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
             torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    return s, out


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalise each row of ``x`` [..., d] by its root mean square (in
    f32), scale by ``weight`` [d] and cast back to x's type.

    CUDA tensors run the hand-written kernel (one launch, each row's result
    a function of that row alone); CPU tensors run ``rms_norm_ref``.
    Anything else raises, and so does an input that requires grad (the
    kernel has no backward)."""
    refuse_grad("rms_norm", x, weight)
    _check(x, weight)
    if not _route(x, weight):
        return rms_norm_ref(x, weight, eps)
    _, out = _launch(x, None, weight, eps)
    if out.numel():
        rms_norm.launches += 1
    return out


rms_norm.launches = 0


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the next norm in one pass: ``s = x + delta``
    (``delta`` of x's type and shape, one rounding) and ``(s, rms_norm(s,
    weight))``.

    CUDA tensors run the hand-written kernel (one launch that writes both;
    its normed rows are ``rms_norm``'s of s bit for bit); CPU tensors run
    ``add_rms_norm_ref``. Anything else raises, and so does an input that
    requires grad."""
    refuse_grad("add_rms_norm", x, delta, weight)
    _check(x, weight)
    if delta.shape != x.shape or delta.dtype != x.dtype:
        raise ValueError(f"add_rms_norm takes delta of x's shape and type, "
                         f"got {tuple(delta.shape)} {delta.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    if delta.device != x.device:
        raise ValueError(f"add_rms_norm inputs span devices {x.device} "
                         f"and {delta.device}")
    if not _route(x, weight):
        return add_rms_norm_ref(x, delta, weight, eps)
    s, out = _launch(x, delta, weight, eps)
    if out.numel():
        add_rms_norm.launches += 1
    return s, out


add_rms_norm.launches = 0
