"""The kernel wrappers' gradient guard.

The hand-written kernels have no backward: what a launch through ctypes
returns carries no ``grad_fn``, so autograd would drop the gradient of
everything before it without a word. Every kernel wrapper calls
``refuse_grad`` before it dispatches, on either route (its plain version
on CPU tensors too, so that the rule holds the same on both): with grad
mode on, an input that requires grad raises. Training runs the plain ops
(``models/llama.py``'s ``forward``); the engines serve under
``torch.no_grad()``.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} runs a hand-written kernel with no backward, and an "
            f"input requires grad: call it under torch.no_grad(), or train "
            f"through the plain ops (models/llama.py forward)")
