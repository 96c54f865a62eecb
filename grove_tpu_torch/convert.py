"""Carry a JAX-layout param tree across to the port's params dict.

``params_from_numpy`` takes the tree with every leaf as a numpy array
(what ``jax.tree.map(np.asarray, params)`` gives) and returns the same
dict of torch tensors on ``device``, key for key. bf16 leaves convert
bitwise through their 16-bit pattern; a leaf with ``.q`` and ``.scale``
(an int8-quantized weight) becomes the port's ``QTensor``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.serving.quant import QTensor


def tensor_from_numpy(a: np.ndarray,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """One numpy array as a torch tensor, bitwise (bf16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any,
                      device: str | torch.device | None = None) -> Any:
    """The tree as the port's params dict on ``device`` (None: the card)."""
    return _convert(tree, resolve_device(device))


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QTensor(q=tensor_from_numpy(tree.q, device),
                       scale=tensor_from_numpy(tree.scale, device))
    return tensor_from_numpy(tree, device)
