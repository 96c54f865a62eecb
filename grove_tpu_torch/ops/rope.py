"""Rotary position embeddings.

The cos/sin table is computed once in numpy (the same code as the JAX
package, so the tables are bitwise equal) and rows are gathered by
position.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each [max_len, head_dim//2]."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    pos = np.arange(max_len, dtype=np.float32)
    ang = np.outer(pos, freqs)
    return (torch.from_numpy(np.cos(ang)).to(device=device, dtype=dtype),
            torch.from_numpy(np.sin(ang)).to(device=device, dtype=dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by per-token ``positions``
    [..., seq].

    Split-halves ("rotate-half" / GPT-NeoX) pairing: dimension ``i`` pairs
    with ``i + head_dim//2``. A bf16 ``x`` against the f32 table computes in
    f32 and casts back once. Positions past the table clamp to its last
    row, as the JAX gather does (lanes that decode idle can run past it).
    """
    positions = positions.clamp(0, cos.shape[0] - 1)
    c = cos[positions][..., None, :]  # [..., seq, 1, half]
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
