"""KV cache for incremental decoding.

A dense cache [layers, batch, max_len, n_kv, head_dim] with a per-lane
length vector. The serving engine allocates one cache per decode batch and
recycles lanes (continuous batching); see grove_tpu_torch/serving/engine.py.

Writes are in place: the JAX package donates the cache to every prefill and
decode step, so no caller keeps the old buffer and updating it in place
gives the same results without a second copy.
"""

from __future__ import annotations

import dataclasses

import torch


def _clamped_start(pos, max_len: int, s: int):
    """``dynamic_update_slice``'s start rule: a negative start counts once
    from the end (as a Python index), then the start is clamped to
    [0, max_len - s]."""
    if s > max_len:
        raise ValueError(f"{s} rows do not fit a cache row of {max_len}")
    if isinstance(pos, int):
        pos = pos + max_len if pos < 0 else pos
        return min(max(pos, 0), max_len - s)
    pos = torch.where(pos < 0, pos + max_len, pos)
    return pos.clamp(0, max_len - s)


def write_row(row: torch.Tensor, kv: torch.Tensor,
              pos: torch.Tensor | int) -> torch.Tensor:
    """Write ``kv`` [s, n_kv, d] into one lane's cache row [max_len, n_kv, d]
    starting at ``pos``, in place; returns ``row``. Like the JAX
    dynamic-update semantics, ``pos`` is clamped so that the write never
    errors past max_len: callers must enforce capacity (KVCache.has_room).
    """
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(1)
    write_rows(row[None], kv[None], pos)
    return row


def write_rows(rows: torch.Tensor, kv: torch.Tensor,
               pos: torch.Tensor | int) -> torch.Tensor:
    """``write_row`` over lanes, in place: rows [b, max_len, n_kv, d],
    kv [b, s, n_kv, d], ``pos`` an int shared by every lane or a [b]
    tensor of per-lane starts (read on the device, never on the host)."""
    b, s = kv.shape[:2]
    start = _clamped_start(pos, rows.shape[1], s)
    if isinstance(start, int):
        rows[:, start:start + s] = kv.to(rows.dtype)
    else:
        idx = start.to(torch.long)[:, None] + torch.arange(
            s, device=rows.device)
        lanes = torch.arange(b, device=rows.device)[:, None]
        rows[lanes, idx] = kv.to(rows.dtype)
    return rows


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [layers, b, max_len, n_kv, d]
    v: torch.Tensor        # [layers, b, max_len, n_kv, d]
    lengths: torch.Tensor  # [b] int32: valid entries per lane

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, n_kv: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> "KVCache":
        shape = (n_layers, batch, max_len, n_kv, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def has_room(self, n_tokens: int = 1) -> torch.Tensor:
        """[b] bool: lanes that can accept ``n_tokens`` more without the
        clamp in write_row overwriting the tail of the cache."""
        return self.lengths + n_tokens <= self.max_len
