"""Attention ops: prefill (full causal) and decode (single token vs cache).

Shapes follow [batch, seq, heads, head_dim] throughout; GQA groups the
query heads over the kv heads with a reshape (no materialised repeat).

The prefill path is a plain formulation; ``pick_causal_attention`` slots
the flash kernel (grove_tpu_torch/ops/flash.py) in behind the same
signature where the shape fits it.
"""

from __future__ import annotations

import os

import torch

NEG_INF = -1e30


def pick_causal_attention(seq: int, head_dim: int,
                          q_offset: torch.Tensor | int = 0,
                          device: str | torch.device = "cpu"):
    """Choose the prefill attention for tensors on ``device``.

    Returns ``None`` to use the plain ``causal_attention``, or a callable
    ``(q, k, v) -> out`` running flash attention when the tensors are on
    CUDA and the shape fits: q offset 0, ``seq % 128 == 0`` and
    ``head_dim % 8 == 0``. ``GROVE_FLASH_ATTENTION=0`` forces the plain
    formulation; ``=1`` selects flash on the CPU too, where it runs its
    plain version (for parity checks).
    """
    env = os.environ.get("GROVE_FLASH_ATTENTION", "auto")
    if env == "0":
        return None
    # The kernel derives its causal mask from absolute positions from 0.
    if not isinstance(q_offset, int) or q_offset != 0:
        return None
    if seq % 128 != 0 or head_dim % 8 != 0:
        return None
    on_cuda = torch.device(device).type == "cuda"
    if env != "1" and not on_cuda:
        return None
    from grove_tpu_torch.ops.flash import flash_causal_attention

    def attn(q, k, v):
        return flash_causal_attention(q, k, v)

    attn.impl_name = "cuda-flash" if on_cuda else "flash-plain"
    return attn


def active_prefill_attention(seq: int, head_dim: int,
                             device: str | torch.device = "cpu") -> str:
    """Name of the attention ``pick_causal_attention`` would select."""
    fn = pick_causal_attention(seq, head_dim, device=device)
    return getattr(fn, "impl_name", "plain") if fn is not None else "plain"


def _group_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[b, s, h, d] -> [b, s, n_kv, group, d] view for GQA."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, q_offset: torch.Tensor | int = 0) -> torch.Tensor:
    """Causal GQA attention for prefill.

    q: [b, sq, h, d]; k, v: [b, skv, n_kv, d]. ``q_offset`` is the absolute
    position of q[0]: an int shared by the whole batch or a per-sequence
    [b] tensor. Scores are taken in f32 from the working-type scaled q
    (the JAX ``preferred_element_type=f32`` product); the probabilities are
    cast to v's type for the second product. The softmax's max is detached,
    as JAX's ``stop_gradient`` takes it: the forward's bits are the same,
    and the gradient takes no path through the max (a path whose sum is
    zero in exact arithmetic, not in floats, and which a tie at the max
    splits between the tied keys).
    """
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    skv = k.shape[1]
    qg = _group_heads(q, n_kv)  # [b, sq, n_kv, g, d]
    scale = d ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          (qg * scale).to(torch.float32),
                          k.to(torch.float32))
    kv_pos = torch.arange(skv, device=q.device)
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() >= 1:
        q_pos = (q_offset.to(q.device)[:, None, None]
                 + torch.arange(sq, device=q.device)[None, :, None])
        mask = q_pos >= kv_pos[None, None, :]          # [b, sq, skv]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    else:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = q_pos >= kv_pos[None, :]                # [sq, skv]
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-step attention against a (padded) KV cache.

    q: [b, 1, h, d]; caches: [b, max_len, n_kv, d]; lengths: [b], the
    number of valid cache entries per sequence (the new token's K/V
    already written).
    """
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = _group_heads(q, n_kv)[:, 0]  # [b, n_kv, g, d]
    scale = d ** -0.5
    logits = torch.einsum("bkgd,bskd->bkgs", (qg * scale).to(torch.float32),
                          k_cache.to(torch.float32))
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
             < lengths[:, None])  # [b, s]
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)
