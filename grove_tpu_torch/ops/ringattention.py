"""Ring attention: causal attention with the sequence sharded over the
``sp`` mesh axis (the JAX package's ``ops/ringattention.py``).

Each rank keeps its query block while the K/V blocks travel around the sp
ring, one hop per step (``AxisComm.shift``: a point-to-point send to the
next rank and a receive from the previous one; NVLink neighbours where the
sp group sits on one host). The blocks' results merge by the online
softmax (log-sum-exp) rule, so memory stays O(s / sp) in the sequence,
whatever its total length.

Plain PyTorch, differentiable: the training path runs it, and autograd
carries the K/V cotangents back around the ring through the shift's
backward. No hand-written kernel runs here (the kernel wrappers refuse an
input that requires grad).
"""

from __future__ import annotations

import torch

from grove_tpu_torch.parallel.mesh import AXIS_SP, AxisComm, tie

NEG_INF = -1e30


def _block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int, kv_offset: int, scale: float):
    """Attention of the local queries against one K/V block: the block's
    un-normalised pieces (max, exp-sum, weighted values), all f32.

    q: [b, sq, h, d]; k, v: [b, sk, n_kv, d] (GQA: h = n_kv * group). The
    logits are f32 products of the working-type scaled q and k (JAX's
    ``preferred_element_type=f32``), masked to ``NEG_INF`` in the causal
    future; a row that the block masks whole contributes zero. The block's
    max is detached: it shifts the exponent and the result does not depend
    on it, so the gradient takes no path through it (as the port's
    ``causal_attention`` takes the softmax's max)."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          (qg * scale).to(torch.float32),
                          k.to(torch.float32))
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, :] + kv_offset
    logits = torch.where(q_pos >= kv_pos, logits, NEG_INF)
    block_max = logits.amax(dim=-1).detach()                 # [b,k,g,q]
    probs = torch.exp(logits - block_max[..., None])
    # Fully-masked rows: block_max == NEG_INF -> make their contribution 0.
    probs = torch.where((block_max == NEG_INF)[..., None], 0.0, probs)
    block_sum = probs.sum(dim=-1)                            # [b,k,g,q]
    block_out = torch.einsum("bkgqs,bskd->bkgqd", probs,
                             v.to(torch.float32))
    return block_max, block_sum, block_out


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          comm: AxisComm | None) -> torch.Tensor:
    """This rank's block of causal attention over the ring ``comm`` (None:
    a ring of one, no collective). Step s holds the K/V block that started
    s ranks behind: source (idx - s) % n, progressively older blocks, the
    causal-friendly order. A block wholly in the causal future skips its
    products (about (n - 1) / 2n of them); the hop still runs every step,
    n of them as in JAX's loop, so that every rank makes the same
    collectives. A skipped block's K/V stay tied into the graph with a zero
    gradient (``tie``): the hop that brought them runs its backward on
    every rank."""
    n = comm.size if comm is not None else 1
    idx = comm.rank if comm is not None else 0
    b, sq, h, d = q.shape
    n_kv, sk = k.shape[2], k.shape[1]
    g = h // n_kv
    scale = d ** -0.5
    q_offset = idx * sq
    stats = dict(dtype=torch.float32, device=q.device)
    acc_max = torch.full((b, n_kv, g, sq), NEG_INF, **stats)
    acc_sum = torch.zeros((b, n_kv, g, sq), **stats)
    acc_out = torch.zeros((b, n_kv, g, sq, d), **stats)
    kv = torch.stack([k, v])     # one hop carries both
    for step in range(n):
        src = (idx - step) % n
        if src * sk <= q_offset + sq - 1:
            bmax, bsum, bout = _block_attention(q, kv[0], kv[1], q_offset,
                                                src * sk, scale)
        else:
            bmax = torch.full((b, n_kv, g, sq), NEG_INF, **stats)
            bsum = torch.zeros((b, n_kv, g, sq), **stats)
            bout = tie(torch.zeros((b, n_kv, g, sq, d), **stats), kv)
        new_max = torch.maximum(acc_max, bmax)
        # Guard against (-inf) - (-inf) when a row has seen nothing yet.
        corr_old = torch.exp(torch.where(acc_max == NEG_INF, NEG_INF,
                                         acc_max - new_max))
        corr_new = torch.exp(torch.where(bmax == NEG_INF, NEG_INF,
                                         bmax - new_max))
        acc_sum = acc_sum * corr_old + bsum * corr_new
        acc_out = acc_out * corr_old[..., None] + bout * corr_new[..., None]
        acc_max = new_max
        kv = comm.shift(kv) if comm is not None else kv
    out = acc_out / acc_sum.clamp_min(1e-30)[..., None]
    # [b, k, g, q, d] -> [b, q, h, d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *, axis_name: str = AXIS_SP) -> torch.Tensor:
    """Causal GQA ring attention over the mesh's ``sp`` axis, on this rank's
    blocks: q [b/dp, s/sp, h/tp, d], k and v [b/dp, s/sp, n_kv/tp, d], the
    rank's contiguous sequence block at coordinate ``mesh.coord(sp)``.
    Returns its block of the output, q's shape and type."""
    return _ring_attention_local(q, k, v, mesh.comm(axis_name))
