"""Ulysses (all-to-all) sequence parallelism, the second sp strategy (the
JAX package's ``ops/ulysses.py``).

Activations arrive sharded over ``sp`` by sequence; one all-to-all
re-shards them by head and assembles the full sequence on every rank, the
plain causal attention runs on the rank's heads, and the inverse exchange
restores the sequence sharding. Against ring attention: two exchanges in
all instead of sp hops (q, k and v travel in one), the full sequence of
the rank's heads resident (O(s) memory, where the ring keeps O(s / sp)),
and the heads must divide over sp.

Plain PyTorch, differentiable (the exchange's backward is the exchange
back); no hand-written kernel runs here.
"""

from __future__ import annotations

import torch

from grove_tpu_torch.ops.attention import causal_attention
from grove_tpu_torch.parallel.mesh import AXIS_SP, AxisComm


def _ulysses_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   comm: AxisComm | None) -> torch.Tensor:
    """This rank's block: q [b, s_l, h_l, d], k and v [b, s_l, n_kv_l, d],
    h_l and n_kv_l the rank's heads after tp; sp divides them again for the
    attention. Shards hold contiguous sequence blocks in axis order, so
    joining the received blocks in source order gives positions 0..s-1.
    ``comm`` None is an sp axis of one: the plain attention."""
    sp = comm.size if comm is not None else 1
    h_l, n_kv_l = q.shape[2], k.shape[2]
    if h_l % sp or n_kv_l % sp:
        raise AssertionError(
            f"ulysses needs heads divisible by sp={sp}: have q heads {h_l}, "
            f"kv heads {n_kv_l} per member (use ring attention otherwise)")
    if comm is None:
        return causal_attention(q, k, v)
    b, s_l, _, d = q.shape
    hq, hk = h_l // sp, n_kv_l // sp
    # Gather the sequence, scatter the heads: chunk i of each tensor's heads
    # goes to rank i, q, k and v side by side in one exchange.
    packed = torch.cat([q.reshape(b, s_l, sp, hq, d),
                        k.reshape(b, s_l, sp, hk, d),
                        v.reshape(b, s_l, sp, hk, d)], dim=3)
    recv = comm.all_to_all(packed.permute(2, 0, 1, 3, 4))
    full = recv.permute(1, 0, 2, 3, 4).reshape(b, sp * s_l, hq + 2 * hk, d)
    qf, kf, vf = full.split([hq, hk, hk], dim=2)
    out = causal_attention(qf, kf, vf)               # [b, s, h_l / sp, d]
    # Inverse: gather the heads, scatter the sequence.
    back = comm.all_to_all(out.reshape(b, sp, s_l, hq, d)
                           .permute(1, 0, 2, 3, 4))
    return back.permute(1, 2, 0, 3, 4).reshape(b, s_l, h_l, d)


def ulysses_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *,
                      axis_name: str = AXIS_SP) -> torch.Tensor:
    """Causal GQA attention with all-to-all sequence parallelism over the
    mesh's ``sp`` axis, on this rank's blocks (the contract of
    ``ring_attention``): q [b/dp, s/sp, h/tp, d], k and v [b/dp, s/sp,
    n_kv/tp, d]; returns q's block of the output."""
    return _ulysses_local(q, k, v, mesh.comm(axis_name))
