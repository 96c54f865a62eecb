"""Mixture-of-Experts decoder (Mixtral-shaped): the second model family.

The JAX package's ``grove_tpu/models/moe.py``: the Llama attention stack
with the MLP replaced by a top-k token-choice router over E experts.

Serving: the paged engine (``make_engine(cfg, params, mode="paged")``)
serves a ``MoeConfig`` and its params through ``models/llama.py``'s paged
functions, whose decoder runs a layer's routed experts in the MLP's place
wherever the layer holds a ``router`` (``llama._ffn``): the hand-written
route, grouped expert GEMM and combine of ``ops/moe.py`` on the card,
inside the engine's CUDA graphs, their plain versions on the CPU. The
training paths below stay plain PyTorch.

Training: two paths share one decoder skeleton (``_decoder_stack``), whose
only difference is the MoE function of each layer:

- dense (the default): every expert evaluated for every token, combined by
  router weight (static shapes, no gather or scatter);
- expert-parallel (``forward(..., mesh=mesh, ep=True)``): GShard-style
  dispatch over the mesh's ``ep`` axis. Tokens are bucketed per expert
  with a capacity factor (an assignment past a bucket's capacity drops, as
  in Switch/GShard), exchanged by ``all_to_all``, run through the rank's
  experts and returned by the inverse exchange; the Switch load-balance
  auxiliary keeps the router from collapsing onto few experts.

Like the training path of ``models/llama.py``, everything here is plain
PyTorch and differentiable; nothing reaches a hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.models import llama
from grove_tpu_torch.models.llama import LlamaConfig
from grove_tpu_torch.ops.attention import causal_attention
from grove_tpu_torch.ops.norms import rms_norm_ref
from grove_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_PP,
                                           AXIS_SP, AXIS_TP)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2

    @property
    def mlp_params(self) -> int:
        """Weights one token passes through in a layer's expert block: its
        k experts' SwiGLU and the router."""
        return (self.experts_per_token * 3 * self.d_model * self.d_ff
                + self.d_model * self.n_experts)

    @property
    def stored_mlp_params(self) -> int:
        """Weights a layer's expert block stores: every expert and the
        router (``params_bytes`` counts these)."""
        return (self.n_experts * 3 * self.d_model * self.d_ff
                + self.d_model * self.n_experts)


MOE_CONFIGS: dict[str, MoeConfig] = {
    "moe-test-tiny": MoeConfig(vocab_size=256, d_model=64, n_layers=2,
                               n_heads=8, n_kv_heads=4, d_ff=96, head_dim=8,
                               max_seq_len=128, n_experts=4,
                               experts_per_token=2),
    # Mixtral-8x7B-shaped.
    "mixtral-8x7b": MoeConfig(vocab_size=32000, d_model=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, d_ff=14336,
                              head_dim=128, max_seq_len=8192, n_experts=8,
                              experts_per_token=2),
}


def init_params(cfg: MoeConfig, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> Params:
    """Llama attention and embedding params plus the router and the stacked
    experts, drawn from ``generator`` (on ``device``; None means the card)
    after the Llama leaves. The dense MLP is never allocated."""
    dev = resolve_device(device)
    base = llama.init_params(cfg, generator, dev, include_mlp=False)
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(shape, fan_in):
        return llama.dense_init(cfg, shape, fan_in, generator, dev)

    layers = base["layers"]
    layers["router"] = dense((L, d, E), d)
    layers["we_gate"] = dense((L, E, d, ff), d)
    layers["we_up"] = dense((L, E, d, ff), d)
    layers["we_down"] = dense((L, E, ff, d), ff)
    return base


def _moe_block(cfg: MoeConfig, x: torch.Tensor, lp: Params) -> torch.Tensor:
    """Top-k routed expert MLP with the residual. x: [b, s, d]. The router's
    logits are f32 (the working-type values upcast, JAX's
    ``preferred_element_type=f32``); ``torch.topk`` takes the k largest in
    descending order, as ``lax.top_k``."""
    hm = rms_norm_ref(x, lp["mlp_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,de->bse", hm.to(torch.float32),
                          lp["router"].to(torch.float32))
    top_vals, top_idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    gate_w = torch.softmax(top_vals, dim=-1)                  # [b, s, k]
    # Dense weight mask over experts: [b, s, E].
    one_hot = F.one_hot(top_idx, cfg.n_experts).to(gate_w.dtype)
    weights = torch.einsum("bsk,bske->bse", gate_w, one_hot)
    # Every expert for every token, combined by weight (static shapes).
    gate = llama._einsum("bsd,edf->besf", hm, lp["we_gate"])
    up = llama._einsum("bsd,edf->besf", hm, lp["we_up"])
    expert_out = llama._einsum("besf,efd->besd", F.silu(gate) * up,
                               lp["we_down"])
    out = torch.einsum("bse,besd->bsd", weights.to(expert_out.dtype),
                       expert_out)
    return x + out.to(x.dtype)


def router_load_balance_loss(router_logits: torch.Tensor,
                             top_idx: torch.Tensor,
                             n_experts: int) -> torch.Tensor:
    """Switch-Transformer auxiliary loss: E * sum_e f_e * p_e, least at
    uniform routing; f_e is the fraction of assignments to expert e, p_e
    its mean router probability."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    p = probs.reshape(-1, n_experts).mean(dim=0)
    counts = F.one_hot(top_idx.reshape(-1).to(torch.long),
                       n_experts).to(torch.float32).mean(dim=0)
    return n_experts * torch.sum(counts * p)


def _ep_moe_block(cfg: MoeConfig, x: torch.Tensor, lp: Params,
                  capacity_factor: float, ep=None,
                  kept: list | None = None):
    """Expert-parallel routed MLP with the residual (GShard dispatch), and
    the layer's load-balance auxiliary. x: [bl, s, d], this rank's tokens.
    Experts are sharded over the ep axis (``ep``, an ``AxisComm``; None is
    an axis of one with no collective): ``lp["we_*"]`` are the rank's
    [E/ep, ...] slices, global expert e living on rank e // (E/ep).

    Static capacity buckets: each expert takes at most ``capacity`` =
    max(1, ceil(n k / E * capacity_factor)) of the rank's assignments, in
    assignment order (a cumulative sum); one past it goes to slot
    ``capacity``, a row of a ``capacity + 1`` buffer that is cut before
    the exchange (JAX's ``.at[].set(mode="drop")``), and reads a zero pad
    row on the way back: the token keeps its residual only. ``kept``, where
    given, gets each assignment's kept flag [n k] (detached)."""
    n_ep = ep.size if ep is not None else 1
    E, k = cfg.n_experts, cfg.experts_per_token
    El = E // n_ep
    bl, s, d = x.shape
    n = bl * s
    capacity = max(1, int(math.ceil(n * k / E * capacity_factor)))

    hm = rms_norm_ref(x, lp["mlp_norm"], cfg.norm_eps).reshape(n, d)
    logits = torch.einsum("nd,de->ne", hm.to(torch.float32),
                          lp["router"].to(torch.float32))
    top_vals, top_idx = torch.topk(logits, k, dim=-1)         # [n, k]
    gate_w = torch.softmax(top_vals, dim=-1)
    flat_e = top_idx.reshape(-1)                              # [n k]
    flat_w = gate_w.reshape(-1).to(hm.dtype)

    # Each assignment's position in its expert's bucket; past capacity ->
    # slot ``capacity``, the cut row.
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    pos_in_e = torch.take_along_dim(pos, flat_e[:, None], dim=1)[:, 0]
    slot = torch.where(pos_in_e < capacity, pos_in_e, capacity)
    if kept is not None:
        kept.append((slot < capacity).detach())

    toks = hm.repeat_interleave(k, dim=0)                     # [n k, d]
    buckets = hm.new_zeros((E, capacity + 1, d)).index_put(
        (flat_e, slot), toks)[:, :capacity]

    # Dispatch: the bucket of global expert j El + e goes to ep rank j.
    send = buckets.reshape(n_ep, El, capacity, d)
    recv = ep.all_to_all(send) if ep is not None else send
    # recv[i, e] = rank i's bucket for my local expert e.
    expert_in = recv.transpose(0, 1).reshape(El, n_ep * capacity, d)
    g = llama._einsum("ecd,edf->ecf", expert_in, lp["we_gate"])
    u = llama._einsum("ecd,edf->ecf", expert_in, lp["we_up"])
    out = llama._einsum("ecf,efd->ecd", F.silu(g) * u, lp["we_down"])
    # Return: the inverse exchange restores [E, capacity, d] on each rank.
    back = out.reshape(El, n_ep, capacity, d).transpose(0, 1)
    mine = (ep.all_to_all(back) if ep is not None else back)
    mine = mine.reshape(E, capacity, d)

    # Gather per assignment; dropped slots read the zero pad row.
    padded = F.pad(mine, (0, 0, 0, 1))
    out_assign = padded[flat_e, slot] * flat_w[:, None]
    moe_out = out_assign.reshape(n, k, d).sum(dim=1)
    return (x + moe_out.reshape(bl, s, d).to(x.dtype),
            router_load_balance_loss(logits, top_idx, E))


def _decoder_stack(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
                   moe_fn, aux0):
    """The shared decoder skeleton (embed -> [attention + MoE] x L -> norm
    -> head), one copy for both paths: ``moe_fn(x, lp)`` -> (x, layer_aux)
    is their only difference. Returns (logits f32, the auxiliary meaned
    over the layers)."""
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    cos, sin = llama._rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                           dev)
    x = llama.embed(cfg, params, tokens)
    aux = aux0
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = llama.layer_params(layers, i)
        q, k, v = llama.qkv(cfg, x, lp, cos, sin, positions)
        x = llama.attn_out(x, causal_attention(q, k, v), lp)
        x, layer_aux = moe_fn(x, lp)
        aux = aux + layer_aux
    return llama.head(cfg, params, x), aux / cfg.n_layers


def forward(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
            mesh=None, ep: bool = False,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Full forward: logits f32, differentiable. Without ``ep`` the dense
    path on the params given, [b, s, vocab] (``mesh`` and
    ``capacity_factor`` unused, as in JAX). ``ep=True`` (a mesh with an ep
    axis > 1) is ``ep_forward``'s rank block of the logits."""
    if not ep:
        logits, _ = _decoder_stack(
            cfg, params, tokens,
            lambda x, lp: (_moe_block(cfg, x, lp), 0.0), 0.0)
        return logits
    logits, _ = ep_forward(cfg, params, tokens, mesh,
                           capacity_factor=capacity_factor)
    return logits


EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def _ep_guard(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
              mesh) -> tuple[int, int]:
    """JAX's ``ep_forward`` guards, with its messages and exception types;
    then the params must hold the rank's experts. Returns (dp, ep)."""
    if mesh is None:
        raise AssertionError("ep path needs the mesh")
    shape = dict(mesh.shape)
    ep_size = shape.get(AXIS_EP, 1)
    if ep_size <= 1:
        raise AssertionError(f"mesh has no ep axis > 1 (shape {shape})")
    if cfg.n_experts % ep_size:
        raise AssertionError(
            f"ep={ep_size} must divide n_experts={cfg.n_experts}")
    # The body is dp x ep only: a mesh with pp/sp/tp > 1 would replicate
    # the whole forward over those axes. Refuse instead.
    other = {a: s for a in (AXIS_PP, AXIS_SP, AXIS_TP)
             if (s := shape.get(a, 1)) > 1}
    if other:
        raise AssertionError(
            f"ep_forward composes with dp only; mesh has {other} — use a "
            "dp×ep mesh (MoE tensor/pipeline parallelism inside the expert "
            "shards is not implemented)")
    dp_size = shape.get(AXIS_DP, 1)
    if tokens.shape[0] % (dp_size * ep_size):
        raise AssertionError(f"dp*ep={dp_size * ep_size} must divide batch "
                             f"{tokens.shape[0]}")
    held = params["layers"]["we_gate"].shape[1]
    if held != cfg.n_experts // ep_size:
        raise ValueError(
            f"the params hold {held} experts per rank, want "
            f"{cfg.n_experts // ep_size}: pass this rank's slices "
            f"(parallel/sharding.py shard_params)")
    return dp_size, ep_size


def _ep_local(cfg: MoeConfig, params: Params, tokens: torch.Tensor, mesh,
              capacity_factor: float, kept: list | None = None):
    """This rank's block: (logits [B/(dp ep), S, V], its auxiliary, its
    first row, the token axes). The batch is split over dp x ep, dp major
    (JAX's ``P((dp, ep))``); attention is local to the rank's rows. The
    leaves every rank holds whole sum their gradients over dp and ep; the
    experts, which the rank holds alone on ep, over dp."""
    dp_size, ep_size = _ep_guard(cfg, params, tokens, mesh)
    rows = tokens.shape[0] // (dp_size * ep_size)
    r0 = (mesh.coord(AXIS_DP) * ep_size + mesh.coord(AXIS_EP)) * rows
    dp, ep = mesh.comm(AXIS_DP), mesh.comm(AXIS_EP)
    params = llama.sum_leaf_grads(params, [dp, ep], skip=EXPERT_LEAVES)
    params = llama.sum_leaf_grads(params, [dp], only=EXPERT_LEAVES)
    logits, aux = _decoder_stack(
        cfg, params, tokens[r0:r0 + rows],
        lambda x, lp: _ep_moe_block(cfg, x, lp, capacity_factor, ep, kept),
        0.0)
    return logits, aux, r0, [dp, ep]


def ep_forward(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
               mesh, capacity_factor: float = 1.25
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel forward -> (this rank's logits block [B/(dp ep), S,
    vocab] f32: the batch rows of its (dp, ep) coordinate, dp major; the
    load-balance auxiliary meaned over the dp x ep ranks, the same on every
    rank). ``params`` are the rank's slices (``shard_params``: experts over
    ep), ``tokens`` the global batch on every rank."""
    logits, aux, _, axes = _ep_local(cfg, params, tokens, mesh,
                                     capacity_factor)
    aux = aux / (mesh.shape[AXIS_DP] * mesh.shape[AXIS_EP])
    for comm in axes:
        if comm is not None:
            aux = comm.reduce_from(aux)
    return logits, aux


def loss_fn(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
            mesh=None, ep: bool = False, aux_weight: float = 0.01,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Next-token loss; on the ep path the Switch load-balance auxiliary is
    added (weight ``aux_weight``), and ``capacity_factor`` is the experts'
    bucket headroom (raise it while an early unbalanced router is still
    dropping tokens). The dense path takes neither, as in JAX. On the ep
    path the loss is global, the same on every rank, and after
    ``backward()`` each leaf's ``.grad`` is the rank's slice of the global
    gradient."""
    if not ep:
        return llama.next_token_loss(forward(cfg, params, tokens), tokens)
    logits, aux, r0, axes = _ep_local(cfg, params, tokens, mesh,
                                      capacity_factor)
    B, S = tokens.shape
    n = mesh.shape[AXIS_DP] * mesh.shape[AXIS_EP]
    nll = llama.nll_sum(logits[:, :-1], tokens[r0:r0 + logits.shape[0], 1:])
    loss = nll / (B * (S - 1)) + aux_weight * aux / n
    for comm in axes:
        if comm is not None:
            loss = comm.reduce_from(loss)
    return loss
