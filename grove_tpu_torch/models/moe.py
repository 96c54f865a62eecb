"""Mixture-of-Experts decoder (Mixtral-shaped): the second model family,
its dense path.

The JAX package's ``grove_tpu/models/moe.py`` with ``ep=False``: the Llama
attention stack with the MLP replaced by a top-k token-choice routed MLP
over stacked experts, every expert evaluated for every token and the
outputs combined by router weight (static shapes, no gather or scatter).
It runs on one device, in training only: no serving engine builds a MoE
model. The expert-parallel path (``_ep_moe_block``, ``ep_forward``: token
dispatch by ``all_to_all`` across devices) is not ported yet, and
``ep=True`` raises (ROADMAP.md, queue 1 item 6).

Like the training path of ``models/llama.py``, everything here is plain
PyTorch and differentiable; nothing reaches a hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.models import llama
from grove_tpu_torch.models.llama import LlamaConfig
from grove_tpu_torch.ops.attention import causal_attention
from grove_tpu_torch.ops.norms import rms_norm_ref

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2


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


def forward(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
            mesh=None, ep: bool = False) -> torch.Tensor:
    """Full forward: logits [b, s, vocab] f32, differentiable. ``ep=True``
    (expert parallelism) and ``mesh`` raise: not ported yet."""
    if ep or mesh is not None:
        raise NotImplementedError(llama.PARALLEL_NOT_PORTED)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    cos, sin = llama._rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                           dev)
    x = llama.embed(cfg, params, tokens)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = llama.layer_params(layers, i)
        q, k, v = llama.qkv(cfg, x, lp, cos, sin, positions)
        x = llama.attn_out(x, causal_attention(q, k, v), lp)
        x = _moe_block(cfg, x, lp)
    return llama.head(cfg, params, x)


def loss_fn(cfg: MoeConfig, params: Params, tokens: torch.Tensor,
            mesh=None, ep: bool = False) -> torch.Tensor:
    """Next-token loss of the dense path (the load-balance auxiliary joins
    it on the expert-parallel path only, which is not ported yet)."""
    return llama.next_token_loss(forward(cfg, params, tokens, mesh, ep),
                                 tokens)
