"""Random weights of a Mixtral-shaped MoE from the run's seed, made on the
device in the type they are served in, in the layout
``grove_tpu_torch.serving.engine.make_engine`` takes for a ``MoeConfig``
(layers stacked on axis 0; the router [L, d, E], the experts ``we_gate``
and ``we_up`` [L, E, d, F], ``we_down`` [L, E, F, d]).

As ``weights.py``: every leaf a view of one buffer filled by a few large
``normal_`` calls of one ``torch.Generator`` on the device, then scaled in
place. The attention, embedding, head and norms as there (``wq`` at
``weights.WQ_GAIN`` times its fan-in scale); the router and the experts at
``fan_in ** -0.5``, so a normed row's router logits have unit spread and
its top-2 varies from token to token, and an expert's output keeps the
row's scale.
"""

from __future__ import annotations

import math

import torch

from benchmark import weights


def leaf_specs(cfg) -> list[tuple[tuple[str, ...], tuple[int, ...], str,
                                  float]]:
    """(path, shape, kind, scale) of every leaf: ``weights.leaf_specs``
    without the dense MLP, then the router and the experts."""
    d, ff, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
    dense_mlp = {"w_gate", "w_up", "w_down"}
    return [s for s in weights.leaf_specs(cfg) if s[0][-1] not in dense_mlp
            ] + [
        (("layers", "router"), (L, d, E), "normal", d ** -0.5),
        (("layers", "we_gate"), (L, E, d, ff), "normal", d ** -0.5),
        (("layers", "we_up"), (L, E, d, ff), "normal", d ** -0.5),
        (("layers", "we_down"), (L, E, ff, d), "normal", ff ** -0.5),
    ]


@torch.no_grad()
def make(cfg, seed: int, device: torch.device) -> dict:
    """The params dict, every leaf a view of one buffer of ``cfg.dtype``."""
    specs = leaf_specs(cfg)
    offsets, total = [], 0
    for _, shape, _, _ in specs:
        offsets.append(total)
        total += -(-math.prod(shape) // weights._ALIGN) * weights._ALIGN
    flat = torch.empty(total, dtype=cfg.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for start in range(0, total, weights._CHUNK):
        flat[start:start + weights._CHUNK].normal_(generator=gen)
    params: dict = {"layers": {}}
    for (path, shape, kind, scale), off in zip(specs, offsets):
        leaf = flat[off:off + math.prod(shape)].view(shape)
        if kind == "norm":
            leaf.mul_(scale).add_(1.0)
        else:
            leaf.mul_(scale)
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return params


@torch.no_grad()
def round_experts_int8_(params: dict) -> dict:
    """The control's experts: each (layer, expert) matrix of ``we_gate``,
    ``we_up`` and ``we_down`` rounded through int8 in place, in its own
    type (the program's ``quantize_tensor``: codes and a scale per output
    column, then ``materialize()``), the weights an int8 expert kernel
    would read. One matrix at a time in f32, so a model that fills the card
    is rounded beside itself. Returns ``params``."""
    from grove_tpu_torch.serving.quant import quantize_tensor
    layers = params["layers"]
    for name in ("we_gate", "we_up", "we_down"):
        w = layers[name]
        flat = w.view(-1, *w.shape[2:])
        for i in range(flat.shape[0]):
            flat[i].copy_(quantize_tensor(flat[i], (0,)).materialize())
    return params
