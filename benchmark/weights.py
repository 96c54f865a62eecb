"""Random weights from the run's seed, made on the device in the type they
are served in, in the layout ``grove_tpu_torch.serving.engine.make_engine``
takes as params (layers stacked on axis 0, ``wq`` as [L, d, h, hd]).

All leaves are views of one buffer filled by a few large ``normal_`` calls
of one ``torch.Generator`` on the device, then scaled in place:

- projections at ``fan_in ** -0.5``, so a normed row keeps unit scale;
- ``wq`` at twice that, so that attention scores spread (standard
  deviation about 2) and a head attends to tens of positions instead of
  averaging a few thousand: attention then moves the logits, and a fault in
  the paged cache or its kernels shows in the comparison;
- the embedding at unit scale; norm weights ``1 + 0.1 * N(0, 1)``, so a
  path that dropped a norm's weight would show too.
"""

from __future__ import annotations

import math

import torch

# Elements per normal_ call (a few calls for a 9 B model) and the alignment
# of each leaf inside the buffer (elements: 2 KiB in bf16).
_CHUNK = 1 << 30
_ALIGN = 1024
WQ_GAIN = 2.0


def leaf_specs(cfg) -> list[tuple[tuple[str, ...], tuple[int, ...], str,
                                  float]]:
    """(path, shape, kind, scale) of every leaf; kind is "normal" or
    "norm"."""
    d, h, kv, hd, ff, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.n_layers,
                              cfg.vocab_size)
    return [
        (("tok_embed",), (V, d), "normal", 1.0),
        (("lm_head",), (d, V), "normal", d ** -0.5),
        (("final_norm",), (d,), "norm", 0.1),
        (("layers", "attn_norm"), (L, d), "norm", 0.1),
        (("layers", "mlp_norm"), (L, d), "norm", 0.1),
        (("layers", "wq"), (L, d, h, hd), "normal", WQ_GAIN * d ** -0.5),
        (("layers", "wk"), (L, d, kv, hd), "normal", d ** -0.5),
        (("layers", "wv"), (L, d, kv, hd), "normal", d ** -0.5),
        (("layers", "wo"), (L, h, hd, d), "normal", (h * hd) ** -0.5),
        (("layers", "w_gate"), (L, d, ff), "normal", d ** -0.5),
        (("layers", "w_up"), (L, d, ff), "normal", d ** -0.5),
        (("layers", "w_down"), (L, ff, d), "normal", ff ** -0.5),
    ]


@torch.no_grad()
def make(cfg, seed: int, device: torch.device) -> dict:
    """The params dict, every leaf a view of one buffer of ``cfg.dtype``."""
    specs = leaf_specs(cfg)
    offsets, total = [], 0
    for _, shape, _, _ in specs:
        offsets.append(total)
        total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    flat = torch.empty(total, dtype=cfg.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for start in range(0, total, _CHUNK):
        flat[start:start + _CHUNK].normal_(generator=gen)
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
