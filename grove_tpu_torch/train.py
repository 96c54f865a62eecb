"""The one-card train step: AdamW over a params dict.

The twin of ``__graft_entry__.py``'s train step on one mesh group
(``optax.adamw(1e-3)`` over ``llama.loss_fn``'s gradient) and of its
``entry()``. ``make_optimizer`` gives ``torch.optim.AdamW`` optax's
defaults: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on every leaf
(optax's ``mask=None``). optax adds ``wd * p`` to the Adam update and torch
decays ``p`` first; both give ``p - lr * wd * p - lr * m_hat / (sqrt(v_hat)
+ eps)``. The moments stay in the params' dtype, as optax's
``mu_dtype=None`` keeps them. No ``torch.compile``, no fused or foreach
switch, no TF32: the f32 products stay f32.

The step makes no host sync: it returns the loss as a device tensor, and
the caller reads it when it wants it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.models import llama
from grove_tpu_torch.serving.quant import flatten_params

Params = dict[str, Any]


def param_leaves(params: Params) -> list[torch.Tensor]:
    """The params dict's tensors in key order (nested dicts walked)."""
    flat, qtensors = flatten_params(params)
    if qtensors:
        raise ValueError("int8 (QTensor) weights are for serving; "
                         "train the dense weights")
    return list(flat.values())


def make_optimizer(params: Params, lr: float = 1e-3) -> torch.optim.AdamW:
    """AdamW over every leaf of ``params`` with optax's ``adamw(lr)``
    defaults. Each leaf is made to require grad, in place: the optimizer
    updates the caller's tensors."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def train_step(cfg, params: Params, opt: torch.optim.Optimizer,
               tokens: torch.Tensor,
               loss: Callable = llama.loss_fn) -> torch.Tensor:
    """One step: the gradient of ``loss(cfg, params, tokens)`` and an
    optimizer update of ``params`` in place. Returns the loss (detached,
    on the params' device; not read here)."""
    opt.zero_grad(set_to_none=True)
    value = loss(cfg, params, tokens)
    value.backward()
    opt.step()
    return value.detach()


def flagship_config() -> llama.LlamaConfig:
    """The flagship architecture (the Llama family) at a compile-check
    scale: real GQA ratios and SwiGLU dims, small enough to run anywhere
    (``__graft_entry__._flagship_cfg``)."""
    return dataclasses.replace(
        llama.CONFIGS["test-tiny"],
        d_model=256, n_layers=4, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=512, max_seq_len=256,
    )


def entry(device: str | torch.device | None = None):
    """(fn, example_args): the flagship forward and its inputs, random
    params from seed 0 and a [2, 32] batch of token 0 on ``device`` (None
    means the card)."""
    dev = resolve_device(device)
    cfg = flagship_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, dev)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return llama.forward(cfg, params, tokens)

    return fn, (params, tokens)
