"""Pipeline parallelism: the GPipe microbatch schedule over the mesh's
``pp`` axis (the JAX package's ``parallel/pipeline.py``).

The stacked layers are cut over ``pp`` (stage s holds layers [s L/S,
(s + 1) L/S)), and activations hop from stage to stage by
``AxisComm.shift`` (a point-to-point send to the next stage). The
schedule runs M + S - 1 ticks: at tick t stage s works on microbatch
t - s. Stage 0 embeds; the last stage records its finished microbatches;
the records are summed over pp (only the last stage's are non-zero), and
every stage runs the final norm and the head. With a tp axis, each
stage's layers are tensor-parallel over it (heads and ff sharded, the
Megatron pair around each product) and the logits stay sharded by vocab.

Every rank makes the same autograd graph, as JAX's SPMD program is the
same on every stage: the stage-0 choice of the embedding and the last
stage's records are ``torch.where`` over a flag, not Python branches, so
that each hop's backward runs on every rank in the same order. A bubble's
layers are skipped (JAX computes them and masks the result to zeros); its
zeros stay tied to the stage's input with a zero gradient.

Plain PyTorch, differentiable; no hand-written kernel runs here.
"""

from __future__ import annotations

import torch

from grove_tpu_torch.models import llama
from grove_tpu_torch.parallel.mesh import AXIS_PP, AXIS_TP, Mesh, tie
from grove_tpu_torch.parallel.sharding import ShardedParams, _shard

# Per-leaf sharding of the stacked layer weights: the layers over pp, and
# the axis that carries heads, kv heads or ff over tp. Norms replicate.
_TP_LAYER_SPECS: dict[str, tuple] = {
    "attn_norm": (AXIS_PP,),
    "mlp_norm": (AXIS_PP,),
    "wq": (AXIS_PP, None, AXIS_TP, None),
    "wk": (AXIS_PP, None, AXIS_TP, None),
    "wv": (AXIS_PP, None, AXIS_TP, None),
    "wo": (AXIS_PP, AXIS_TP, None, None),
    "w_gate": (AXIS_PP, None, AXIS_TP),
    "w_up": (AXIS_PP, None, AXIS_TP),
    "w_down": (AXIS_PP, AXIS_TP, None),
}
# The rest: the embedding and the final norm whole on every rank, the head
# over tp by vocab.
_HEAD_SPECS: dict[str, tuple] = {
    "tok_embed": (),
    "final_norm": (),
    "lm_head": (None, AXIS_TP),
}


def stage_params(mesh: Mesh, params) -> ShardedParams:
    """This rank's slices of a Llama params tree for ``pipeline_forward``:
    its stage's layers (cut over tp as ``_TP_LAYER_SPECS`` says), the
    embedding and the final norm whole, its vocab slice of the head (JAX's
    ``in_specs``)."""
    out = ShardedParams(
        {name: _shard(mesh, params[name], spec)
         for name, spec in _HEAD_SPECS.items()})
    out["layers"] = {name: _shard(mesh, w, _TP_LAYER_SPECS[name])
                     for name, w in params["layers"].items()}
    out.layout = (mesh.plan, mesh.rank, "pipeline")
    return out


def pipeline_forward(cfg: llama.LlamaConfig, params, tokens: torch.Tensor,
                     mesh: Mesh, n_microbatches: int = 2) -> torch.Tensor:
    """Forward pass with the layers pipelined over the mesh's ``pp`` axis:
    logits [B, S, vocab / tp] f32, the same on every stage, this rank's
    vocab slice (rank r of tp holds ids [r V/tp, (r + 1) V/tp); the whole
    vocab without a tp axis). ``params`` are this rank's slices
    (``stage_params``), ``tokens`` [B, S] the whole batch on every rank,
    split into ``n_microbatches`` along B.

    Requires n_layers % pp == 0, batch % n_microbatches == 0 and, for tp
    > 1, heads, kv heads, ff and vocab divisible by tp (JAX's asserts). The
    dense-MLP Llama layout is expected. The loss over the vocab-sharded
    logits is ``llama.next_token_loss(logits, tokens, tp=mesh.comm("tp"))``.
    """
    pp_size, tp_size = mesh.shape[AXIS_PP], mesh.shape[AXIS_TP]
    if cfg.n_layers % pp_size:
        raise AssertionError(
            f"{cfg.n_layers} layers not divisible into {pp_size} stages")
    if tokens.shape[0] % n_microbatches:
        raise AssertionError(f"batch {tokens.shape[0]} does not divide into "
                             f"{n_microbatches} microbatches")
    if tp_size > 1 and (cfg.n_heads % tp_size or cfg.n_kv_heads % tp_size
                        or cfg.d_ff % tp_size or cfg.vocab_size % tp_size):
        raise AssertionError(
            f"heads/kv/ff/vocab not divisible by tp={tp_size}")
    held = params["layers"]["attn_norm"].shape[0]
    if held != cfg.n_layers // pp_size:
        raise ValueError(f"the params hold {held} layers, a stage has "
                         f"{cfg.n_layers // pp_size}: pass "
                         f"stage_params(mesh, params)")
    pp, tp = mesh.comm(AXIS_PP), mesh.comm(AXIS_TP)
    n_stages, stage = pp_size, mesh.coord(AXIS_PP)
    # The embedding is used by stage 0 alone; its gradient is summed over
    # the stages so that every stage holds it.
    params = llama.sum_leaf_grads(params, [pp], only=("tok_embed",))
    B, seq = tokens.shape
    mb = B // n_microbatches
    dev = tokens.device
    cos, sin = llama._rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                           dev)
    positions = torch.arange(seq, device=dev).expand(mb, seq)
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == n_stages - 1, device=dev)
    carry = torch.zeros((mb, seq, cfg.d_model), dtype=cfg.dtype, device=dev)
    outputs = [torch.zeros_like(carry) for _ in range(n_microbatches)]

    for t in range(n_microbatches + n_stages - 1):
        my_mb = t - stage
        active = 0 <= my_mb < n_microbatches
        # Stage 0 sources its input by embedding microbatch t (the table is
        # whole on every rank).
        e = min(t, n_microbatches - 1)
        embedded = llama.embed_train(cfg, params, tokens[e * mb:(e + 1) * mb])
        x_in = torch.where(first, embedded, carry)
        if active:
            x_out = llama.decoder_layers(cfg, params["layers"], x_in, cos,
                                         sin, positions, tp=tp)
        else:
            x_out = tie(torch.zeros_like(x_in), x_in)
        # The last stage records its finished microbatch.
        slot = min(max(my_mb, 0), n_microbatches - 1)
        record = torch.tensor(active, device=dev) & last
        outputs[slot] = torch.where(record, x_out, outputs[slot])
        carry = pp.shift(x_out) if pp is not None else x_out

    # Only the last stage holds real outputs; the sum over pp gives them to
    # every stage, each of which runs the final norm and the head (its
    # vocab slice under tp).
    x = torch.where(last, torch.cat(outputs), 0.0)
    if pp is not None:
        x = pp.reduce_from(x)
    return llama.head(cfg, params, x, tp)
