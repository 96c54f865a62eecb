"""The train step: AdamW over a params dict, on one card or as one rank of
a mesh; and the twins of ``__graft_entry__.py``'s ``entry()`` and
``dryrun_multichip``.

The step is ``__graft_entry__.py``'s (``optax.adamw(1e-3)`` over
``llama.loss_fn``'s gradient). Under a mesh the params are the rank's
slices and the loss's backward leaves each slice's gradient complete
(``models/llama.py``), so AdamW, which is elementwise, updates each slice
as optax updates the whole. ``make_optimizer`` gives ``torch.optim.AdamW`` optax's
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
import math
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
               tokens: torch.Tensor, loss: Callable = llama.loss_fn,
               **loss_kw) -> torch.Tensor:
    """One step: the gradient of ``loss(cfg, params, tokens, **loss_kw)``
    and an optimizer update of ``params`` in place. With ``mesh=`` among
    the keywords ``params`` are this rank's slices
    (``parallel/sharding.py``'s ``shard_params``), ``tokens`` the global
    batch, and the loss's other keywords choose the strategy
    (``ring=``/``sp=`` for ``llama.loss_fn``, ``ep=True`` for
    ``moe.loss_fn``). Returns the loss (detached, on the params' device;
    not read here)."""
    opt.zero_grad(set_to_none=True)
    value = loss(cfg, params, tokens, **loss_kw)
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


def _section(name: str, value: torch.Tensor, leaves) -> float:
    """The loss of a dry-run section, its gradients checked: the loss and
    every gradient finite, or AssertionError."""
    loss = float(value.detach())
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite {name} loss {loss}")
    if not all(bool(torch.isfinite(p.grad).all()) for p in leaves):
        raise AssertionError(f"non-finite {name} grads")
    return loss


def _with_grad(params: Params) -> list[torch.Tensor]:
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def dryrun_multichip(device: str | torch.device | None = None) -> str:
    """One sharded train step over a mesh of every rank, plus the other
    strategies' steps on sub-meshes: the twin of ``__graft_entry__.py``'s
    ``dryrun_multichip`` (:42-278), section for section. Every rank of an
    initialised process group calls it (``torchrun --nproc-per-node N`` on
    cards, NCCL; N gloo processes on the CPU); n is the world size, the
    params and tokens (random, from fixed seeds) are on ``device`` (None
    means the card).

    - the flagship config, ``plan = mesh_axes_for(n, max_tp=n_kv_heads)``,
      one AdamW(1e-3) step of ``loss_fn(mesh=, ring=plan.sp > 1)`` on a
      max(2, 2 dp) x 64 batch;
    - n >= 8: Ulysses on a (dp=2, sp=2, tp=2) mesh of ranks 0-7;
    - pp x tp (pp = 2 when n >= 2, tp = 2 when n >= 4) through
      ``pipeline_forward`` with 2 microbatches;
    - the dp x ep ``moe-test-tiny`` step with ``ep=True`` (ep = 4 when
      n >= 8, else 2);
    - n >= 8 and ``n_kv_heads % 4 == 0``: disaggregated serving across two
      tp = 4 groups (``_disagg_serve``).

    Each training section checks a finite loss and finite gradients, the
    serving section bitwise tokens; rank 0 prints JAX's ``dryrun_multichip
    ok: ...`` line with the same fields. Each rank returns the line as it
    saw it (rank 0's names every section; another rank's only those of the
    meshes it is in)."""
    import torch.distributed as dist

    from grove_tpu_torch.models import moe
    from grove_tpu_torch.parallel.mesh import (AXIS_TP, MeshPlan,
                                               build_mesh, mesh_axes_for)
    from grove_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                   stage_params)
    from grove_tpu_torch.parallel.sharding import shard_params

    dev = resolve_device(device)
    n = dist.get_world_size()
    gen = torch.Generator(device=dev)
    cfg = flagship_config()

    def init(c, mod, seed):
        return mod.init_params(c, gen.manual_seed(seed), dev)

    def randint(high, shape, seed):
        return torch.randint(0, high, shape, generator=gen.manual_seed(seed),
                             device=dev, dtype=torch.int32)

    # tp shards the kv heads: cap it at n_kv_heads so GQA stays shardable.
    plan = mesh_axes_for(n, max_tp=cfg.n_kv_heads)
    mesh = build_mesh(plan)
    params = shard_params(mesh, init(cfg, llama, 0))
    opt = make_optimizer(params)
    tokens = randint(cfg.vocab_size, (max(2, 2 * plan.dp), 64), 1)
    # sp > 1 takes the ring through the whole step (forward and backward).
    use_ring = plan.sp > 1
    loss = _section("plain", train_step(cfg, params, opt, tokens, mesh=mesh,
                                        ring=use_ring),
                    param_leaves(params))
    line = (f"dryrun_multichip ok: n={n} plan=(dp={plan.dp}, sp={plan.sp}, "
            f"tp={plan.tp}) ring={use_ring} loss={loss:.4f}")

    # Ulysses: the second sp strategy, two all-to-all exchanges.
    if n >= 8:
        uly_mesh = build_mesh(MeshPlan(dp=2, sp=2, tp=2), ranks=range(8))
        if uly_mesh is not None:
            p = shard_params(uly_mesh, init(cfg, llama, 6))
            leaves = _with_grad(p)
            value = llama.loss_fn(cfg, p, randint(cfg.vocab_size, (4, 64), 7),
                                  mesh=uly_mesh, sp="ulysses")
            value.backward()
            uly_loss = _section("ulysses", value, leaves)
            line += f" ulysses dp=2xsp=2xtp=2 uly_loss={uly_loss:.4f}"

    # Pipeline parallelism composed with tensor parallelism: the stages'
    # hops and the tp sums in one mesh.
    pp = 2 if n >= 2 and cfg.n_layers % 2 == 0 else 1
    pp_tp = 2 if n >= 4 and cfg.n_kv_heads % 2 == 0 else 1
    if pp > 1:
        pp_mesh = build_mesh(MeshPlan(pp=pp, tp=pp_tp),
                             ranks=range(pp * pp_tp))
        if pp_mesh is not None:
            p = stage_params(pp_mesh, init(cfg, llama, 2))
            leaves = _with_grad(p)
            toks = randint(cfg.vocab_size, (2, 32), 3)
            value = llama.next_token_loss(
                pipeline_forward(cfg, p, toks, pp_mesh, n_microbatches=2),
                toks, tp=pp_mesh.comm(AXIS_TP))
            value.backward()
            pp_loss = _section("pp", value, leaves)
            line += f" composed pp={pp}xtp={pp_tp} pp_loss={pp_loss:.4f}"

    # Expert parallelism: experts over the ep axis of a dp x ep mesh, the
    # tokens dispatched by all-to-all, the load-balance auxiliary.
    ep = 4 if n >= 8 else (2 if n >= 2 else 1)
    if ep > 1:
        ep_dp = max(1, n // ep) if n % ep == 0 else 1
        ep_mesh = build_mesh(MeshPlan(dp=ep_dp, ep=ep),
                             ranks=range(ep_dp * ep))
        if ep_mesh is not None:
            moe_cfg = moe.MOE_CONFIGS["moe-test-tiny"]
            p = shard_params(ep_mesh, init(moe_cfg, moe, 4))
            leaves = _with_grad(p)
            value = moe.loss_fn(moe_cfg, p,
                                randint(moe_cfg.vocab_size,
                                        (2 * ep_dp * ep, 16), 5),
                                mesh=ep_mesh, ep=True)
            value.backward()
            ep_loss = _section("ep", value, leaves)
            line += f" moe dp={ep_dp}xep={ep} ep_loss={ep_loss:.4f}"

    if n >= 8 and cfg.n_kv_heads % 4 == 0 and _disagg_serve(
            cfg, dev, init(cfg, llama, 8),
            randint(cfg.vocab_size, (2, 16), 9)):
        line += " disagg prefill-mesh=tp4 decode-mesh=tp4 tokens-match"

    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


def _p2p(peer: int, sends=(), recvs=()) -> None:
    """Send ``sends`` to and receive ``recvs`` (in place) from the default
    group's rank ``peer``, in one batch, in order."""
    import torch.distributed as dist
    ops = ([dist.P2POp(dist.isend, t.contiguous(), peer) for t in sends]
           + [dist.P2POp(dist.irecv, t, peer) for t in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()


@torch.no_grad()
def _disagg_serve(cfg, dev: torch.device, raw: Params,
                  prompt: torch.Tensor, cache_len: int = 64,
                  n_steps: int = 8) -> bool:
    """``__graft_entry__.py``'s disaggregated serving (:202-278) on ranks
    0-7: ranks 0-3 form the prefill group and ranks 4-7 the decode group,
    each a tp = 4 mesh over ``shard_params`` of ``raw``. The prefill group
    runs the lanes ``llama.prefill`` of ``prompt`` [b, s] into a
    ``cache_len``-row cache; each of its ranks hands its K/V heads, the
    lengths and the first token to the decode rank of the same tp
    coordinate (rank + 4), whose group decodes ``n_steps`` greedy steps.
    The prefill group's own prefill and decode is the single-mesh
    reference: each pair of ranks swaps its tokens, and both compare them
    on the host, bitwise. True on ranks 0-7 (False past them); raises if
    the tokens differ. Every rank makes the two groups, in one order."""
    import torch.distributed as dist

    from grove_tpu_torch.ops.kvcache import KVCache
    from grove_tpu_torch.parallel.mesh import AXIS_TP, MeshPlan, build_mesh
    from grove_tpu_torch.parallel.sharding import shard_params

    pf_mesh = build_mesh(MeshPlan(tp=4), ranks=range(4))
    dec_mesh = build_mesh(MeshPlan(tp=4), ranks=range(4, 8))
    mesh = pf_mesh or dec_mesh
    if mesh is None:
        return False
    tp = mesh.comm(AXIS_TP)
    params = shard_params(mesh, raw)
    b, s = prompt.shape
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)

    def empty_cache() -> KVCache:
        return KVCache.create(cfg.n_layers, b, cache_len,
                              cfg.n_kv_heads // tp.size, cfg.head_dim,
                              cfg.dtype, dev)

    def greedy(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def prefill() -> tuple[torch.Tensor, KVCache]:
        logits, cache = llama.prefill(cfg, params, prompt, empty_cache(),
                                      lengths, tp=tp)
        return greedy(logits), cache

    def decode_n(tok: torch.Tensor, cache: KVCache) -> torch.Tensor:
        toks = []
        for _ in range(n_steps):
            logits, cache = llama.decode_step(cfg, params, tok, cache, tp=tp)
            tok = greedy(logits)
            toks.append(tok)
        return torch.stack(toks)                          # [steps, b]

    rank = dist.get_rank()
    if pf_mesh is not None:
        peer = rank + 4
        tok0, cache = prefill()                           # the handoff
        _p2p(peer, sends=(cache.k, cache.v, cache.lengths, tok0))
        ref_tok0, ref_cache = prefill()                   # single-mesh
        if not torch.equal(tok0, ref_tok0):
            raise AssertionError("prefill tokens diverge")
        mine = decode_n(ref_tok0, ref_cache)
    else:
        peer = rank - 4
        cache, tok0 = empty_cache(), torch.empty_like(lengths)
        _p2p(peer, recvs=(cache.k, cache.v, cache.lengths, tok0))
        mine = decode_n(tok0, cache)
    theirs = torch.empty_like(mine)
    _p2p(peer, sends=(mine,), recvs=(theirs,))
    a, r = mine.cpu().numpy(), theirs.cpu().numpy()
    if not (a == r).all():
        raise AssertionError(f"disagg decode diverges from the single-mesh "
                             f"reference (rank {rank}):\n{a}\nvs\n{r}")
    return True
