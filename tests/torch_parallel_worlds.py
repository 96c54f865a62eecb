"""The ranks of the gloo worlds that the port's parallel tests read
(tests/test_torch_{ringattention,ulysses,pipeline,moe_ep,parallel_train,
lanes_tp}.py).

``shared_run`` starts one world per size in ``WORLDS`` (2, 4 and 8 ranks,
``spawn``) once per test session: the first test file to ask runs them
under a file lock, the others read what they wrote. Each rank joins a gloo
group through a ``file://`` rendezvous, runs every scenario of its world
size in one order (``SCENARIOS``) on inputs it makes itself from numpy
seeds (``inputs``), and writes what it saw: arrays to ``rank{r}.npz``,
the rest to ``rank{r}.json``. This module imports no JAX: only the test
files compare with the JAX package, on the same numpy inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import fcntl
import io
import json
import multiprocessing
import os
import time
import traceback

import numpy as np

WORLDS = (2, 4, 8)
TIMEOUT = 240.0

# Attention inputs: JAX's own ring and Ulysses tests' shapes.
RING_SHAPE = dict(b=2, s=32, h=4, n_kv=2, d=16)
ULYSSES_SHAPE = dict(b=2, s=32, h=16, n_kv=8, d=16)
# (dp, sp, tp) plans by world size.
RING_PLANS = {8: ((1, 4, 2), (2, 2, 2), (1, 8, 1))}
ULYSSES_PLANS = {8: ((1, 4, 2), (2, 2, 2)), 2: ((1, 2, 1),)}
# llama.loss_fn(mesh=) cases: name -> (world, (dp, sp, tp), sp strategy).
TRAIN_CASES = {"ring_222": (8, (2, 2, 2), "ring"),
               "ulysses_222": (8, (2, 2, 2), "ulysses"),
               "tp4": (4, (1, 1, 4), None)}
TRAIN_TOKENS = (4, 16)
# pipeline_forward cases: name -> (world, pp, tp, n_microbatches).
PIPE_CASES = {"pp2": (2, 2, 1, 2), "pp4": (4, 4, 1, 2),
              "pp2xtp2": (4, 2, 2, 2)}
PIPE_TOKENS = (4, 16)
# The expert-parallel cases, on a dp=2 x ep=4 world of 8.
EP_PLAN = (2, 4)
EP_TOKENS = (8, 16)
# The single-block drop check: a tight capacity, top-1 and top-2 routing.
EP_TIGHT = 0.5
EP_BLOCK_ROWS = (2, 8)          # each rank's [rows, s] of the block input
# The lanes model functions under tp (the flagship config in f32): a ragged
# batch right-padded to LANES_TOKENS[1], prefilled one-shot and in chunks
# into a LANES_CACHE-row cache, then LANES_STEPS greedy decode steps.
LANES_WORLDS = (2, 4)
LANES_TOKENS = (3, 16)
LANES_LENGTHS = (16, 9, 13)
LANES_CACHE = 32
LANES_CHUNK = 8
LANES_STEPS = 8


# ---- inputs, from numpy seeds (the parent makes the same) ----

def llama_config(n_layers: int = 2):
    import torch

    from grove_tpu_torch.models import llama
    return dataclasses.replace(llama.CONFIGS["test-tiny"],
                               dtype=torch.float32, n_layers=n_layers)


def moe_config(experts_per_token: int = 2):
    import torch

    from grove_tpu_torch.models import moe
    return dataclasses.replace(moe.MOE_CONFIGS["moe-test-tiny"],
                               dtype=torch.float32,
                               experts_per_token=experts_per_token)


def np_params(cfg: dict, seed: int, moe: bool = False) -> dict:
    """A params tree in the JAX layout, numpy f32: dense weights normal
    over sqrt(fan-in), norms 1 + 0.1 normal (not ones, so that their
    gradients differ across positions). ``cfg`` holds the config's
    fields."""
    rng = np.random.default_rng(seed)
    L, d, h, kv = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd, ff, V = cfg["head_dim"], cfg["d_ff"], cfg["vocab_size"]

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    def norm(shape):
        return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    layers = {"attn_norm": norm((L, d)), "mlp_norm": norm((L, d)),
              "wq": dense((L, d, h, hd), d), "wk": dense((L, d, kv, hd), d),
              "wv": dense((L, d, kv, hd), d),
              "wo": dense((L, h, hd, d), h * hd)}
    if moe:
        E = cfg["n_experts"]
        layers.update(router=dense((L, d, E), d),
                      we_gate=dense((L, E, d, ff), d),
                      we_up=dense((L, E, d, ff), d),
                      we_down=dense((L, E, ff, d), ff))
    else:
        layers.update(w_gate=dense((L, d, ff), d), w_up=dense((L, d, ff), d),
                      w_down=dense((L, ff, d), ff))
    return {"tok_embed": dense((V, d), d), "lm_head": dense((d, V), d),
            "final_norm": norm((d,)), "layers": layers}


def np_tokens(shape, vocab: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def np_qkv(shape: dict, seed: int):
    rng = np.random.default_rng(seed)
    b, s, h, kv, d = (shape[k] for k in ("b", "s", "h", "n_kv", "d"))
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def config_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


def lanes_config():
    import torch

    from grove_tpu_torch.train import flagship_config
    return dataclasses.replace(flagship_config(), dtype=torch.float32)


def lanes_inputs(seed: int = 0):
    """The flagship config in f32, its numpy params and the prompts."""
    cfg = lanes_config()
    return (cfg, np_params(config_fields(cfg), seed),
            np_tokens(LANES_TOKENS, cfg.vocab_size, 1))


def llama_inputs(n_layers: int = 2, seed: int = 0):
    cfg = llama_config(n_layers)
    return cfg, np_params(config_fields(cfg), seed)


def moe_inputs(seed: int = 0, experts_per_token: int = 2):
    cfg = moe_config(experts_per_token)
    return cfg, np_params(config_fields(cfg), seed, moe=True)


# ---- rank blocks and gathers ----

def cut(x, plan: tuple, coords: dict, dims: tuple):
    """``x``'s block for the rank at ``coords`` of a (dp, sp, tp) ``plan``:
    each axis is cut over its entry of ``dims`` (a mesh axis name), or
    whole (None)."""
    sizes = dict(zip(("dp", "sp", "tp"), plan))
    idx = []
    for axis, a in enumerate(dims):
        step = x.shape[axis] // (sizes[a] if a else 1)
        c = coords[a] if a else 0
        idx.append(slice(c * step, (c + 1) * step))
    return x[tuple(idx)]


def plan_coords(plan: tuple, rank: int) -> dict:
    """(dp, sp, tp) coordinates of ``rank``, tp fastest (the mesh order)."""
    dp, sp, tp = plan
    return {"dp": rank // (sp * tp), "sp": rank // tp % sp, "tp": rank % tp}


def gather(blocks: list, plan: tuple, dims: tuple) -> np.ndarray:
    """The global array from every rank's block (rank order), each block
    placed by the rank's coordinates; ranks that hold the same block must
    agree bitwise."""
    full_shape = list(blocks[0].shape)
    sizes = dict(zip(("dp", "sp", "tp"), plan))
    for axis, a in enumerate(dims):
        if a is not None:
            full_shape[axis] *= sizes[a]
    full = np.full(full_shape, np.nan, dtype=blocks[0].dtype)
    for r, blk in enumerate(blocks):
        coords = plan_coords(plan, r)
        idx = []
        for axis, a in enumerate(dims):
            if a is None:
                idx.append(slice(None))
            else:
                n = blk.shape[axis]
                idx.append(slice(coords[a] * n, (coords[a] + 1) * n))
        prev = full[tuple(idx)]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, blk)
        full[tuple(idx)] = blk
    assert not np.isnan(full).any()
    return full


# ---- the rank side ----

def _tensors(arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _attention_case(out: dict, key: str, fn, mesh, plan: tuple,
                    shape: dict, seed: int) -> None:
    """One plan of an sp strategy on this rank's blocks of q, k, v: its
    output block and the gradients of sum(out ** 2), summed over the
    ranks' blocks (each rank backs its own part of the sum)."""
    coords = plan_coords(plan, mesh.rank)
    dims = ("dp", "sp", "tp", None)
    q, k, v = (t.requires_grad_() for t in _tensors(
        cut(a, plan, coords, dims) for a in np_qkv(shape, seed)))
    o = fn(mesh, q, k, v)
    (o ** 2).sum().backward()
    out[f"{key}/out"] = o.detach().numpy()
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        out[f"{key}/{name}"] = t.grad.numpy()


def _mesh(plan: tuple, **kw):
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    dp, sp, tp = plan
    return build_mesh(MeshPlan(dp=dp, sp=sp, tp=tp), **kw)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _grads(out: dict, key: str, params: dict) -> None:
    for name, t in _flat(params).items():
        out[f"{key}/grad/{name}"] = t.grad.numpy()


def scenario_ring(world: int, out: dict, info: dict) -> None:
    from grove_tpu_torch.ops.ringattention import ring_attention
    for plan in RING_PLANS.get(world, ()):
        mesh = _mesh(plan)
        before = mesh.comm("sp").launches
        _attention_case(out, f"ring/{plan}", ring_attention, mesh, plan,
                        RING_SHAPE, 0)
        info[f"ring/{plan}/sp_launches"] = mesh.comm("sp").launches - before


def scenario_ulysses(world: int, out: dict, info: dict) -> None:
    from grove_tpu_torch.ops.ulysses import ulysses_attention
    for plan in ULYSSES_PLANS.get(world, ()):
        mesh = _mesh(plan)
        before = mesh.comm("sp").launches
        _attention_case(out, f"ulysses/{plan}", ulysses_attention, mesh,
                        plan, ULYSSES_SHAPE, 0)
        info[f"ulysses/{plan}/sp_launches"] = (mesh.comm("sp").launches
                                               - before)


def scenario_train(world: int, out: dict, info: dict) -> None:
    """``loss_fn(mesh=)`` per case: the loss and this rank's gradient
    slices; for the ring case also one AdamW step's updated slices."""
    import torch

    from grove_tpu_torch import train
    from grove_tpu_torch.convert import params_from_numpy
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.parallel.sharding import shard_params
    cfg, tree = llama_inputs()
    tokens = torch.from_numpy(np_tokens(TRAIN_TOKENS, cfg.vocab_size, 1))
    for name, (w, plan, sp) in TRAIN_CASES.items():
        if w != world:
            continue
        mesh = _mesh(plan)
        params = shard_params(mesh, params_from_numpy(tree, device="cpu"))
        opt = train.make_optimizer(params)
        loss = train.train_step(cfg, params, opt, tokens, mesh=mesh, sp=sp)
        out[f"train/{name}/loss"] = np.float64(loss)
        _grads(out, f"train/{name}", params)
        if name == "ring_222":
            for key, t in _flat(params).items():
                out[f"train/{name}/adamw/{key}"] = t.detach().numpy()
        info[f"train/{name}/launches"] = {
            a: c.launches for a, c in mesh.comms.items()}
        # forward(mesh=): this rank's block of the logits, no grad.
        with torch.no_grad():
            p = shard_params(mesh, params_from_numpy(tree, device="cpu"))
            out[f"train/{name}/logits"] = llama.forward(
                cfg, p, tokens, mesh=mesh, sp=sp).numpy()


def scenario_pipeline(world: int, out: dict, info: dict) -> None:
    from grove_tpu_torch.convert import params_from_numpy
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from grove_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                   stage_params)
    import torch
    cfg, tree = llama_inputs(n_layers=4)
    tokens = torch.from_numpy(np_tokens(PIPE_TOKENS, cfg.vocab_size, 1))
    for name, (w, pp, tp, micro) in PIPE_CASES.items():
        if w != world:
            continue
        mesh = build_mesh(MeshPlan(pp=pp, tp=tp))
        params = stage_params(mesh, params_from_numpy(tree, device="cpu"))
        for t in _flat(params).values():
            t.requires_grad_(True)
        logits = pipeline_forward(cfg, params, tokens, mesh,
                                  n_microbatches=micro)
        loss = llama.next_token_loss(logits, tokens, tp=mesh.comm("tp"))
        loss.backward()
        out[f"pipe/{name}/logits"] = logits.detach().numpy()
        out[f"pipe/{name}/loss"] = np.float64(loss.detach())
        _grads(out, f"pipe/{name}", params)
        info[f"pipe/{name}/coords"] = {"pp": mesh.coord("pp"),
                                       "tp": mesh.coord("tp")}


def scenario_moe_ep(world: int, out: dict, info: dict) -> None:
    """dp=2 x ep=4: ``ep_forward``'s logits block and auxiliary, its logits
    where nothing drops, the ep loss's gradient slices; then one
    ``_ep_moe_block`` at a tight capacity with top-1 and top-2 routing: its
    output block and the kept flags."""
    if world != 8:
        return
    import torch

    from grove_tpu_torch.convert import params_from_numpy
    from grove_tpu_torch.models import llama, moe
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from grove_tpu_torch.parallel.sharding import shard_params
    dp, ep = EP_PLAN
    mesh = build_mesh(MeshPlan(dp=dp, ep=ep))
    info["ep/coords"] = {"dp": mesh.coord("dp"), "ep": mesh.coord("ep")}
    cfg, tree = moe_inputs()
    tokens = torch.from_numpy(np_tokens(EP_TOKENS, cfg.vocab_size, 2))
    with torch.no_grad():
        p = shard_params(mesh, params_from_numpy(tree, device="cpu"))
        logits, aux = moe.ep_forward(cfg, p, tokens, mesh)
        out["ep/logits"] = logits.numpy()
        out["ep/aux"] = np.float64(aux)
        # Room for every assignment: nothing drops.
        out["ep/logits_roomy"] = moe.forward(
            cfg, p, tokens, mesh=mesh, ep=True,
            capacity_factor=float(cfg.n_experts)).numpy()
    params = shard_params(mesh, params_from_numpy(tree, device="cpu"))
    for t in _flat(params).values():
        t.requires_grad_(True)
    loss = moe.loss_fn(cfg, params, tokens, mesh=mesh, ep=True)
    loss.backward()
    out["ep/loss"] = np.float64(loss.detach())
    _grads(out, "ep", params)
    # The block at a tight capacity: layer 0's weights, a random input.
    for k in (1, 2):
        kcfg, ktree = moe_inputs(experts_per_token=k)
        lp = llama.layer_params(
            shard_params(mesh, params_from_numpy(ktree, device="cpu"))
            ["layers"], 0)
        x = np.random.default_rng(3).standard_normal(
            (dp * ep * EP_BLOCK_ROWS[0], EP_BLOCK_ROWS[1],
             kcfg.d_model)).astype(np.float32)
        r = mesh.coord("dp") * ep + mesh.coord("ep")
        xb = torch.from_numpy(x[r * EP_BLOCK_ROWS[0]:
                                (r + 1) * EP_BLOCK_ROWS[0]])
        kept = []
        with torch.no_grad():
            y, layer_aux = moe._ep_moe_block(kcfg, xb, lp, EP_TIGHT,
                                             mesh.comm("ep"), kept)
        out[f"ep/block/k{k}/out"] = y.numpy()
        out[f"ep/block/k{k}/aux"] = np.float64(layer_aux)
        out[f"ep/block/k{k}/kept"] = kept[0].numpy()


def scenario_lanes_tp(world: int, out: dict, info: dict) -> None:
    """``llama.prefill`` (one-shot) and ``prefill_chunked`` under tp over
    the whole world, each followed by greedy ``decode_step``s: every
    step's logits, the tokens, this rank's K/V heads and the lengths, and
    the collectives per call."""
    if world not in LANES_WORLDS:
        return
    import torch

    from grove_tpu_torch.convert import params_from_numpy
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.ops.kvcache import KVCache
    from grove_tpu_torch.parallel.sharding import shard_params
    mesh = _mesh((1, 1, world))
    tp = mesh.comm("tp")
    cfg, tree, toks = lanes_inputs()
    tokens = torch.from_numpy(toks)
    lengths = torch.tensor(LANES_LENGTHS, dtype=torch.int32)
    with torch.no_grad():
        p = shard_params(mesh, params_from_numpy(tree, device="cpu"))
        for mode in ("oneshot", "chunked"):
            cache = KVCache.create(cfg.n_layers, len(LANES_LENGTHS),
                                   LANES_CACHE, cfg.n_kv_heads // world,
                                   cfg.head_dim, cfg.dtype, "cpu")
            before = tp.launches
            if mode == "oneshot":
                logits, cache = llama.prefill(cfg, p, tokens, cache, lengths,
                                              tp=tp)
            else:
                logits, cache = llama.prefill_chunked(
                    cfg, p, tokens, cache, LANES_CHUNK, lengths, tp=tp)
            calls = [tp.launches - before]
            steps, picked = [logits.numpy()], []
            for _ in range(LANES_STEPS):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                picked.append(tok.numpy())
                before = tp.launches
                logits, cache = llama.decode_step(cfg, p, tok, cache, tp=tp)
                calls.append(tp.launches - before)
                steps.append(logits.numpy())
            out[f"lanes/{mode}/logits"] = np.stack(steps)
            out[f"lanes/{mode}/tokens"] = np.stack(picked)
            out[f"lanes/{mode}/k"] = cache.k.numpy()
            out[f"lanes/{mode}/v"] = cache.v.numpy()
            out[f"lanes/{mode}/lengths"] = cache.lengths.numpy()
            info[f"lanes/{mode}/collectives"] = calls


def scenario_dryrun(world: int, out: dict, info: dict) -> None:
    from grove_tpu_torch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = train.dryrun_multichip(device="cpu")
    info["dryrun/stdout"] = buf.getvalue()
    info["dryrun/line"] = line


def scenario_collectives(world: int, out: dict, info: dict) -> None:
    """Each differentiable collective of a tp axis over the whole world:
    the forward and the gradient of ``(y * w * c).sum()``, with ``w`` the
    element index of ``y`` and ``c`` the rank's weight ``COLLECTIVE_WEIGHT``
    gives (rank + 1, or 1 for ``all_gather``, whose backward holds only
    where every rank computes the same function of the joined tensor).
    tests/test_torch_parallel_train.py holds them against the
    definitions."""
    import torch
    mesh = _mesh((1, 1, world))
    c = mesh.comm("tp")
    r = c.rank
    res = {}
    for name, fn in (("copy_to", c.copy_to), ("reduce_from", c.reduce_from),
                     ("all_to_all", c.all_to_all), ("shift", c.shift),
                     ("shift_back", lambda x: c.shift(x, -1)),
                     ("all_gather", lambda x: c.all_gather(x, dim=0))):
        x = torch.from_numpy(collective_input(world, r)).requires_grad_()
        y = fn(x)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
        (y * w * COLLECTIVE_WEIGHT[name](r)).sum().backward()
        res[name] = {"y": y.detach().tolist(), "grad": x.grad.tolist()}
    info["collectives"] = res


COLLECTIVE_WEIGHT = {name: (lambda r: r + 1) for name in (
    "copy_to", "reduce_from", "all_to_all", "shift", "shift_back")}
COLLECTIVE_WEIGHT["all_gather"] = lambda r: 1


def collective_input(world: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s input to each collective: [world, 3], element
    (i, j) = 3 i + j + 100 rank."""
    return (np.arange(world * 3, dtype=np.float32).reshape(world, 3)
            + 100 * rank)


SCENARIOS = (scenario_collectives, scenario_ring, scenario_ulysses,
             scenario_train, scenario_pipeline, scenario_moe_ep,
             scenario_lanes_tp, scenario_dryrun)


def _rank(rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    arrays, info = {}, {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(out_dir, 'pg')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
        for fn in SCENARIOS:
            t = time.perf_counter()
            fn(world, arrays, info)
            info[f"seconds/{fn.__name__}"] = time.perf_counter() - t
        dist.destroy_process_group()
    except Exception:
        info = {"error": traceback.format_exc()}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    path = os.path.join(out_dir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(info, f)
    os.replace(path + ".tmp", path)


def run_worlds(root: str, timeout: float = TIMEOUT) -> None:
    """Every world of ``WORLDS`` at once, each in ``root/w{n}``. A world not
    done within ``timeout`` seconds raises (every process still running is
    killed): a hung collective fails the tests, it does not stall them."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for w in WORLDS:
        d = os.path.join(root, f"w{w}")
        os.makedirs(d, exist_ok=True)
        procs += [ctx.Process(target=_rank, args=(r, w, d), daemon=True)
                  for r in range(w)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = sum(p.is_alive() for p in procs)
        if hung:
            raise TimeoutError(f"{hung} ranks still running after "
                               f"{timeout:.0f}s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def load(root: str) -> dict[int, list[tuple[dict, dict]]]:
    """Each world's ranks' (arrays, info); a rank's error raises."""
    out = {}
    for w in WORLDS:
        d = os.path.join(root, f"w{w}")
        ranks = []
        for r in range(w):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                info = json.load(f)
            if "error" in info:
                raise RuntimeError(f"world {w} rank {r}:\n{info['error']}")
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                ranks.append(({k: z[k] for k in z.files}, info))
        out[w] = ranks
    return out


def shared_run(tmp_path_factory) -> dict[int, list[tuple[dict, dict]]]:
    """The worlds' results, run once per test session: under pytest-xdist
    the workers share the session's base directory, and the first to take
    its lock runs the worlds while the others wait for them. A failed run
    is recorded, and every reader raises it."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = os.path.join(str(base), "torch_parallel_worlds")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = os.path.join(root, "done")
        failed = os.path.join(root, "failed")
        if not (os.path.exists(done) or os.path.exists(failed)):
            try:
                run_worlds(root)
                load(root)
            except Exception:
                with open(failed, "w") as f:
                    f.write(traceback.format_exc())
            else:
                open(done, "w").close()
    if os.path.exists(os.path.join(root, "failed")):
        with open(os.path.join(root, "failed")) as f:
            raise RuntimeError(f"the gloo worlds failed:\n{f.read()}")
    return load(root)
