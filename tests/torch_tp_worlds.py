"""The ranks of the gloo worlds that tests/test_torch_tp_engine.py spawns.

``run_worlds`` starts one process per rank (``spawn``), each of which joins
a gloo group through a ``file://`` rendezvous, builds the port's tp mesh
over it, runs every scenario on its own engines at test-tiny in f32 and
writes what it saw to ``rank{r}.json``. The params come from the parent as
an ``.npz`` of numpy arrays. This module imports no JAX: only the parent
test compares with the JAX package.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import multiprocessing
import os
import time
import traceback

import numpy as np

# tools/decode_smoke.py's workload, as tests/test_torch_paged_engine.py
# serves it: the prompts, then the same prompts again.
GEOM = dict(batch=4, max_len=48, block_size=8, prefill_chunk=8,
            host_sync_interval=4)
PROMPT_LENS = (5, 19, 3, 11, 7)
MAX_NEW = 6
# Engine knobs of each served scenario.
SERVED = {
    "greedy": dict(prefix_cache=True),
    "prefix_off": dict(prefix_cache=False),
    "int8_weights": dict(prefix_cache=True, quant="int8"),
    "int8_kv": dict(prefix_cache=True, kv_quant="int8"),
    "spec_self": dict(prefix_cache=True, spec_decode=True, spec_k=3,
                      draft_params="self"),
}
# The direct model-function check: two sequences prefill a 6-token chunk
# at offset 0 through these tables, then decode one step.
NB, BS = 12, 4
TABLES = [[3, 5, 7, 0], [2, 4, 9, 11]]
CHUNK = 6
LOGIT_VARIANTS = ("f32", "int8_weights", "int8_kv")


def prompts() -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def logit_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The chunk's tokens [2, CHUNK] and the decode step's tokens [2]."""
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, size=(2, CHUNK)).astype(np.int32),
            rng.integers(0, 256, size=(2,)).astype(np.int32))


def drive(eng, want: int, max_iters: int = 3000) -> None:
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        if eng._active.size:
            eng.step()
    eng.sync()
    assert len(eng.completed) >= want, (len(eng.completed), want)


def serve_twice(eng) -> dict[int, list[int]]:
    ps = prompts()
    for rep in (1, 2):
        for p in ps:
            eng.submit(p, max_new_tokens=MAX_NEW)
        drive(eng, rep * len(ps))
    return {r.rid: [int(t) for t in r.generated] for r in eng.completed}


def save_params(path: str, params: dict) -> None:
    """A numpy params tree (dicts of arrays) as one ``.npz``."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(params, "")
    np.savez(path, **flat)


def load_params(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


# ---- the rank side ----

def _config():
    import torch

    from grove_tpu_torch.models import llama
    return dataclasses.replace(llama.CONFIGS["test-tiny"],
                               dtype=torch.float32, max_seq_len=64)


def _served(mesh, params) -> dict:
    from grove_tpu_torch.serving import engine as tengine
    cfg = _config()
    out = {}
    for name, kw in SERVED.items():
        eng = tengine.PagedDecodeEngine(cfg, params, mesh=mesh, device="cpu",
                                        xprof=False, reqtrace=False,
                                        **GEOM, **kw)
        out[name] = {"tokens": serve_twice(eng),
                     "pool": list(eng.kv.k.shape),
                     "scale": (list(eng.kv.k_scale.shape)
                               if eng.kv.quantized else None),
                     "draft_pool": eng.draft_kv is not None}
    from grove_tpu_torch.serving.engine import SamplerConfig
    eng = tengine.PagedDecodeEngine(
        cfg, params, mesh=mesh, device="cpu", xprof=False, reqtrace=False,
        sampler=SamplerConfig(temperature=1.0, top_k=20, seed=5), **GEOM)
    out["sampled"] = {"tokens": serve_twice(eng)}
    pair = tengine.make_disagg(cfg, params, mesh=mesh, device="cpu",
                               xprof=False, reqtrace=False, **GEOM)
    out["disagg"] = {
        "tokens": serve_twice(pair),
        "pools": [list(pair.prefill.kv.k.shape),
                  list(pair.decode.kv.k.shape)],
        "shared_params": pair.prefill.params is pair.decode.params}
    try:
        tengine.PagedDecodeEngine(cfg, params, mesh=mesh, device="cpu",
                                  spec_decode=True, xprof=False,
                                  reqtrace=False, **GEOM)
        out["spec_tiny"] = None
    except ValueError as e:
        out["spec_tiny"] = str(e)
    return out


def serve_once(eng) -> list[list[int]]:
    """The prompts once more through ``eng``: each request's tokens, in
    submission order."""
    n0 = len(eng.completed)
    for p in prompts():
        eng.submit(p, max_new_tokens=MAX_NEW)
    drive(eng, n0 + len(PROMPT_LENS))
    done = sorted(eng.completed[n0:], key=lambda r: r.rid)
    return [[int(t) for t in r.generated] for r in done]


def other_params():
    """Weights B, from a torch seed: the same on every process."""
    import torch

    from grove_tpu_torch.models import llama
    return llama.init_params(_config(), torch.Generator().manual_seed(1),
                             "cpu")


# The steps each world saves under its ckpt/ directory, and those the
# parent saves on one CPU under one/ (A, f32) and one_q/ (B, int8).
STEPS = ("mono", "pair", "b", "int8")


def _wait_for_step(path: str, timeout: float = 150.0) -> None:
    """A peer world's step: a digit directory appears only whole."""
    from grove_tpu_torch.serving import checkpoint as ckpt
    deadline = time.monotonic() + timeout
    while ckpt.latest_step(path) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no step under {path!r}")
        time.sleep(0.05)


def _checkpoints(mesh, params, out_dir: str, peers: list[str]) -> dict:
    """The checkpoint entry points on tp engines and a tp pair, every rank
    with the same directory: fresh engines' tokens on weights A and B (f32
    and int8), one step of each kind saved, A -> B -> A into live engines,
    steps of the peer world's plan and of one CPU restored, a save that
    dies on rank 1, and a restart into engines of another shape."""
    import torch

    from grove_tpu_torch.serving import checkpoint as ckpt
    from grove_tpu_torch.serving import engine as tengine
    from grove_tpu_torch.serving.quant import flatten_params
    cfg = _config()
    kw = dict(mesh=mesh, device="cpu", xprof=False, reqtrace=False, **GEOM)
    d = lambda name: os.path.join(out_dir, "ckpt", name)   # noqa: E731
    b = other_params()
    mono_a = tengine.PagedDecodeEngine(cfg, params, **kw)
    mono_b = tengine.PagedDecodeEngine(cfg, b, **kw)
    pair_a = tengine.make_disagg(cfg, params, **kw)
    q_a = tengine.PagedDecodeEngine(cfg, params, quant="int8", **kw)
    q_b = tengine.PagedDecodeEngine(cfg, b, quant="int8", **kw)
    out = {"fresh": {"a": serve_once(mono_a), "b": serve_once(mono_b),
                     "pair_a": serve_once(pair_a), "q_a": serve_once(q_a),
                     "q_b": serve_once(q_b)}}
    ckpt.save_engine(d("mono"), mono_a)
    ckpt.engine_responder(pair_a, d("pair"))(None)
    ckpt.save_engine(d("b"), mono_b)
    ckpt.save_engine(d("int8"), q_a)
    out["written"] = {n: sorted(os.listdir(d(n))) for n in STEPS}
    out["restarts"] = {}
    for name, eng in (("mono", mono_a), ("pair", pair_a)):
        got = []
        for src in ("b", name):
            got.append([ckpt.warm_restart(d(src), eng), serve_once(eng)])
        out["restarts"][name] = got
    across = {}
    for peer in peers:
        for name in ("b", "int8"):
            _wait_for_step(os.path.join(peer, "ckpt", name))
        across[peer] = [
            (ckpt.warm_restart(os.path.join(peer, "ckpt", "b"), mono_a),
             serve_once(mono_a))[1],
            (ckpt.warm_restart(os.path.join(peer, "ckpt", "int8"), q_b),
             serve_once(q_b))[1]]
    out["across"] = across
    out["one_card"] = [
        (ckpt.warm_restart(os.path.join(out_dir, "one"), mono_a),
         serve_once(mono_a))[1],
        (ckpt.warm_restart(os.path.join(out_dir, "one_q"), q_b),
         serve_once(q_b))[1]]

    # A save that dies on rank 1 half way through its file.
    def dies(obj, f, *args, **kwargs):
        f.write(b"half")
        raise OSError("disk full")

    real = torch.save
    if mesh.rank == 1:
        torch.save = dies
    try:
        ckpt.save_engine(d("half"), mono_a)
        err = None
    except Exception as e:
        err = [type(e).__name__, str(e)]
    finally:
        torch.save = real
    out["half"] = {"error": err, "latest": ckpt.latest_step(d("half"))}
    # The retry is collective: every rank lists after rank 0 removed the
    # dead attempt's temporary directory and committed the new step.
    ckpt.save_engine(d("half"), mono_a)
    out["half"]["retry"] = sorted(os.listdir(d("half")))

    # Engines of another shape: on every rank (one layer), then on rank 0
    # alone, where the other ranks match and must not write either.
    shapes = {}
    for case in ("every", "rank0"):
        other = (mesh.rank == 0 or case == "every")
        ocfg = dataclasses.replace(cfg, n_layers=1) if other else cfg
        from grove_tpu_torch.models import llama
        op = llama.init_params(ocfg, torch.Generator().manual_seed(2), "cpu")
        eng = tengine.PagedDecodeEngine(ocfg, op, **kw)
        before = {k: t.clone() for k, t in
                  flatten_params(eng.params)[0].items()}
        try:
            ckpt.warm_restart(d("b"), eng)
            err = None
        except Exception as e:
            err = type(e).__name__
        after = flatten_params(eng.params)[0]
        shapes[case] = {"error": err, "unchanged": all(
            torch.equal(before[k], t) for k, t in after.items())}
    out["another_shape"] = shapes
    return out


def _logits(mesh, params) -> dict:
    """Each variant's chunk and decode logits from the model functions
    over this rank's slices and pools, and the collectives per forward."""
    import torch

    from grove_tpu_torch.models import llama
    from grove_tpu_torch.parallel.sharding import shard_params
    from grove_tpu_torch.serving.kvcache import PagedKV
    from grove_tpu_torch.serving.quant import quantize_params
    cfg = _config()
    tp = mesh.comm("tp")
    chunk_np, step_np = logit_inputs()
    tables = torch.tensor(TABLES, dtype=torch.int32)
    out = {}
    for variant in LOGIT_VARIANTS:
        p = quantize_params(params) if variant == "int8_weights" else params
        p = shard_params(mesh, p)
        kv = PagedKV.create(cfg.n_layers, NB, BS,
                            cfg.n_kv_heads // mesh.shape["tp"],
                            cfg.head_dim, cfg.dtype,
                            quant="int8" if variant == "int8_kv" else "off",
                            device="cpu")
        before = tp.launches
        chunk = llama.prefill_chunk_paged(
            cfg, p, torch.from_numpy(chunk_np), kv.k, kv.v, tables, 0,
            CHUNK - 1, **kv.scales, tp=tp)
        per_chunk = tp.launches - before
        before = tp.launches
        step = llama.decode_step_paged(
            cfg, p, torch.from_numpy(step_np), kv.k, kv.v, tables,
            torch.full((2,), CHUNK, dtype=torch.int32), **kv.scales, tp=tp)
        out[variant] = {"chunk": chunk.tolist(), "step": step.tolist(),
                        "collectives": [per_chunk, tp.launches - before]}
    return out


def _mesh_axes(world: int) -> dict:
    """A (dp=2, tp=world/2) mesh over the same world: each axis's sum and
    gather, and this rank's coordinates."""
    import torch

    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    m = build_mesh(MeshPlan(dp=2, tp=world // 2))
    x = torch.full((2,), float(m.rank + 1))
    return {"coords": {a: m.coord(a) for a in m.axis_names},
            "dp_sum": m.comm("dp").all_reduce(x.clone()).tolist(),
            "tp_sum": m.comm("tp").all_reduce(x.clone()).tolist(),
            "tp_gather": m.comm("tp").all_gather(x[None]).tolist(),
            "sizes": {a: m.comm(a).size for a in m.axis_names
                      if m.comm(a) is not None}}


def _rank(rank: int, world: int, out_dir: str, mesh_axes: bool,
          peers: list[str]) -> None:
    import torch
    import torch.distributed as dist

    from grove_tpu_torch.convert import params_from_numpy
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.json")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(out_dir, 'pg')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
        mesh = build_mesh(MeshPlan(tp=world))
        params = params_from_numpy(
            load_params(os.path.join(out_dir, "params.npz")), device="cpu")
        with torch.no_grad():
            res = {"rank": mesh.rank, "tp_rank": mesh.comm("tp").rank,
                   "served": _served(mesh, params),
                   "checkpoints": _checkpoints(mesh, params, out_dir,
                                               peers),
                   "logits": _logits(mesh, params)}
            if mesh_axes:
                res["mesh"] = _mesh_axes(world)
        dist.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()}
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def run_worlds(worlds: dict[int, str], timeout: float) -> dict[int, list]:
    """Run one gloo world per entry of ``worlds`` (size -> its directory,
    which holds ``params.npz`` and the one-CPU steps ``one/`` and
    ``one_q/``), all at once; each world restores the others' steps as
    they appear. Returns each world's rank
    results. A rank that fails, or a world that is not done within
    ``timeout`` seconds, raises (and every process still running is
    killed): a hung collective fails the test, it does not stall it."""
    ctx = multiprocessing.get_context("spawn")
    procs = {w: [ctx.Process(target=_rank, args=(
        r, w, d, w >= 4, [p for v, p in worlds.items() if v != w]),
        daemon=True) for r in range(w)] for w, d in worlds.items()}
    try:
        for ps in procs.values():
            for p in ps:
                p.start()
        deadline = time.monotonic() + timeout
        for ps in procs.values():
            for p in ps:
                p.join(max(0.0, deadline - time.monotonic()))
        hung = [(w, r) for w, ps in procs.items()
                for r, p in enumerate(ps) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{timeout:.0f}s")
    finally:
        for ps in procs.values():
            for p in ps:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    out = {}
    for w, d in worlds.items():
        ranks = []
        for r in range(w):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                res = json.load(f)
            if "error" in res:
                raise RuntimeError(f"world {w} rank {r}:\n{res['error']}")
            ranks.append(res)
        out[w] = ranks
    return out
