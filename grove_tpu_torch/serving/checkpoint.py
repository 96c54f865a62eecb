"""Checkpoint and resume for the port: params save and restore, and the
serving engines' warm restart (the disruption barrier's checkpoint path).

The JAX package's ``grove_tpu/serving/checkpoint.py``, with the same names,
arguments and step rules, on ``torch.save`` in place of orbax:

- **Layout.** ``path/<step>/``, as orbax lays it out, holding
  ``params.pt`` (one ``torch.save`` of the flattened tree: each leaf under
  its path, ``layers/wq``, as a contiguous CPU tensor; an int8 ``QTensor``
  leaf as ``.../q`` and ``.../scale``) and ``manifest.json`` (the leaves in
  order and which of them are ``QTensor``\\ s).
- **Atomic.** A step is written into a sibling temporary directory whose
  name is not all digits, flushed to disk, and renamed to ``<step>`` in
  one ``os.replace``. ``latest_step`` counts only digit names, so it never
  sees a half-written step, and a returned save (a barrier's ack) means
  the weights are durable. A step that exists already raises, as orbax's
  save does.
- **Safe to load.** ``torch.load(weights_only=True)``: a checkpoint file
  runs no code. With ``like=``, each leaf lands on the device and in the
  dtype of ``like``'s leaf, and a tree of another structure or a leaf of
  another shape raises: the port's counterpart of orbax's sharding-aware
  ``like``.
- **Warm restart copies in place.** A port engine binds its params inside
  the closures it builds, and on the card captures each closure as a CUDA
  graph that reads the weights' addresses. A rebound ``engine.params``
  would be ignored: the engine would go on serving the old weights
  without an error. So ``warm_restart`` copies every leaf (a ``QTensor``'s
  ``q`` and ``scale`` both) into the engine's own tensors under
  ``torch.no_grad()`` and never rebinds ``engine.params``: the closures and
  the captured graphs read the restored weights, with no capture and no
  build. An engine whose params differ in structure or shape raises
  ``ValueError`` before anything is written. The engine must be idle
  (its ``idle()``: no sequence in flight, whose KV the old weights
  wrote), and its prefix cache is dropped (``reset_prefix_cache()``) for
  the same reason.
- **One whole model, in slices.** A tensor-parallel engine's params are
  its rank's slices (``ShardedParams``, ``mesh=`` with tp > 1), and its
  step still holds the whole model, as orbax's save of global arrays
  does: ``path/<step>/rank{r}.pt`` holds rank r's slices, cut as
  ``shard_params`` cuts them, under the same flattened names, and
  ``manifest.json`` adds the plan, each leaf's whole shape and the axes it
  is cut on (``param_pspec``). No rank gathers the model. The save is
  collective over the tp group, as orbax's multi-process save is: every
  rank calls it with the same directory, **which every rank must see** (a
  shared file system across hosts). Rank 0 takes the step and makes the
  temporary directory, every rank writes its file into it, and after a
  barrier that also says whether every rank succeeded, rank 0 renames it;
  a second barrier carries the rename's outcome, so a return on any rank
  means the whole step is durable, and a failure on any rank raises on
  every rank (``engine_responder``'s retry loop sees it). A one-card save
  keeps the ``params.pt`` layout. Only a tp-only plan's engine is saved
  and restored: one cut for a plan with dp, pp, ep or sp above 1 raises
  ``ValueError`` (``engine_responder`` at registration).
- **Any plan onto any other.** A step loads as the whole tree whatever
  plan wrote it (``unshard_params``: a block that several ranks hold, as
  an int8 scale over a contracted axis, is taken from the lowest rank,
  and a copy that differs raises), and ``like=`` a rank's slices gives
  that rank's blocks: a step written by the same plan reads only
  ``rank{r}.pt``, one of another plan only the files whose blocks overlap
  the rank's, memory-mapped (``reshard_params``). So a step of one
  card, tp = 2 or tp = 4 restores onto any of them, as orbax's
  sharding-aware restore does. ``warm_restart``
  of a tp engine takes rank 0's step and agrees over the tp group that
  every rank matched before any rank writes.
- **Aliasing.** An engine keeps the tensors it was built on (quantization
  aside, which makes its own). An engine built on a trainer's params
  shares their storage: a later ``warm_restart`` overwrites the trainer's
  weights too, and a later optimizer step changes what the engine serves.
  Build the engine on a copy (a ``load_params`` of the trainer's
  checkpoint, or cloned leaves) to keep the two apart.

The port cannot read an orbax checkpoint: that would import JAX. Carry a
JAX params tree across with ``convert.params_from_numpy`` and save it here.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import tempfile
from typing import Any

import torch

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
from grove_tpu_torch.parallel.sharding import (ShardedParams, leaf_cuts,
                                               reshard_params, unshard_params)
from grove_tpu_torch.serving.quant import flatten_params, unflatten_params

_PARAMS = "params.pt"
_MANIFEST = "manifest.json"
_FORMAT = 1


def _storable(t: torch.Tensor) -> torch.Tensor:
    """A detached CPU tensor that owns exactly its own bytes (torch.save
    writes a view's whole storage)."""
    t = t.detach().cpu()
    if not t.is_contiguous() or t.storage_offset() or \
            t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_tensors(path: str, flat: dict[str, torch.Tensor]) -> None:
    with open(path, "wb") as f:
        torch.save({k: _storable(t) for k, t in flat.items()}, f)
        f.flush()
        os.fsync(f.fileno())


def _write_manifest(path: str, manifest: dict) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def _next_step(path: str) -> int:
    prev = latest_step(path)
    return 0 if prev is None else prev + 1


def save_params(path: str, params: Any, step: int | None = 0,
                comm=None) -> str:
    """Save a params tree as step ``step`` (None: one past the latest);
    returns the checkpoint directory, durable on disk when this returns.
    A ``ShardedParams`` tree (a rank's slices) is saved collectively over
    ``comm``, the tp group it was cut over: every rank of the group calls
    this with the same directory and step."""
    if isinstance(params, ShardedParams):
        return _save_sharded(path, params, step, comm)
    path = os.path.abspath(path)
    if step is None:
        step = _next_step(path)
    target = os.path.join(path, str(step))
    if os.path.exists(target):
        raise FileExistsError(f"checkpoint step {target!r} exists")
    flat, qtensors = flatten_params(params)
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}.partial-", dir=path)
    try:
        _write_tensors(os.path.join(tmp, _PARAMS), flat)
        _write_manifest(os.path.join(tmp, _MANIFEST),
                        {"format": _FORMAT, "leaves": list(flat),
                         "qtensors": qtensors})
        _fsync_dir(tmp)
        os.replace(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(path)
    return target


def _rank_file(rank: int) -> str:
    return f"rank{rank}.pt"


def _save_sharded(path: str, params: ShardedParams, step: int | None,
                  comm) -> str:
    """The collective save of a rank's slices: rank 0 takes the step and
    makes the temporary directory and broadcasts both, every rank writes
    its file, a vote (a barrier) says whether all did, rank 0 renames, and
    a second vote carries the rename's outcome to every rank."""
    if len(params.layout) != 2 or comm is None or \
            (comm.size, comm.rank) != (params.layout[0].size,
                                       params.layout[1]):
        raise ValueError(f"slices cut for {params.layout} are saved "
                         "collectively over the tp group of a tp-only "
                         "plan: pass that group's AxisComm")
    plan, rank = params.layout
    path = os.path.abspath(path)
    head = torch.zeros(3, dtype=torch.int64, device=comm.scalar_device)
    err: Exception | None = None
    if rank == 0:
        try:
            if step is None:
                step = _next_step(path)
            if os.path.exists(os.path.join(path, str(step))):
                raise FileExistsError(f"checkpoint step "
                                      f"{os.path.join(path, str(step))!r} "
                                      "exists")
            os.makedirs(path, exist_ok=True)
            nonce = secrets.randbits(62)
            os.mkdir(os.path.join(path, f".{step}.partial-{nonce:016x}"))
            head = torch.tensor([1, step, nonce], dtype=torch.int64,
                                device=comm.scalar_device)
        except Exception as e:
            err = e
    comm.broadcast(head)
    if not int(head[0]):
        raise err or RuntimeError(f"rank 0 could not start a checkpoint "
                                  f"step under {path!r}")
    step, nonce = int(head[1]), int(head[2])
    tmp = os.path.join(path, f".{step}.partial-{nonce:016x}")
    target = os.path.join(path, str(step))
    flat, qtensors = flatten_params(params)
    try:
        _write_tensors(os.path.join(tmp, _rank_file(rank)), flat)
        if rank == 0:
            _write_manifest(os.path.join(tmp, _MANIFEST), {
                "format": _FORMAT, "leaves": list(flat),
                "qtensors": qtensors, "plan": plan.axis_sizes(),
                "shapes": {k: list(params.shapes[k]) for k in flat},
                "cuts": leaf_cuts(plan, flat, qtensors, params.shapes)})
    except Exception as e:
        err = e
    if not comm.all_ok(err is None):
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise err or RuntimeError(f"another rank could not write its slices "
                                  f"of checkpoint step {target!r}")
    if rank == 0:
        try:
            _fsync_dir(tmp)
            os.replace(tmp, target)
            _fsync_dir(path)
        except Exception as e:
            shutil.rmtree(tmp, ignore_errors=True)
            err = e
    if not comm.all_ok(err is None):
        raise err or RuntimeError(f"rank 0 could not commit checkpoint "
                                  f"step {target!r}")
    return target


def _load_file(d: str, name: str, leaves: list[str], map_location,
               mmap: bool = False) -> dict[str, torch.Tensor]:
    flat = torch.load(os.path.join(d, name), map_location=map_location,
                      weights_only=True, mmap=mmap)
    if list(flat) != leaves:
        raise ValueError(f"{d!r}: {name} and the manifest disagree")
    return flat


def _read(path: str, step: int, map_location, layout: tuple | None = None
          ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """The step's leaves, flattened, and its ``QTensor`` paths: the whole
    tree, or with ``layout`` (plan, rank) that rank's slices. A step of the
    same plan reads ``rank{r}.pt`` alone; a step of another plan reads,
    memory-mapped, only the files holding blocks that overlap the rank's
    (``reshard_params``)."""
    d = os.path.join(os.path.abspath(path), str(step))
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{d!r}: checkpoint format "
                         f"{manifest.get('format')!r}, expected {_FORMAT}")
    leaves, qtensors = manifest["leaves"], manifest["qtensors"]
    if "plan" in manifest:
        plan = MeshPlan(**manifest["plan"])
        names = [_rank_file(r) for r in range(plan.size)]
    else:
        plan, names = MeshPlan(), [_PARAMS]
    if layout is not None and layout[0] == plan:
        return (_load_file(d, names[layout[1]], leaves, map_location),
                qtensors)
    if layout is None and "plan" not in manifest:
        return _load_file(d, _PARAMS, leaves, map_location), qtensors
    parts: dict[int, dict[str, torch.Tensor]] = {}

    def part(r: int) -> dict[str, torch.Tensor]:
        if r not in parts:
            parts[r] = _load_file(d, names[r], leaves, "cpu", mmap=True)
        return parts[r]

    if "plan" in manifest:
        shapes = {k: tuple(v) for k, v in manifest["shapes"].items()}
        if leaf_cuts(plan, leaves, qtensors, shapes) != manifest["cuts"]:
            raise ValueError(f"{d!r}: the step was cut by other rules than "
                             "param_pspec's")
    else:
        shapes = {k: tuple(t.shape) for k, t in part(0).items()}
    if layout is None:
        flat = unshard_params(plan, [part(r) for r in range(plan.size)],
                              qtensors, shapes)
        return {k: t.to(map_location) for k, t in flat.items()}, qtensors
    return (reshard_params(plan, part, leaves, qtensors, shapes,
                           Mesh(*layout)), qtensors)


def _match(flat: dict[str, torch.Tensor], qtensors: list[str],
           like_flat: dict[str, torch.Tensor], like_q: list[str]) -> None:
    """Raise ValueError unless the two flattened trees have the same
    leaves, the same ``QTensor`` leaves and the same shapes."""
    if set(flat) != set(like_flat) or set(qtensors) != set(like_q):
        missing = sorted(set(like_flat) - set(flat))
        extra = sorted(set(flat) - set(like_flat))
        raise ValueError(f"checkpoint structure differs: missing {missing}, "
                         f"unexpected {extra}, int8 leaves {sorted(qtensors)}"
                         f" vs {sorted(like_q)}")
    for key, ref in like_flat.items():
        if flat[key].shape != ref.shape:
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(flat[key].shape)}, expected "
                             f"{tuple(ref.shape)}")


def _layout(params: Any) -> tuple | None:
    return params.layout if isinstance(params, ShardedParams) else None


def load_params(path: str, step: int = 0, like: Any | None = None,
                device: str | torch.device | None = None) -> Any:
    """Restore a params tree: the whole model, whatever plan wrote the step.
    With ``like`` (a params tree), each leaf lands on the device and in the
    dtype of ``like``'s leaf, and a structure or shape that differs raises
    ``ValueError``; a ``like`` that holds a rank's slices
    (``ShardedParams``) gets that rank's slices, as a ``ShardedParams``.
    Without ``like``, on ``device`` (None means the card)."""
    if like is None:
        flat, qtensors = _read(path, step, resolve_device(device))
        return unflatten_params(flat, qtensors)
    flat, qtensors = _read(path, step, "cpu", _layout(like))
    like_flat, like_q = flatten_params(like)
    _match(flat, qtensors, like_flat, like_q)
    tree = unflatten_params({k: flat[k].to(device=ref.device,
                                           dtype=ref.dtype)
                             for k, ref in like_flat.items()}, like_q)
    if isinstance(like, ShardedParams):
        tree = ShardedParams(tree)
        tree.layout, tree.shapes = like.layout, like.shapes
    return tree


def latest_step(path: str) -> int | None:
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    return max(steps) if steps else None


# ---- engine warm restart (the disruption contract's checkpoint path) ----


def _tiers(engine: Any) -> list[Any]:
    """The engines a warm restart writes: the engine, or both tiers of a
    disaggregated pair."""
    from grove_tpu_torch.serving.engine import DisaggServing

    if isinstance(engine, DisaggServing):
        return [engine.prefill, engine.decode]
    return [engine]


def _tp_group(tiers: list[Any]):
    """The tp group a tensor-parallel engine's checkpoint is collective
    over, or None for an engine that holds the whole model. An engine cut
    for a plan with another axis above 1 (dp, pp, ep, sp) raises
    ``ValueError``: its tp groups are replicas of one another, and no
    collective over one of them commits a step for all."""
    layout = _layout(tiers[0].params)
    if layout is None:
        return None
    if layout[0].size != layout[0].tp:
        raise ValueError(f"checkpoints of an engine cut for {layout[0]} "
                         "are not supported: only a tp-only plan's engine "
                         "saves and restores its slices")
    return tiers[0].mesh.comm("tp")


def save_engine(path: str, engine: Any, step: int | None = None) -> str:
    """Checkpoint a serving engine's params; returns the checkpoint
    directory. ``step`` defaults to one past the latest existing step, so
    repeated barriers (a roll's per-victim checkpoints, storm coalescing)
    never clobber the previous durable state. A tensor-parallel engine (or
    pair) is saved collectively: every rank of its tp group calls this with
    the same directory, which every rank must see; a disaggregated pair's
    tiers share their params, which are saved once."""
    return save_params(path, engine.params, step=step,
                       comm=_tp_group(_tiers(engine)))


def warm_restart(path: str, engine: Any, step: int | None = None) -> int:
    """Restore the latest (or given) checkpoint into a serving engine's
    params in place: every leaf is copied into the tensor the engine
    already holds (on its device, in its dtype), so its closures and
    captured graphs serve the restored weights with no new capture. A
    disaggregated pair is restored tier by tier. A tensor-parallel engine
    restores collectively (every rank calls this): rank 0 picks the latest
    step, each rank reads its slices of it (a step of another plan is
    assembled and cut again), and no rank writes unless every rank is idle
    and matched; otherwise every rank raises. Returns the step."""
    tiers = _tiers(engine)
    comm = _tp_group(tiers)
    if step is None:
        step = latest_step(path)
        if comm is not None:
            head = torch.tensor([-1 if step is None else step],
                                dtype=torch.int64, device=comm.scalar_device)
            step = int(comm.broadcast(head)[0])
            step = None if step < 0 else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {path!r} to warm-restart from")
    err: Exception | None = None
    pairs = []
    try:
        if not all(t.idle() for t in tiers):
            raise RuntimeError("warm_restart needs an idle engine: sequences "
                               "in flight hold KV of the old weights")
        read: dict = {}
        for tier in tiers:
            layout = _layout(tier.params)
            if layout not in read:
                read[layout] = _read(path, step, "cpu", layout)
            src, src_q = read[layout]
            dst, dst_q = flatten_params(tier.params)
            _match(src, src_q, dst, dst_q)
            pairs += [(t, src[k]) for k, t in dst.items()]
    except Exception as e:
        err = e
    if comm is not None and not comm.all_ok(err is None):
        raise err or RuntimeError(f"another rank could not restore step "
                                  f"{step} from {path!r}: nothing written")
    if err is not None:
        raise err
    seen: set[int] = set()
    with torch.no_grad():
        for dst, s in pairs:
            if id(dst) not in seen:     # tiers may share their tensors
                seen.add(id(dst))
                dst.copy_(s)
    for tier in tiers:
        tier.reset_prefix_cache()
    return step


def engine_responder(engine: Any, path: str):
    """A disruption-barrier checkpoint responder for ``engine``: register it
    with ``disruption.register_responder(gang_name,
    engine_responder(e, d))`` and every planned eviction of the gang
    (defrag migration, rolling update, spot reclaim) flushes the engine's
    params durably before its pods are drained; the relanded replica
    ``warm_restart``\\ s from the same directory. An exception propagates to
    the reclaim controller's retry and backoff loop. On a tensor-parallel
    engine every rank's responder saves collectively, and a rank that
    fails raises on every rank. An engine cut for a plan other than
    tp-only (``_tp_group``) raises ``ValueError`` here, at registration,
    and not at the first eviction."""
    _tp_group(_tiers(engine))

    def respond(_notice) -> None:
        save_engine(path, engine)

    return respond
