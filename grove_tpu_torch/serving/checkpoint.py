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
import shutil
import tempfile
from typing import Any

import torch

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.serving.quant import QTensor, flatten_params

_PARAMS = "params.pt"
_MANIFEST = "manifest.json"
_FORMAT = 1


def _unflatten(flat: dict[str, torch.Tensor], qtensors: list[str]) -> dict:
    q = set(qtensors)
    tree: dict = {}
    for key, t in flat.items():
        head, _, last = key.rpartition("/")
        if head in q:
            if last == "q":
                leaf_key, leaf = head, QTensor(q=t,
                                               scale=flat[head + "/scale"])
            else:
                continue
        else:
            leaf_key, leaf = key, t
        node = tree
        *dirs, name = leaf_key.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = leaf
    return tree


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


def save_params(path: str, params: Any, step: int = 0) -> str:
    """Save a params tree as step ``step``; returns the checkpoint
    directory, durable on disk when this returns."""
    path = os.path.abspath(path)
    target = os.path.join(path, str(step))
    if os.path.exists(target):
        raise FileExistsError(f"checkpoint step {target!r} exists")
    flat, qtensors = flatten_params(params)
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}.partial-", dir=path)
    try:
        with open(os.path.join(tmp, _PARAMS), "wb") as f:
            torch.save({k: _storable(t) for k, t in flat.items()}, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"format": _FORMAT, "leaves": list(flat),
                       "qtensors": qtensors}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(path)
    return target


def _read(path: str, step: int, map_location
          ) -> tuple[dict[str, torch.Tensor], list[str]]:
    d = os.path.join(os.path.abspath(path), str(step))
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{d!r}: checkpoint format "
                         f"{manifest.get('format')!r}, expected {_FORMAT}")
    flat = torch.load(os.path.join(d, _PARAMS), map_location=map_location,
                      weights_only=True)
    if list(flat) != manifest["leaves"]:
        raise ValueError(f"{d!r}: params file and manifest disagree")
    return flat, manifest["qtensors"]


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


def load_params(path: str, step: int = 0, like: Any | None = None,
                device: str | torch.device | None = None) -> Any:
    """Restore a params tree. With ``like`` (a params tree), each leaf lands
    on the device and in the dtype of ``like``'s leaf, and a structure or
    shape that differs raises ``ValueError``; without it, on ``device``
    (None means the card)."""
    if like is None:
        flat, qtensors = _read(path, step, resolve_device(device))
        return _unflatten(flat, qtensors)
    flat, qtensors = _read(path, step, "cpu")
    like_flat, like_q = flatten_params(like)
    _match(flat, qtensors, like_flat, like_q)
    return _unflatten({k: flat[k].to(device=ref.device, dtype=ref.dtype)
                       for k, ref in like_flat.items()}, like_q)


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


def save_engine(path: str, engine: Any, step: int | None = None) -> str:
    """Checkpoint a serving engine's params; returns the checkpoint
    directory. ``step`` defaults to one past the latest existing step, so
    repeated barriers (a roll's per-victim checkpoints, storm coalescing)
    never clobber the previous durable state."""
    if step is None:
        prev = latest_step(path)
        step = 0 if prev is None else prev + 1
    return save_params(path, engine.params, step=step)


def warm_restart(path: str, engine: Any, step: int | None = None) -> int:
    """Restore the latest (or given) checkpoint into a serving engine's
    params in place: every leaf is copied into the tensor the engine
    already holds (on its device, in its dtype), so its closures and
    captured graphs serve the restored weights with no new capture. A
    disaggregated pair is restored tier by tier. Returns the step."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {path!r} to warm-restart from")
    tiers = _tiers(engine)
    if not all(t.idle() for t in tiers):
        raise RuntimeError("warm_restart needs an idle engine: sequences in "
                           "flight hold KV of the old weights")
    src, src_q = _read(path, step, "cpu")
    pairs = []
    for tier in tiers:
        dst, dst_q = flatten_params(tier.params)
        _match(src, src_q, dst, dst_q)
        pairs += [(t, src[k]) for k, t in dst.items()]
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
    the reclaim controller's retry and backoff loop."""

    def respond(_notice) -> None:
        save_engine(path, engine)

    return respond
