"""Logical→physical sharding rules for the model stack, and this rank's
slices of a params tree.

Parameters and activations are annotated with *logical* axis names; the
rules below (the JAX package's ``parallel/sharding.py``, entry for entry)
map them onto mesh axes. A spec is a tuple with one entry per tensor axis:
a mesh axis name, a tuple of names (sharded over their product), or None
(replicated); it compares entry for entry with JAX's ``PartitionSpec``.

The JAX package hands these specs to ``jax.device_put`` and lets GSPMD
insert the collectives. The port holds each rank's slices itself
(``shard_params``) and the model runs the collectives where GSPMD would
(models/llama.py, ``tp=``). JAX's ``paged_step_shardings``,
``paged_prefill_shardings``, ``paged_handoff_shardings`` and
``paged_spec_shardings`` are the in/out shardings of ``jax.jit`` and have
no counterpart: a port engine allocates its pools at the per-rank width
(``paged_kv_pspec``), its host-fed buffers are replicated by every rank
writing the same values, and the block handoff is a local copy of each
rank's own heads.
"""

from __future__ import annotations

from typing import Any

import torch

from grove_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_SP,
                                           AXIS_TP, Mesh, MeshPlan)
from grove_tpu_torch.serving.quant import QTensor, flatten_params

Spec = tuple

# logical axis -> mesh axis (None = replicate; a tuple shards over the
# product of those axes)
LOGICAL_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": AXIS_DP,
    "seq": AXIS_SP,          # sequence parallelism for long context
    "vocab": AXIS_TP,
    "embed": None,           # d_model replicated (activations row-sharded by batch)
    "heads": AXIS_TP,        # attention heads over tp
    "kv_heads": AXIS_TP,
    "head_dim": None,
    "mlp": AXIS_TP,          # ffn hidden over tp
    "layers": None,          # stacked layer axis
    # MoE experts: the dedicated ep axis first, tp as the inner factor —
    # on a tp-only mesh (ep=1) experts still shard over tp (a Mixtral's
    # expert weights replicated per device would blow the memory budget);
    # with ep>1 they shard over ep×tp.
    "expert": (AXIS_EP, AXIS_TP),
}


def logical_pspec(*logical_axes: str | None) -> Spec:
    """Translate a tuple of logical axis names to a spec.

    Unknown names raise (a typo'd axis silently replicating would cost
    N× memory and collectives while still computing correct numbers).
    """
    return tuple(LOGICAL_RULES[a] if a is not None else None
                 for a in logical_axes)


# Specs per parameter leaf name. Keys match the params dict produced by
# grove_tpu_torch.models.llama.init_params (and models/moe.py's).
_PARAM_RULES: dict[str, tuple[str | None, ...]] = {
    "tok_embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "final_norm": ("embed",),
    # per-layer (leading stacked "layers" axis added automatically)
    "attn_norm": ("embed",),
    "mlp_norm": ("embed",),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    # MoE: experts shard over the dedicated ep axis; router replicated
    "router": ("embed", None),
    "we_gate": ("expert", "embed", None),
    "we_up": ("expert", "embed", None),
    "we_down": ("expert", None, "embed"),
}

_STACKED = {"attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
            "w_gate", "w_up", "w_down",
            "router", "we_gate", "we_up", "we_down"}


def param_pspec(name: str) -> Spec:
    """Spec for a named parameter leaf."""
    logical = _PARAM_RULES[name]
    if name in _STACKED:
        logical = ("layers",) + logical
    return logical_pspec(*logical)


def param_pspecs(params: Any) -> Any:
    """A tree of specs matching ``params`` (dict-of-dict layout).

    Quantized trees (serving/quant.QTensor) are handled as in the JAX
    package: the int8 ``q`` leaf takes its parent weight's spec (same
    shape), the per-channel ``scale`` is replicated, ``()``: its contracted
    axes are kept as size-1 dims (``shard_params`` slices the scale's
    full-size axes with the weight's, which GSPMD does by broadcasting)."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = param_pspecs(leaf)
        elif isinstance(leaf, QTensor):
            out[name] = QTensor(q=param_pspec(name), scale=())
        else:
            out[name] = param_pspec(name)
    return out


class ShardedParams(dict):
    """A params tree that holds one rank's slices (``shard_params``):
    ``layout`` is the (plan, rank) they were cut for and ``shapes`` each
    leaf's whole shape by its flattened path (``flatten_params``' keys),
    which a checkpoint of the slices records. An engine takes it as it is,
    so that the two tiers of a disaggregated pair share one set of
    slices."""

    layout: tuple = ()
    shapes: dict = {}


def _cuts(mesh: Mesh, shape, spec: Spec,
          full: tuple[int, ...] | None = None) -> list[tuple[int, int, int]]:
    """The (axis, block index, block count) of each axis of a tensor of
    ``shape`` that ``spec`` cuts on this rank. ``full`` is the weight's
    shape when the tensor is its int8 scale: an axis where the scale has
    size 1 (a contracted axis) stays whole, the others are cut with the
    weight's."""
    cuts = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n, idx = 1, 0
        for a in axes:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coord(a)
        if n == 1 or (full is not None and shape[dim] == 1
                      and full[dim] != 1):
            continue
        if shape[dim] % n:
            raise ValueError(f"axis {dim} of size {shape[dim]} does not "
                             f"divide over {n} ranks ({spec})")
        cuts.append((dim, idx, n))
    return cuts


def _block(t: torch.Tensor, cuts) -> torch.Tensor:
    """The view of ``t`` (whole) that ``cuts`` select."""
    out = t
    for dim, idx, n in cuts:
        chunk = t.shape[dim] // n
        out = out.narrow(dim, idx * chunk, chunk)
    return out


def _shard(mesh: Mesh, t: torch.Tensor, spec: Spec,
           full: tuple[int, ...] | None = None) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (``full`` as ``_cuts``
    takes it). An unsliced tensor comes back as itself (made contiguous); a
    sliced one is a copy, so that it holds no more than its slice."""
    cuts = _cuts(mesh, t.shape, spec, full)
    if not cuts:
        return t.contiguous()
    return _block(t, cuts).clone(memory_format=torch.contiguous_format)


def shard_params(mesh: Mesh, params: Any) -> ShardedParams:
    """This rank's slices of ``params``, each contiguous (the GEMM kernel
    refuses a non-contiguous weight rather than copy it). Quantize before
    sharding: a per-channel scale over an axis that tp splits (``wo`` over
    its heads, ``w_down`` over ff) must be the amax over the whole
    weight."""
    def walk(tree: dict) -> dict:
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif isinstance(leaf, QTensor):
                spec = param_pspec(name)
                out[name] = QTensor(
                    q=_shard(mesh, leaf.q, spec),
                    scale=_shard(mesh, leaf.scale, spec, tuple(leaf.q.shape)))
            else:
                out[name] = _shard(mesh, leaf, param_pspec(name))
        return out

    sharded = ShardedParams(walk(params))
    sharded.layout = (mesh.plan, mesh.rank)
    sharded.shapes = {k: tuple(t.shape)
                      for k, t in flatten_params(params)[0].items()}
    return sharded


def _leaf_specs(flat, qtensors: list[str]
                ) -> dict[str, tuple[Spec, str | None]]:
    """Each flattened leaf's (``flat``: the keys) spec, and for an int8
    scale the key of its weight (``.../q``), whose whole shape ``_cuts``
    needs."""
    q = set(qtensors)
    out = {}
    for key in flat:
        head, _, last = key.rpartition("/")
        if head in q:
            out[key] = (param_pspec(head.rpartition("/")[2]),
                        head + "/q" if last == "scale" else None)
        else:
            out[key] = (param_pspec(last), None)
    return out


def leaf_cuts(plan: MeshPlan, flat, qtensors: list[str],
              shapes: dict[str, tuple[int, ...]]
              ) -> dict[str, list[list[int]]]:
    """Each flattened leaf's (``flat``: the keys) cut axes under ``plan`` as
    [axis, block count] pairs (the same on every rank), given the leaves'
    whole shapes."""
    mesh = Mesh(plan)
    return {key: [[dim, n] for dim, _, n in
                  _cuts(mesh, shapes[key], spec,
                        None if wkey is None else shapes[wkey])]
            for key, (spec, wkey) in _leaf_specs(flat, qtensors).items()}


def unshard_params(plan: MeshPlan, parts: list[dict], qtensors: list[str],
                   shapes: dict[str, tuple[int, ...]]
                   ) -> dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: the whole leaves from every rank's
    slices. ``parts[r]`` is rank r's flattened tree (``flatten_params`` of
    what ``shard_params`` cut for rank r of ``plan``); ``shapes`` gives each
    leaf's whole shape, since one block cannot tell an int8 scale's
    contracted axis of size 1 from an axis cut into blocks of 1. Returns the
    whole leaves, flattened, on the parts' device. A block that several
    ranks hold (a replicated leaf, a scale over a contracted axis) is taken
    from the lowest of them, and another rank's copy that differs raises
    ``ValueError``."""
    if len(parts) != plan.size:
        raise ValueError(f"{plan} has {plan.size} ranks, got {len(parts)} "
                         "parts")
    meshes = [Mesh(plan, r) for r in range(plan.size)]
    out = {}
    for key, (spec, wkey) in _leaf_specs(parts[0], qtensors).items():
        shape = tuple(shapes[key])
        full = None if wkey is None else tuple(shapes[wkey])
        first = parts[0][key]
        whole = torch.empty(shape, dtype=first.dtype, device=first.device)
        owner: dict[tuple, int] = {}
        for r, mesh in enumerate(meshes):
            cuts = _cuts(mesh, shape, spec, full)
            block, region = parts[r][key], _block(whole, cuts)
            if tuple(block.shape) != tuple(region.shape):
                raise ValueError(f"rank {r}'s {key!r} has shape "
                                 f"{tuple(block.shape)}, expected "
                                 f"{tuple(region.shape)} of {shape}")
            at = tuple((dim, idx) for dim, idx, _ in cuts)
            if at in owner:
                if not torch.equal(parts[owner[at]][key], block):
                    raise ValueError(f"rank {r}'s copy of {key!r} differs "
                                     f"from rank {owner[at]}'s")
                continue
            owner[at] = r
            region.copy_(block)
        out[key] = whole
    return out



def _box(mesh: Mesh, shape, spec: Spec,
         full: tuple[int, ...] | None) -> tuple[tuple[int, int], ...]:
    """The [start, stop) on each axis of the block that ``_cuts`` selects
    for ``mesh``'s rank."""
    box = [(0, n) for n in shape]
    for dim, idx, n in _cuts(mesh, shape, spec, full):
        chunk = shape[dim] // n
        box[dim] = (idx * chunk, (idx + 1) * chunk)
    return tuple(box)


def reshard_params(plan: MeshPlan, part, keys: list[str],
                   qtensors: list[str], shapes: dict[str, tuple[int, ...]],
                   mesh: Mesh) -> dict[str, torch.Tensor]:
    """``mesh``'s rank's slices (what ``shard_params(mesh, ...)`` cuts,
    flattened) of a tree whose slices were cut for ``plan``, without the
    whole tree: ``part(r)`` returns rank r's flattened slices and is called
    only for the ranks whose blocks overlap the ones ``mesh``'s rank needs.
    A block that several ranks hold comes from one that is read anyway
    where there is one, else from the lowest. ``keys`` are the flattened
    leaves and ``shapes`` their whole shapes. Returns the slices, flattened,
    on the CPU."""
    src = [Mesh(plan, r) for r in range(plan.size)]
    plans = {}      # key -> (its block here, [(a source block, holders)])
    for key, (spec, wkey) in _leaf_specs(keys, qtensors).items():
        shape = tuple(shapes[key])
        full = None if wkey is None else tuple(shapes[wkey])
        want = _box(mesh, shape, spec, full)
        holders: dict[tuple, list[int]] = {}
        for r, m in enumerate(src):
            have = _box(m, shape, spec, full)
            if all(max(a, c) < min(b, d) for (a, b), (c, d) in
                   zip(want, have)):
                holders.setdefault(have, []).append(r)
        plans[key] = (want, list(holders.items()))
    needed = {rs[0] for _, boxes in plans.values() for _, rs in boxes
              if len(rs) == 1}
    out = {}
    for key, (want, boxes) in plans.items():
        block = None
        for have, rs in boxes:
            r = next((r for r in rs if r in needed), rs[0])
            needed.add(r)
            piece = part(r)[key]
            if tuple(piece.shape) != tuple(b - a for a, b in have):
                raise ValueError(f"rank {r}'s {key!r} has shape "
                                 f"{tuple(piece.shape)}, expected the block "
                                 f"{have} of {tuple(shapes[key])}")
            if block is None:
                block = torch.empty([b - a for a, b in want],
                                    dtype=piece.dtype)
            dst = block
            for dim, ((a, b), (c, d)) in enumerate(zip(want, have)):
                lo, hi = max(a, c), min(b, d)
                dst = dst.narrow(dim, lo - a, hi - lo)
                piece = piece.narrow(dim, lo - c, hi - lo)
            dst.copy_(piece)
        out[key] = block
    return out

# ---- paged serving path ----------------------------------------------
# KV blocks shard like the weights that produced them: over tp on the
# kv_heads axis. Token buffers, block tables and lengths are tiny
# host-fed arrays every rank holds whole — a decode batch is one
# cooperative tp group, not a dp-split workload.


def paged_kv_pspec() -> Spec:
    """[layers, num_blocks, block_size, n_kv, head_dim] — kv heads
    shard over tp, everything else replicated (blocks are a shared
    pool addressed by table, never a parallel axis)."""
    return logical_pspec("layers", None, None, "kv_heads", "head_dim")


def paged_scale_pspec() -> Spec:
    """int8-KV dequant scales, [layers, num_blocks, block_size, n_kv] —
    co-sharded with the pools they scale (kv_heads over tp)."""
    return logical_pspec("layers", None, None, "kv_heads")
