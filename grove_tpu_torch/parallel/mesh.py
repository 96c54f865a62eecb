"""Device meshes over torch.distributed process groups.

The plan arithmetic is the JAX package's, number for number (its
``parallel/mesh.py``): Grove's orchestration layer places a
PodCliqueScalingGroup replica onto one tightly connected group of
accelerators and spreads PodCliqueSet replicas over the slower network
between them, and the in-pod side of that contract is a mesh whose axes
mirror the fabric:

- ``dp`` — data parallelism, across hosts or groups of hosts;
- ``pp`` — pipeline stages (point-to-point activations);
- ``ep`` — expert parallelism (all-to-all dispatch);
- ``sp`` — sequence/context parallelism;
- ``tp`` — tensor parallelism over the fastest links.

Axis order is outermost-to-innermost = slowest-to-fastest interconnect,
so the ranks of one ``tp`` group are adjacent (NVLink peers of one host,
under ``torchrun``'s rank order).

A ``Mesh`` is one process's view of it: the plan, the process's rank in
the default process group, its coordinate on each axis, and one
``AxisComm`` per axis of size > 1 over the process group of the ranks
that share every other coordinate, through which the model's collectives
go. ``build_mesh`` makes one over the default process group (NCCL on the
card, gloo on the CPU). In a world of one process every axis runs its
collectives over the default group, so that a one-card run issues them;
in a larger world an axis of size 1 has no group and runs none.
``single_device_mesh`` has no group and runs none.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"

# Canonical axis order: outermost (slowest fabric) ... innermost (fastest).
# pp sits between dp and sp: stage hops are point-to-point activations —
# cheaper than sp/tp collectives, tolerant of slower links than either.
# ep (expert parallelism) sits between pp and sp: its all_to_all dispatch
# tolerates slower links than sp/tp collectives (and may cross slices for
# very large expert counts), but is chattier than pp's stage hops.
MESH_AXES = (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A concrete (dp, pp, ep, sp, tp) factorisation of a device count."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.ep * self.sp * self.tp

    def axis_sizes(self) -> dict[str, int]:
        return {AXIS_DP: self.dp, AXIS_PP: self.pp, AXIS_EP: self.ep,
                AXIS_SP: self.sp, AXIS_TP: self.tp}


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def mesh_axes_for(n_devices: int, *, want_sp: bool = True,
                  max_tp: int = 8) -> MeshPlan:
    """Pick a sensible (dp, sp, tp) factorisation for ``n_devices``.

    Heuristic: give ``tp`` the largest power-of-two divisor up to ``max_tp``
    (tensor parallelism wants the fastest links and benefits most from being
    wide), then one factor of 2 to ``sp`` when available (ring attention needs
    ≥2 to exercise the ring), and the remainder to ``dp`` — then rebalance
    one factor of 2 from ``tp`` back to ``dp`` when that is the only way to
    get dp ≥ 2: a flagship plan whose every axis is > 1 exercises dp grad
    sync, ring-SP, and tp reductions in ONE train step (at 8 devices this
    yields (dp=2, sp=2, tp=2), not (1, 2, 4)), and dp is the axis that
    scales across hosts, so a plan without it under-represents the
    deployment shape.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    tp = _largest_pow2_divisor(n_devices, min(max_tp, n_devices))
    rest = n_devices // tp
    sp = 1
    if want_sp and rest % 2 == 0 and rest >= 2:
        sp = 2
    dp = rest // sp
    while dp == 1 and tp > 2:
        tp //= 2
        dp *= 2
    while sp == 1 and want_sp and tp > 2:
        tp //= 2
        sp *= 2
    plan = MeshPlan(dp=dp, sp=sp, tp=tp)
    assert plan.size == n_devices, (plan, n_devices)
    return plan


def validate_plan_fits_slice(plan: MeshPlan, slice_chips: int) -> None:
    """Gang contract: tp*sp must fit inside one tightly connected slice.

    dp may cross slices; tp and sp traffic must stay on the fast links; pp
    stage hops are point-to-point activation transfers and may cross
    slices (each stage's tp*sp group must still be slice-resident). The
    orchestrator enforces the pod-placement half of this (slice-atomic
    PodGangs); this checks the in-pod mesh half.
    """
    ici = plan.tp * plan.sp
    if ici > slice_chips:
        raise ValueError(
            f"tp*sp={ici} exceeds slice size {slice_chips}; "
            "sequence/tensor parallel groups must be ICI-resident")
    if slice_chips % ici != 0:
        raise ValueError(
            f"slice size {slice_chips} not divisible by tp*sp={ici}")


class AxisComm:
    """The collectives of one mesh axis over its process group.
    ``launches`` counts the collectives launched, on the host, as each kernel
    wrapper counts its launches: a captured CUDA graph launches its
    collectives at each replay, and the engine moves the count taken while
    capturing onto the replay. A collective that autograd runs in a
    backward pass counts there too.

    ``all_reduce`` is the plain sum (the serving path, under no grad). The
    training path's collectives are ``torch.autograd.Function``s, each with
    the backward its forward needs:

    - ``copy_to`` (identity; the backward sums the cotangent over the axis)
      and ``reduce_from`` (the sum; the backward is the identity): the
      Megatron pair, put where a tp-replicated activation enters a head- or
      ff-sharded product and where that product's partial sums meet. Every
      tp rank computes the same loss, so the library's differentiable
      all-reduce, whose backward sums the cotangent again, would make the
      replicated leaves' gradients tp times too large;
    - ``all_to_all`` (a contiguous split of the leading axis, one chunk per
      rank; the exchange is its own inverse, so the backward is another);
    - ``shift`` (the ring and pipeline hop; the backward hops back);
    - ``all_gather`` (the backward takes this rank's slice)."""

    def __init__(self, group, size: int, rank: int,
                 ranks: list[int] | None = None) -> None:
        self.group = group
        self.size = size     # ranks on the axis
        self.rank = rank     # this process's coordinate on it
        # the default group's rank of each coordinate (point-to-point peers)
        self.ranks = list(ranks) if ranks is not None else list(range(size))
        self.launches = 0

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def all_reduce(self, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The sum (or ``op``) of ``x`` over the axis (in place where ``x``
        is contiguous; the result is returned either way). Not
        differentiable."""
        x = x.contiguous()
        self.launches += 1
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` joined on ``dim`` (the last axis by default), in
        rank order. Its gradient is this rank's slice of the cotangent: the
        ranks compute the same function of the joined tensor."""
        return _AllGather.apply(self, dim, x)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its gradient is the cotangent summed over the
        axis."""
        return _CopyTo.apply(self, x)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis; its gradient is the cotangent as
        it is."""
        return _ReduceFrom.apply(self, x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [size, ...]: chunk i goes to coordinate i, and chunk i of
        the result came from coordinate i."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all splits a leading axis of "
                             f"{self.size}, got {tuple(x.shape)}")
        return _AllToAll.apply(self, x)

    def shift(self, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """The ring hop: ``x`` goes to coordinate rank + offset and the
        result is what coordinate rank - offset sent (``lax.ppermute`` with
        the perm i -> i + offset). At axis size 1 it is a local copy: gloo
        refuses a send to the process's own rank, and the hop of a ring of
        one is the identity, as JAX's ``ppermute`` over perm [(0, 0)]."""
        return _Shift.apply(self, offset, x)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` (contiguous) overwritten in place with coordinate ``src``'s
        ``x``. Not differentiable."""
        self.launches += 1
        dist.broadcast(x, self.ranks[src], group=self.group)
        return x

    def all_ok(self, ok: bool) -> bool:
        """A barrier that also says whether every rank of the axis passed
        ``ok``: True on every rank, or False on every rank."""
        flag = torch.tensor([int(ok)], dtype=torch.int32,
                            device=self.scalar_device)
        return bool(self.all_reduce(flag, op=dist.ReduceOp.MIN).item())

    @property
    def scalar_device(self) -> torch.device:
        """Where a small host-side exchange lives: the current card under
        NCCL, which moves CUDA tensors only; the CPU under gloo."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    # ---- the raw collectives under the Functions ----

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.size)]
        self.launches += 1
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def _exchange(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self.launches += 1
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def _hop(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        if offset % self.size == 0:
            return x.clone(memory_format=torch.contiguous_format)
        x = x.contiguous()
        out = torch.empty_like(x)
        dst = self.ranks[(self.rank + offset) % self.size]
        src = self.ranks[(self.rank - offset) % self.size]
        self.launches += 1
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, dst, self.group),
                dist.P2POp(dist.irecv, out, src, self.group)]):
            req.wait()
        return out


def _summed(comm: AxisComm, g: torch.Tensor) -> torch.Tensor:
    """``g`` summed over the axis, into a copy: autograd may hand the same
    cotangent tensor to more than one input."""
    return comm.all_reduce(g.clone(memory_format=torch.contiguous_format))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _summed(ctx.comm, g)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        return _summed(comm, x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm._exchange(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._exchange(g)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, offset, x):
        ctx.comm, ctx.offset = comm, offset
        return comm._hop(x, offset)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.comm._hop(g, -ctx.offset)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, dim, x):
        ctx.comm, ctx.dim = comm, dim
        return comm._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.comm.size
        return None, None, g.narrow(ctx.dim, ctx.comm.rank * n, n)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comms, *xs):
        ctx.comms = comms
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = [None, *gs]
        for i, g in enumerate(gs):
            if not ctx.needs_input_grad[i + 1]:
                out[i + 1] = None
                continue
            g = g.clone(memory_format=torch.contiguous_format)
            for comm in ctx.comms:
                comm.all_reduce(g)
            out[i + 1] = g
        return tuple(out)


def sum_grads(tensors, comms) -> list[torch.Tensor]:
    """``tensors``, each as a view of itself whose gradient is summed over
    every axis of ``comms`` (None entries skipped): the gradient of a leaf
    that every rank of those axes holds whole, each rank having computed
    its part of the loss from other tokens. One autograd step runs all the
    sums, in the order of ``tensors`` and then of ``comms``, after every
    use of every tensor: the same order on every rank."""
    comms = tuple(c for c in comms if c is not None)
    tensors = list(tensors)
    if not comms or not tensors:
        return tensors
    return list(_SumGrads.apply(comms, *tensors))


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep_meta = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def tie(x: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """``x``, with ``dep`` made an input of it whose gradient is zero.
    Autograd runs a node's backward only if its output reaches the loss on
    this rank; where a rank skips work that another does (a ring block in
    the causal future, a pipeline bubble), the tie keeps the skipped input
    in the graph, so that the collective which made it (a shift) runs its
    backward on every rank, as its peers expect."""
    if not (torch.is_grad_enabled() and dep.requires_grad):
        return x
    return _Tie.apply(x, dep)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One process's view of a mesh: the plan, the process's rank (tp
    fastest, as ``MESH_AXES`` orders the axes) and, for a mesh over a
    process group, each axis's ``AxisComm``. Without ``comms`` (the
    single-device mesh, or a layout made to slice weights for a given rank)
    no collective runs."""

    plan: MeshPlan
    rank: int = 0
    comms: Mapping[str, AxisComm] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not 0 <= self.rank < self.plan.size:
            raise ValueError(f"rank {self.rank} is outside {self.plan}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, every axis included (JAX's ``mesh.shape``)."""
        return self.plan.axis_sizes()

    @property
    def axis_names(self) -> tuple[str, ...]:
        return MESH_AXES

    def coord(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        inner = 1
        for name in reversed(MESH_AXES):
            if name == axis:
                return self.rank // inner % self.shape[name]
            inner *= self.shape[name]
        raise KeyError(axis)

    def comm(self, axis: str) -> AxisComm | None:
        """The axis's collectives, or None where the axis has no group (a
        mesh without a group, or an axis of size 1 in a larger world)."""
        return self.comms.get(axis)


def _axis_groups(plan: MeshPlan, axis: str) -> list[list[int]]:
    """The ranks of each group along ``axis``: those that share every
    other coordinate, in order of their coordinate on ``axis``."""
    sizes = plan.axis_sizes()
    stride = 1
    for name in reversed(MESH_AXES):
        if name == axis:
            break
        stride *= sizes[name]
    n = sizes[axis]
    starts = [r for r in range(plan.size) if r // stride % n == 0]
    return [[s + i * stride for i in range(n)] for s in starts]


def build_mesh(plan: MeshPlan | None = None,
               ranks=None) -> Mesh | None:
    """A ``Mesh`` over torch.distributed's default process group, which must
    be initialised already (``torch.distributed.init_process_group``: NCCL
    for CUDA tensors, gloo for CPU ones). ``ranks`` are the default group's
    ranks the mesh spans, in mesh order (all of them by default, JAX's
    ``devices[:n]`` where fewer); a process outside them gets None. When
    ``plan`` is None, a plan is derived from their count. Every process of
    the default group calls this with the same arguments, members or not:
    each axis of size > 1 gets a process group per set of ranks along it
    (the default group where the axis spans it), made by all processes in
    one order. In a world of one, every axis runs over the default
    group."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs torch.distributed's default "
                           "process group: call init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    members = list(range(world)) if ranks is None else list(ranks)
    if plan is None:
        plan = mesh_axes_for(len(members))
    if plan.size != len(members):
        raise ValueError(
            f"mesh plan {plan} needs {plan.size} processes, have "
            f"{len(members)}")
    comms = {}
    for axis, n in plan.axis_sizes().items():
        if n == 1 and world > 1:
            continue
        for coords in _axis_groups(plan, axis):
            group_ranks = [members[c] for c in coords]
            group = (dist.group.WORLD if group_ranks == list(range(world))
                     else dist.new_group(group_ranks))
            if rank in group_ranks:
                comms[axis] = AxisComm(group, len(group_ranks),
                                       group_ranks.index(rank), group_ranks)
    if rank not in members:
        return None
    return Mesh(plan, members.index(rank), comms)


def single_device_mesh() -> Mesh:
    """A trivial 1x1x1 mesh (single-device serving): no process group, no
    collective."""
    return Mesh(MeshPlan())
