"""The port's mesh plans and sharding rules (grove_tpu_torch/parallel/)
against the JAX package's: ``MeshPlan``, ``mesh_axes_for`` and
``validate_plan_fits_slice`` number for number, the logical rules and
every parameter spec entry for entry, each rank's place on each axis, and
``shard_params``'s slices bitwise against the shards ``jax.device_put``
puts on each device of the virtual CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.models import moe as jmoe
from grove_tpu.parallel import mesh as jmesh
from grove_tpu.parallel import sharding as jsharding
from grove_tpu.serving import quant as jquant
from grove_tpu_torch.parallel import mesh as tmesh
from grove_tpu_torch.parallel import sharding as tsharding
from grove_tpu_torch.serving.quant import QTensor, flatten_params

torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32)
J_MOE = dataclasses.replace(jmoe.MOE_CONFIGS["moe-test-tiny"],
                            dtype=jnp.float32)
PLANS = [dict(), dict(tp=2), dict(tp=4), dict(tp=8), dict(dp=2, tp=2),
         dict(dp=2, sp=2, tp=2), dict(pp=2, tp=4), dict(ep=2, tp=2),
         dict(dp=2, ep=4), dict(sp=4, tp=2), dict(dp=8)]


def _plans(kw):
    return jmesh.MeshPlan(**kw), tmesh.MeshPlan(**kw)


# ---- plan arithmetic ----

def test_axis_names_and_order_equal_jax():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert (tmesh.AXIS_DP, tmesh.AXIS_PP, tmesh.AXIS_EP, tmesh.AXIS_SP,
            tmesh.AXIS_TP) == (jmesh.AXIS_DP, jmesh.AXIS_PP, jmesh.AXIS_EP,
                               jmesh.AXIS_SP, jmesh.AXIS_TP)


@pytest.mark.parametrize("kw", PLANS, ids=str)
def test_mesh_plan_equals_jax(kw):
    j, t = _plans(kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.size == j.size
    assert t.axis_sizes() == j.axis_sizes()


@pytest.mark.parametrize("want_sp,max_tp", [(True, 8), (False, 8),
                                            (True, 4), (False, 2),
                                            (True, 1), (True, 16)])
def test_mesh_axes_for_equals_jax(want_sp, max_tp):
    for n in range(1, 65):
        want = jmesh.mesh_axes_for(n, want_sp=want_sp, max_tp=max_tp)
        got = tmesh.mesh_axes_for(n, want_sp=want_sp, max_tp=max_tp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), n
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError):
            mod.mesh_axes_for(0)


@pytest.mark.parametrize("kw,chips", [
    (dict(tp=4), 8), (dict(tp=4, sp=2), 8), (dict(tp=8, sp=2), 8),
    (dict(tp=4), 6), (dict(dp=4, tp=2), 4), (dict(tp=3), 4),
    (dict(pp=2, tp=4), 4), (dict(sp=2), 16)])
def test_validate_plan_fits_slice_equals_jax(kw, chips):
    j, t = _plans(kw)
    try:
        jmesh.validate_plan_fits_slice(j, chips)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        assert tmesh.validate_plan_fits_slice(t, chips) is None
    else:
        with pytest.raises(ValueError) as got:
            tmesh.validate_plan_fits_slice(t, chips)
        assert str(got.value) == want


@pytest.mark.parametrize("kw", PLANS, ids=str)
def test_rank_coords_and_axis_groups_follow_jax_device_layout(kw,
                                                              cpu_devices):
    """The JAX mesh lays device i out at its (dp, pp, ep, sp, tp) place;
    the port's rank i takes the same place, and each axis's groups are the
    device-array lines along that axis."""
    j, t = _plans(kw)
    jm = jmesh.build_mesh(j, cpu_devices[:j.size])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    first = min(d.id for d in cpu_devices[:j.size])
    ids = ids - first
    for r in range(t.size):
        place = dict(zip(jmesh.MESH_AXES,
                         (int(c[0]) for c in np.nonzero(ids == r))))
        m = tmesh.Mesh(t, rank=r)
        assert {a: m.coord(a) for a in tmesh.MESH_AXES} == place
    for i, axis in enumerate(tmesh.MESH_AXES):
        lines = np.moveaxis(ids, i, -1).reshape(-1, ids.shape[i])
        assert sorted(map(list, lines.tolist())) == \
            sorted(tmesh._axis_groups(t, axis))
    assert tmesh.Mesh(t).shape == dict(jm.shape)


def test_single_device_mesh_has_no_group():
    m = tmesh.single_device_mesh()
    assert m.shape == dict(jmesh.single_device_mesh().shape)
    assert m.shape.get("tp", 1) == 1 and m.comm("tp") is None
    with pytest.raises(ValueError):
        tmesh.Mesh(tmesh.MeshPlan(tp=2), rank=2)


def test_build_mesh_needs_a_process_group():
    """No quiet single-device mesh when no group was formed."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.build_mesh(tmesh.MeshPlan(tp=2))


# ---- specs ----

def test_logical_rules_equal_jax():
    assert tsharding.LOGICAL_RULES == jsharding.LOGICAL_RULES
    for name in jsharding.LOGICAL_RULES:
        assert tsharding.logical_pspec(name, None) == \
            tuple(jsharding.logical_pspec(name, None))
    for mod in (jsharding, tsharding):
        with pytest.raises(KeyError):
            mod.logical_pspec("embedding")


@pytest.mark.parametrize("name", sorted(jsharding._PARAM_RULES))
def test_param_pspec_equals_jax(name):
    assert tsharding.param_pspec(name) == tuple(jsharding.param_pspec(name))


def test_paged_pool_specs_equal_jax():
    assert tsharding.paged_kv_pspec() == tuple(jsharding.paged_kv_pspec())
    assert tsharding.paged_scale_pspec() == \
        tuple(jsharding.paged_scale_pspec())


def _jax_tree(quantized: bool, moe: bool = False):
    if moe:
        jp = jmoe.init_params(J_MOE, jax.random.PRNGKey(0))
    else:
        jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jquant.quantize_params(jp) if quantized else jp


def _port_tree(jp):
    """A JAX params tree (int8 leaves too) as the port's."""
    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif isinstance(leaf, jquant.QTensor):
                out[name] = QTensor(
                    q=torch.from_numpy(np.array(leaf.q)),
                    scale=torch.from_numpy(np.array(
                        leaf.scale.astype(jnp.float32))).to(torch.bfloat16))
            else:
                out[name] = torch.from_numpy(np.array(leaf))
        return out
    return walk(jp)


def _flat_specs(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat_specs(leaf, prefix + name + "/"))
        elif isinstance(leaf, QTensor):
            out[prefix + name + "/q"] = leaf.q
            out[prefix + name + "/scale"] = leaf.scale
        else:
            out[prefix + name] = leaf
    return out


@pytest.mark.parametrize("quantized,moe", [(False, False), (True, False),
                                           (False, True)])
def test_param_pspecs_equal_jax(quantized, moe):
    """Every leaf's spec, int8 ``q`` and ``scale`` leaves included."""
    jp = _jax_tree(quantized, moe)
    want = {jax.tree_util.keystr(path, simple=True, separator="/"):
            tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                jsharding.param_pspecs(jp),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    got = _flat_specs(tsharding.param_pspecs(_port_tree(jp)))
    assert got == want


# ---- this rank's slices ----

@pytest.mark.parametrize("kw,quantized,moe", [
    (dict(tp=2), False, False), (dict(tp=4), False, False),
    (dict(dp=2, tp=4), False, False), (dict(tp=2), True, False),
    (dict(tp=4), True, False), (dict(dp=2, tp=2), True, False),
    (dict(ep=2, tp=2), False, True)], ids=str)
def test_shard_params_are_jax_device_shards(kw, quantized, moe, cpu_devices):
    """Rank r's slice of every leaf is bitwise the shard JAX's
    ``shard_params`` puts on device r (an int8 weight's ``q`` too; JAX
    replicates the scale and the port cuts its full-size axes with the
    weight's), each contiguous; concatenated over the ranks of its axes the
    slices rebuild the leaf bitwise."""
    j, t = _plans(kw)
    jp = _jax_tree(quantized, moe)
    jm = jmesh.build_mesh(j, cpu_devices[:j.size])
    jflat = {jax.tree_util.keystr(p, simple=True, separator="/"): a
             for p, a in jax.tree_util.tree_flatten_with_path(
                 jsharding.shard_params(jm, jp))[0]}
    full = _port_tree(jp)
    fflat, _ = flatten_params(full)
    shards = [flatten_params(tsharding.shard_params(
        tmesh.Mesh(t, rank=r), full))[0] for r in range(t.size)]
    for key, leaf in fflat.items():
        arr = jflat[key]
        dev_shard = {s.device.id - cpu_devices[0].id: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for r in range(t.size):
            got = shards[r][key]
            assert got.is_contiguous(), key
            if key.endswith("/scale"):
                continue
            want = dev_shard[r]
            assert tuple(got.shape) == want.shape, key
            assert np.array_equal(got.float().numpy(),
                                  want.astype(np.float32)), (key, r)
        _rebuilds(leaf, [s[key] for s in shards])


def _rebuilds(leaf, parts):
    """The ranks' slices, deduplicated and joined, equal ``leaf``."""
    uniq = []
    for p in parts:
        if not any(p.shape == u.shape and torch.equal(p, u) for u in uniq):
            uniq.append(p)
    if len(uniq) == 1:
        assert torch.equal(uniq[0], leaf)
        return
    dim = next(i for i, (a, b) in enumerate(zip(uniq[0].shape, leaf.shape))
               if a != b)
    assert torch.equal(torch.cat(uniq, dim=dim), leaf)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_rebuild_every_leaf(tp):
    """Concatenated over the tp ranks, each leaf's slices are the leaf,
    bitwise; unsharded leaves come back as the caller's own tensors; int8
    ``wo``/``w_down`` scales stay whole, ``wq``/``w_gate``/``lm_head``/
    ``tok_embed`` scales are cut on heads, ff and vocab."""
    full = _port_tree(_jax_tree(True))
    fflat, _ = flatten_params(full)
    ranks = [tsharding.shard_params(tmesh.Mesh(tmesh.MeshPlan(tp=tp),
                                               rank=r), full)
             for r in range(tp)]
    flats = [flatten_params(s)[0] for s in ranks]
    for key, leaf in fflat.items():
        parts = [f[key] for f in flats]
        assert all(p.is_contiguous() for p in parts)
        _rebuilds(leaf, parts)
    assert ranks[0]["final_norm"] is full["final_norm"]
    lay = {k: ranks[0]["layers"][k].scale.shape for k in
           ("wq", "wo", "w_gate", "w_down")}
    L, H, HD, D, FF = (J_CFG.n_layers, J_CFG.n_heads, J_CFG.head_dim,
                       J_CFG.d_model, J_CFG.d_ff)
    assert lay == {"wq": (L, 1, H // tp, HD), "wo": (L, 1, 1, D),
                   "w_gate": (L, 1, FF // tp), "w_down": (L, 1, D)}
    assert ranks[0]["lm_head"].scale.shape == (1, J_CFG.vocab_size // tp)
    assert ranks[0]["tok_embed"].scale.shape == (J_CFG.vocab_size // tp, 1)
    assert ranks[1].layout == (tmesh.MeshPlan(tp=tp), 1)


def test_shard_params_refuses_an_uneven_split():
    w = {"lm_head": torch.zeros((4, 6))}
    with pytest.raises(ValueError, match="divide"):
        tsharding.shard_params(tmesh.Mesh(tmesh.MeshPlan(tp=4)), w)


# ---- the inverse: unshard_params ----

@pytest.mark.parametrize("kw", [dict(tp=2), dict(tp=4),
                                dict(dp=2, tp=2), dict(ep=2, tp=2)], ids=str)
@pytest.mark.parametrize("tree", ["llama", "int8", "moe"])
def test_unshard_params_inverts_shard_params(kw, tree):
    """Every rank's slices give the whole tree back bitwise, int8 scales
    included: a scale over a contracted axis is held whole by every rank,
    and at tp = 4 ``wk``'s scale is cut into blocks of one head, which
    only the recorded whole shapes tell from a contracted axis; MoE experts
    are cut over ep x tp. The recorded shapes are the whole tree's."""
    quant = tree == "int8"
    full = _port_tree(_jax_tree(quant, moe=tree == "moe"))
    plan = tmesh.MeshPlan(**kw)
    ranks = [tsharding.shard_params(tmesh.Mesh(plan, rank=r), full)
             for r in range(plan.size)]
    fflat, fq = flatten_params(full)
    assert ranks[0].shapes == {k: tuple(t.shape) for k, t in fflat.items()}
    got = tsharding.unshard_params(plan, [flatten_params(r)[0]
                                          for r in ranks], fq,
                                   ranks[0].shapes)
    assert list(got) == list(fflat)
    for k, t in fflat.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    cuts = tsharding.leaf_cuts(plan, fflat, fq, ranks[0].shapes)
    assert cuts["layers/wq" + ("/q" if quant else "")] == [[2, plan.tp]]
    if tree == "moe":
        assert cuts["layers/we_up"] == [[1, plan.ep * plan.tp]]


def test_unshard_params_refuses_copies_that_differ():
    """A replicated leaf whose copies differ between ranks, a part of the
    wrong shape and a missing rank raise."""
    full = _port_tree(_jax_tree(True))
    plan = tmesh.MeshPlan(tp=2)
    parts = [flatten_params(tsharding.shard_params(
        tmesh.Mesh(plan, rank=r), full))[0] for r in range(2)]
    fq = flatten_params(full)[1]
    shapes = {k: tuple(t.shape) for k, t in flatten_params(full)[0].items()}
    bad = dict(parts[1])
    bad["layers/wo/scale"] = bad["layers/wo/scale"] * 2
    with pytest.raises(ValueError, match="rank 1's copy"):
        tsharding.unshard_params(plan, [parts[0], bad], fq, shapes)
    bad = dict(parts[1])
    bad["layers/wq/q"] = bad["layers/wq/q"][:, :, :1]
    with pytest.raises(ValueError, match="has shape"):
        tsharding.unshard_params(plan, [parts[0], bad], fq, shapes)
    with pytest.raises(ValueError, match="2 ranks"):
        tsharding.unshard_params(plan, parts[:1], fq, shapes)


# ---- another plan's slices: reshard_params ----

@pytest.mark.parametrize("src,dst", [(dict(tp=2), dict(tp=4)),
                                     (dict(tp=4), dict(tp=2)),
                                     (dict(), dict(tp=4)),
                                     (dict(tp=4), dict())], ids=str)
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_reshard_params_reads_only_the_overlapping_ranks(src, dst, quant):
    """Each target rank's slices, built from another plan's, are bitwise
    what ``shard_params`` cuts for it from the whole tree, int8 scales
    included, and only the source ranks whose blocks overlap the target
    rank's are read: from tp = 2 to tp = 4 one source rank each, from
    tp = 4 to tp = 2 two, to one rank every source rank."""
    full = _port_tree(_jax_tree(quant))
    fflat, fq = flatten_params(full)
    splan, tplan = tmesh.MeshPlan(**src), tmesh.MeshPlan(**dst)
    parts = [flatten_params(tsharding.shard_params(
        tmesh.Mesh(splan, rank=r), full))[0] for r in range(splan.size)]
    shapes = {k: tuple(t.shape) for k, t in fflat.items()}
    for rank in range(tplan.size):
        read = []
        got = tsharding.reshard_params(
            splan, lambda r: read.append(r) or parts[r], list(fflat), fq,
            shapes, tmesh.Mesh(tplan, rank=rank))
        want = flatten_params(tsharding.shard_params(
            tmesh.Mesh(tplan, rank=rank), full))[0]
        assert list(got) == list(want)
        for k, t in want.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        per = max(1, splan.size // tplan.size)
        first = rank * splan.size // tplan.size
        assert sorted(set(read)) == list(range(first, first + per)), read
