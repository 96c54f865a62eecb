"""The port's expert-parallel MoE (``models/moe.py``: ``_ep_moe_block``,
``ep_forward``, ``loss_fn(ep=True)``) over a dp=2 x ep=4 gloo world of 8
(tests/torch_parallel_worlds.py) against the JAX package's on its virtual
CPU mesh of the same plan, on the same numpy weights and tokens
(moe-test-tiny in f32):

- ``ep_forward``'s logits and auxiliary at 1e-5: both compute the same
  algorithm (capacity buckets, drops and all), so this is not the 8e-2 of
  JAX's ep-versus-dense test; where nothing drops, the ep logits are the
  dense path's;
- one block at a tight capacity: the set of dropped assignments is JAX's
  exactly (top-1 routing, where a dropped token's MoE output is exactly
  zero), and the outputs match at 1e-5 with top-1 and top-2 routing;
- the ep loss's gradient through both exchanges and the auxiliary: each
  rank's slice within 1e-4 of its leaf's max norm;
- every guard of ``ep_forward`` raises with JAX's type and message;
- the repairs to the dense path's signatures, against JAX:
  ``forward(capacity_factor=)``, ``loss_fn(aux_weight=,
  capacity_factor=)``, and ``forward(mesh=m, ep=False)`` running dense."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_worlds as worlds
from grove_tpu.models import moe as jmoe
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import moe as tmoe
from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
from grove_tpu_torch.parallel.sharding import shard_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

DP, EP = worlds.EP_PLAN


def _jcfg(k: int = 2):
    return dataclasses.replace(jmoe.MOE_CONFIGS["moe-test-tiny"],
                               dtype=jnp.float32, experts_per_token=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.shared_run(tmp_path_factory)


@pytest.fixture(scope="module")
def jmesh(cpu_devices):
    return jbuild_mesh(JMeshPlan(dp=DP, ep=EP), cpu_devices[:8])


@pytest.fixture(scope="module")
def inputs():
    cfg, tree = worlds.moe_inputs()
    assert worlds.config_fields(cfg) == {
        f.name: getattr(_jcfg(), f.name)
        for f in dataclasses.fields(_jcfg()) if f.name != "dtype"}
    return tree, worlds.np_tokens(worlds.EP_TOKENS, cfg.vocab_size, 2)


@pytest.fixture(scope="module")
def jax_ep(inputs, jmesh):
    tree, tokens = inputs
    params = jax.tree.map(jnp.asarray, tree)
    toks = jnp.asarray(tokens)
    logits, aux = jax.jit(lambda p: jmoe.ep_forward(_jcfg(), p, toks,
                                                    jmesh))(params)
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(_jcfg(), p, toks, mesh=jmesh,
                               ep=True)))(params)
    dense = jax.jit(lambda p: jmoe.forward(_jcfg(), p, toks))(params)
    return dict(logits=np.asarray(logits), aux=float(aux),
                loss=float(value), dense=np.asarray(dense),
                grads=jax.tree.map(np.asarray, grads))


def _ranks(runs, key):
    """The ranks' blocks of ``key`` in rank order: dp major, ep minor, the
    order of the batch's (dp, ep) blocks."""
    return [arrays[key] for arrays, _ in runs[8]]


def test_ep_forward_matches_jax(runs, jax_ep):
    np.testing.assert_allclose(np.concatenate(_ranks(runs, "ep/logits")),
                               jax_ep["logits"], rtol=1e-5, atol=1e-5)
    for aux in _ranks(runs, "ep/aux"):
        assert abs(float(aux) - jax_ep["aux"]) <= 1e-5 * jax_ep["aux"]


def test_ep_without_drops_is_the_dense_path(runs, jax_ep):
    """At a capacity factor of n_experts no assignment drops: the logits
    are the dense path's (JAX's own test holds them at 8e-2 in bf16)."""
    np.testing.assert_allclose(
        np.concatenate(_ranks(runs, "ep/logits_roomy")), jax_ep["dense"],
        rtol=1e-4, atol=1e-4)


def test_ep_loss_and_gradient_slices_match_jax(runs, jax_ep):
    grads = params_from_numpy(jax_ep["grads"], device="cpu")
    for rank, (arrays, _) in enumerate(runs[8]):
        got = float(arrays["ep/loss"])
        assert abs(got - jax_ep["loss"]) <= 1e-5 * jax_ep["loss"]
        want = worlds._flat(shard_params(
            Mesh(MeshPlan(dp=DP, ep=EP), rank), grads))
        for path, g in want.items():
            g = g.numpy()
            err = (np.abs(arrays[f"ep/grad/{path}"] - g).max()
                   / max(np.abs(g).max(), 1e-30))
            assert err <= 1e-4, (rank, path, err)


@pytest.fixture(scope="module")
def jax_blocks(jmesh):
    """JAX's ``_ep_moe_block`` under shard_map on layer 0's weights at the
    tight capacity, top-1 and top-2: (input, output) per k."""
    rows, s = worlds.EP_BLOCK_ROWS
    out = {}
    for k in (1, 2):
        cfg = _jcfg(k)
        _, tree = worlds.moe_inputs(experts_per_token=k)
        lp = {n: jnp.asarray(tree["layers"][n][0])
              for n in ("mlp_norm", "router", "we_gate", "we_up", "we_down")}
        x = np.random.default_rng(3).standard_normal(
            (DP * EP * rows, s, cfg.d_model)).astype(np.float32)
        batch = P(("dp", "ep"))
        specs = {n: (P("ep") if n.startswith("we_") else P()) for n in lp}

        def body(x, lp, cfg=cfg):
            y, aux = jmoe._ep_moe_block(cfg, x, lp, worlds.EP_TIGHT)
            return y, aux[None]

        fn = jmoe._shard_map(body, mesh=jmesh, in_specs=(batch, specs),
                             out_specs=(batch, batch))
        y, aux = jax.jit(fn)(jnp.asarray(x), lp)
        out[k] = (x, np.asarray(y), np.asarray(aux))
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_tight_capacity_block_matches_jax(runs, jax_blocks, k):
    x, y, aux = jax_blocks[k]
    got = np.concatenate(_ranks(runs, f"ep/block/k{k}/out"))
    np.testing.assert_allclose(got, y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        [float(a) for a in _ranks(runs, f"ep/block/k{k}/aux")], aux,
        rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, x, atol=1e-3)


def test_tight_capacity_drops_what_jax_drops(runs, jax_blocks):
    """Top-1 routing: JAX's dropped tokens are those whose output is their
    input exactly (the zero pad row times the gate weight); the port's
    kept flags name the same tokens, and some did drop."""
    x, y, _ = jax_blocks[1]
    jax_kept = (y != x).any(axis=-1).reshape(-1)
    kept = np.concatenate(_ranks(runs, "ep/block/k1/kept"))
    np.testing.assert_array_equal(kept, jax_kept)
    assert 0 < (~kept).sum() < kept.size


@pytest.mark.parametrize("plan,batch", [
    (None, 8),
    (dict(dp=2), 8),
    (dict(ep=3), 6),
    (dict(dp=2, ep=2, tp=2), 8),
    (dict(dp=2, ep=2, sp=2), 8),
    (dict(dp=2, ep=2, pp=2), 8),
    (dict(dp=2, ep=4), 4),
])
def test_ep_forward_guards_raise_as_jax(cpu_devices, plan, batch):
    tcfg, tree = worlds.moe_inputs()
    toks = np.zeros((batch, 8), np.int32)
    jmesh = tmesh = None
    if plan is not None:
        jplan = JMeshPlan(**plan)
        jmesh = jbuild_mesh(jplan, cpu_devices[:jplan.size])
        tmesh = Mesh(MeshPlan(**plan))
    with pytest.raises(AssertionError) as jerr:
        jmoe.ep_forward(_jcfg(), jax.tree.map(jnp.asarray, tree),
                        jnp.asarray(toks), jmesh)
    with pytest.raises(AssertionError) as terr:
        tmoe.ep_forward(tcfg, params_from_numpy(tree, device="cpu"),
                        torch.from_numpy(toks), tmesh)
    assert str(terr.value) == str(jerr.value)


def test_ep_forward_refuses_whole_experts():
    """Every expert on every rank, where the rank's slice belongs: a
    ``ValueError`` rather than a silent replica of the experts."""
    tcfg, tree = worlds.moe_inputs()
    with pytest.raises(ValueError, match="shard_params"):
        tmoe.ep_forward(tcfg, params_from_numpy(tree, device="cpu"),
                        torch.zeros((8, 8), dtype=torch.int32),
                        Mesh(MeshPlan(dp=2, ep=4)))


@pytest.fixture(scope="module")
def dense_inputs():
    tcfg, tree = worlds.moe_inputs()
    toks = worlds.np_tokens((2, 16), tcfg.vocab_size, 4)
    return (tcfg, params_from_numpy(tree, device="cpu"),
            torch.from_numpy(toks), jax.tree.map(jnp.asarray, tree),
            jnp.asarray(toks))


def test_forward_takes_capacity_factor_as_jax(dense_inputs):
    """The dense path accepts ``capacity_factor`` and, as JAX's, does not
    use it."""
    tcfg, tp, tt, jp, jt = dense_inputs
    want = np.asarray(jmoe.forward(_jcfg(), jp, jt, capacity_factor=0.5))
    got = tmoe.forward(tcfg, tp, tt, capacity_factor=0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tmoe.forward(tcfg, tp, tt))


def test_loss_fn_takes_aux_weight_and_capacity_factor_as_jax(dense_inputs):
    tcfg, tp, tt, jp, jt = dense_inputs
    want = float(jmoe.loss_fn(_jcfg(), jp, jt, aux_weight=0.5,
                              capacity_factor=0.5))
    got = float(tmoe.loss_fn(tcfg, tp, tt, aux_weight=0.5,
                             capacity_factor=0.5))
    assert abs(got - want) <= 1e-5 * want


def test_forward_with_mesh_and_no_ep_runs_dense_as_jax(dense_inputs,
                                                       cpu_devices):
    """``forward(mesh=m, ep=False)`` is the dense path on the params given
    (JAX ignores the mesh there)."""
    tcfg, tp, tt, jp, jt = dense_inputs
    jm = jbuild_mesh(JMeshPlan(dp=2, ep=4), cpu_devices[:8])
    want = np.asarray(jmoe.forward(_jcfg(), jp, jt, mesh=jm, ep=False))
    got = tmoe.forward(tcfg, tp, tt, mesh=Mesh(MeshPlan(dp=2, ep=4)),
                       ep=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tmoe.forward(tcfg, tp, tt))


def test_decoder_stack_is_the_one_skeleton():
    """Both paths run ``_decoder_stack``: at ep = 1 without a group the
    expert-parallel block over every expert, with room for every
    assignment, gives the dense path's logits and a positive auxiliary."""
    tcfg, tree = worlds.moe_inputs()
    p = params_from_numpy(tree, device="cpu")
    toks = torch.from_numpy(worlds.np_tokens((2, 16), tcfg.vocab_size, 4))
    dense, zero = tmoe._decoder_stack(
        tcfg, p, toks, lambda x, lp: (tmoe._moe_block(tcfg, x, lp), 0.0),
        0.0)
    ep, aux = tmoe._decoder_stack(
        tcfg, p, toks,
        lambda x, lp: tmoe._ep_moe_block(tcfg, x, lp,
                                         float(tcfg.n_experts)), 0.0)
    assert zero == 0.0 and float(aux) > 0
    np.testing.assert_allclose(ep.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-4)

