"""The port's sharded training against the JAX package's: ``loss_fn(mesh=)``
over gloo worlds (tests/torch_parallel_worlds.py runs the ranks) against
``jax.value_and_grad(llama.loss_fn(..., mesh=m))`` on JAX's virtual CPU
mesh of the same plan, on the same numpy weights and tokens; one AdamW
step against optax; the ``dryrun_multichip`` twin at n = 2, 4 and 8.

Cases, test-tiny in f32: (dp=2, sp=2, tp=2) with the ring, the same with
Ulysses, and tp = 4 alone. Tolerances: the loss within 1e-5 relative;
each rank's gradient slice within 1e-4 of its leaf's max norm of the slice
of JAX's global gradient (``jax.device_get``), and the slices, gathered,
the same; ``forward(mesh=)``'s logits blocks within 1e-4 (JAX's own tests'
bound for the sharded forward); the params after one AdamW step as
tests/test_torch_train.py holds three train steps (1e-4, and the elements
whose gradient is rounding noise around zero held to 2 lr)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_worlds as worlds
from grove_tpu.models import llama as jllama
from grove_tpu.parallel import shard_params as jshard_params
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
from grove_tpu_torch.parallel.sharding import param_pspec, shard_params

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32)
CASES = sorted(worlds.TRAIN_CASES)
DISAGG = " disagg prefill-mesh=tp4 decode-mesh=tp4 tokens-match"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.shared_run(tmp_path_factory)


@pytest.fixture(scope="module")
def inputs():
    cfg, tree = worlds.llama_inputs()
    assert worlds.config_fields(cfg) == {
        f.name: getattr(J_CFG, f.name)
        for f in dataclasses.fields(J_CFG) if f.name != "dtype"}
    return tree, worlds.np_tokens(worlds.TRAIN_TOKENS, cfg.vocab_size, 1)


@pytest.fixture(scope="module")
def jax_case(inputs, cpu_devices):
    """Per case: JAX's loss, global gradient, logits and the params after
    one optax AdamW step, on that case's mesh."""
    tree, tokens = inputs
    out = {}
    for name, (w, (dp, sp, tp), strategy) in worlds.TRAIN_CASES.items():
        mesh = jbuild_mesh(JMeshPlan(dp=dp, sp=sp, tp=tp), cpu_devices[:w])
        params = jshard_params(mesh, jax.tree.map(jnp.asarray, tree))
        toks = jax.device_put(jnp.asarray(tokens),
                              NamedSharding(mesh, P("dp", "sp")))

        def loss(p, m=mesh, s=strategy, t=toks):
            return jllama.loss_fn(J_CFG, p, t, mesh=m, sp=s)

        value, grads = jax.jit(jax.value_and_grad(loss))(params)
        logits = jax.jit(lambda p, m=mesh, s=strategy, t=toks:
                         jllama.forward(J_CFG, p, t, mesh=m, sp=s))(params)
        tx = optax.adamw(1e-3)
        updates, _ = tx.update(grads, tx.init(params), params)
        out[name] = dict(loss=float(value),
                         grads=jax.tree.map(np.asarray, jax.device_get(grads)),
                         logits=np.asarray(logits),
                         stepped=jax.tree.map(np.asarray, jax.device_get(
                             optax.apply_updates(params, updates))))
    return out


def _plan(name):
    w, (dp, sp, tp), _ = worlds.TRAIN_CASES[name]
    return w, MeshPlan(dp=dp, sp=sp, tp=tp)


def _slices(plan, rank, tree) -> dict:
    """The rank's slices of a global numpy tree, as ``shard_params`` cuts
    them, flattened by path."""
    return worlds._flat(shard_params(Mesh(plan, rank),
                                     params_from_numpy(tree, device="cpu")))


@pytest.mark.parametrize("name", CASES)
def test_loss_matches_jax_on_every_rank(runs, jax_case, name):
    w, _ = _plan(name)
    want = jax_case[name]["loss"]
    for arrays, _ in runs[w]:
        got = float(arrays[f"train/{name}/loss"])
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("name", CASES)
def test_gradient_slices_match_jax(runs, jax_case, name):
    """Each rank's ``.grad`` after ``backward()`` is its slice of JAX's
    global gradient, within 1e-4 of the slice's max norm."""
    w, plan = _plan(name)
    for rank, (arrays, _) in enumerate(runs[w]):
        for path, want in _slices(plan, rank,
                                  jax_case[name]["grads"]).items():
            got = arrays[f"train/{name}/grad/{path}"]
            want = want.numpy()
            assert got.shape == want.shape, (rank, path)
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (rank, path, err)


@pytest.mark.parametrize("name", CASES)
def test_gathered_gradient_is_jax_global_gradient(runs, jax_case, name):
    """The slices put back together by their tp coordinates (the only axis
    a llama leaf is cut over; dp and sp ranks hold whole copies, which
    agree bitwise) are JAX's gradient, within 1e-4 of each leaf's max
    norm."""
    w, plan = _plan(name)
    want = worlds._flat(jax_case[name]["grads"])
    for path, g in want.items():
        spec = param_pspec(path.split("/")[-1])
        dims = tuple("tp" if e == "tp" else None for e in spec)
        full = worlds.gather(
            [arrays[f"train/{name}/grad/{path}"] for arrays, _ in runs[w]],
            (plan.dp, plan.sp, plan.tp), dims)
        err = np.abs(full - g).max() / max(np.abs(g).max(), 1e-30)
        assert err <= 1e-4, (path, err)


@pytest.mark.parametrize("name", CASES)
def test_forward_blocks_match_jax_logits(runs, jax_case, name):
    """``forward(mesh=)`` returns the rank's block [B/dp, S/sp, V/tp]."""
    w, plan = _plan(name)
    sp_cut = worlds.TRAIN_CASES[name][2] is not None
    full = worlds.gather(
        [arrays[f"train/{name}/logits"] for arrays, _ in runs[w]],
        (plan.dp, plan.sp, plan.tp),
        ("dp", "sp" if sp_cut else None, "tp"))
    np.testing.assert_allclose(full, jax_case[name]["logits"], rtol=1e-4,
                               atol=1e-4)


def test_one_adamw_step_matches_optax(runs, jax_case):
    """``train.train_step`` under the (2, 2, 2) ring mesh: each rank's
    updated slices against optax's step of the global params, sliced."""
    name = "ring_222"
    w, plan = _plan(name)
    for rank, (arrays, _) in enumerate(runs[w]):
        grads = _slices(plan, rank, jax_case[name]["grads"])
        for path, want in _slices(plan, rank,
                                  jax_case[name]["stepped"]).items():
            got = arrays[f"train/{name}/adamw/{path}"]
            jg = np.abs(grads[path].numpy())
            tg = np.abs(arrays[f"train/{name}/grad/{path}"])
            noise = ((jg <= 1e-7 * jg.max()) & (tg <= 1e-7 * jg.max())
                     & ((jg > 0) | (tg > 0)))
            err = np.abs(got - want.numpy())
            assert err[~noise].max(initial=0) <= 1e-4, (rank, path)
            assert err[noise].max(initial=0) <= 2e-3, (rank, path)
            assert noise.sum() <= max(1, noise.size // 1000), (rank, path)


def test_collectives_per_step(runs):
    """One train step's collectives by axis, from ``AxisComm.launches``, the
    same on every rank. tp (every case): the embedding's sum, per layer the
    two partial sums forward and the two ``copy_to`` sums backward, the
    cross-entropy's three (max, exp-sum, target logit) and the head's
    ``copy_to`` backward: 1 + 4 L + 3 + 1. dp: the loss's sum and one per
    gradient leaf (12). sp: the same 13, and per layer the ring's n = 2
    hops forward and n - 1 backward, or Ulysses' two exchanges each way."""
    counts = {name: runs[worlds.TRAIN_CASES[name][0]][0][1][
        f"train/{name}/launches"] for name in CASES}
    for name in CASES:
        w = worlds.TRAIN_CASES[name][0]
        assert all(info[f"train/{name}/launches"] == counts[name]
                   for _, info in runs[w])
    layers = J_CFG.n_layers
    assert {c["tp"] for c in counts.values()} == {1 + 4 * layers + 3 + 1}
    assert counts["ring_222"]["dp"] == counts["ulysses_222"]["dp"] == 13
    assert counts["ring_222"]["sp"] == 13 + 3 * layers
    assert counts["ulysses_222"]["sp"] == 13 + 4 * layers


def _collective_want(name: str, n: int, r: int):
    """(y, grad) of rank r's ``scenario_collectives`` case, from the
    definitions: x_q is rank q's input, w the element index of y, and
    rank q's loss (y_q * w * c(q)).sum()."""
    x = [worlds.collective_input(n, q) for q in range(n)]
    c = worlds.COLLECTIVE_WEIGHT[name]
    w = np.arange(n * 3, dtype=np.float64).reshape(n, 3)
    if name == "copy_to":
        return x[r], w * sum(c(q) for q in range(n))
    if name == "reduce_from":
        return sum(x), w * c(r)
    if name == "all_to_all":
        # chunk i of rank r's result is chunk r of rank i's input, so
        # chunk q of x_r lands in rank q's result at chunk r
        return (np.stack([x[i][r] for i in range(n)]),
                np.stack([w[r] * c(q) for q in range(n)]))
    if name == "shift":
        return x[(r - 1) % n], w * c((r + 1) % n)
    if name == "shift_back":
        return x[(r + 1) % n], w * c((r - 1) % n)
    assert name == "all_gather"
    wg = np.arange(n * n * 3, dtype=np.float64).reshape(n * n, 3)
    return np.concatenate(x), wg[r * n:(r + 1) * n] * c(r)


@pytest.mark.parametrize("n", worlds.WORLDS)
@pytest.mark.parametrize("name", sorted(worlds.COLLECTIVE_WEIGHT))
def test_differentiable_collectives(runs, name, n):
    """Each collective's forward and gradient on every rank of worlds of
    2, 4 and 8, exactly (small integers in f32) as the definitions give
    them: ``copy_to``'s backward sums the ranks' cotangents,
    ``reduce_from``'s passes the rank's own, ``all_to_all``'s is the
    inverse exchange, ``shift``'s hops back, and ``all_gather``'s (every
    rank computing the same function) takes the rank's slice."""
    for r, (_, info) in enumerate(runs[n]):
        got = info["collectives"][name]
        want_y, want_g = _collective_want(name, n, r)
        np.testing.assert_array_equal(np.asarray(got["y"]), want_y,
                                      err_msg=f"{name} y, rank {r}")
        np.testing.assert_array_equal(np.asarray(got["grad"]), want_g,
                                      err_msg=f"{name} grad, rank {r}")


@pytest.mark.parametrize("n,fields", [
    (2, ("plan=(dp=1, sp=1, tp=2) ring=False", "composed pp=2xtp=1",
         "moe dp=1xep=2")),
    (4, ("plan=(dp=2, sp=1, tp=2) ring=False", "composed pp=2xtp=2",
         "moe dp=2xep=2")),
    (8, ("plan=(dp=2, sp=2, tp=2) ring=True", "ulysses dp=2xsp=2xtp=2",
         "composed pp=2xtp=2", "moe dp=2xep=4", DISAGG)),
])
def test_dryrun_multichip_twin_prints_the_ok_line(runs, n, fields):
    """The twin of tests/test_graft_entry.py's dry-run checks: rank 0
    prints JAX's line with the same fields and finite losses (each section
    asserts a finite loss and finite gradients), ending at n = 8 with the
    disaggregated serving section's suffix (two tp = 4 groups, tokens
    bitwise those of one group), which n = 2 and 4 do not run; the other
    ranks print nothing."""
    out = [info["dryrun/stdout"] for _, info in runs[n]]
    assert out[0].startswith(f"dryrun_multichip ok: n={n} "), out[0]
    assert all(f in out[0] for f in fields), out[0]
    assert out[0].rstrip().endswith(DISAGG) == (n >= 8), out[0]
    assert "nan" not in out[0] and "inf" not in out[0]
    assert not any(out[1:])
