"""The port's Ulysses attention (``grove_tpu_torch/ops/ulysses.py``) over
gloo worlds (tests/torch_parallel_worlds.py: plans (1, 4, 2) and (2, 2, 2)
in a world of 8, (1, 2, 1) in a world of 2) against the JAX package's
``ulysses_attention`` on its virtual CPU mesh of the same plan, on the same
numpy q, k, v (JAX's own test's shapes): the output blocks, gathered, at
rtol = atol = 2e-5 and the gradients of sum(out ** 2) at 2e-4
(tests/test_ulysses.py). Heads that do not divide over sp raise, and the
``sp`` argument rules raise as JAX's do (tests/test_ulysses.py:77-95)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worlds as worlds
from grove_tpu.models import llama as jllama
from grove_tpu.ops.ulysses import ulysses_attention as julysses
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops import ulysses as tulysses
from grove_tpu_torch.ops.attention import causal_attention
from grove_tpu_torch.parallel.mesh import AxisComm

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

CASES = [(w, plan) for w, plans in sorted(worlds.ULYSSES_PLANS.items())
         for plan in plans]
DIMS = ("dp", "sp", "tp", None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.shared_run(tmp_path_factory)


@pytest.fixture(scope="module")
def qkv():
    return worlds.np_qkv(worlds.ULYSSES_SHAPE, 0)


def _gathered(runs, w, plan, key):
    return worlds.gather([arrays[f"ulysses/{plan}/{key}"]
                          for arrays, _ in runs[w]], plan, DIMS)


def _jax_mesh(w, plan, devices):
    dp, sp, tp = plan
    return jbuild_mesh(JMeshPlan(dp=dp, sp=sp, tp=tp), devices[:w])


@pytest.mark.parametrize("w,plan", CASES)
def test_ulysses_matches_jax_and_dense(runs, qkv, cpu_devices, w, plan):
    mesh = _jax_mesh(w, plan, cpu_devices)
    want = np.asarray(jax.jit(lambda q, k, v: julysses(mesh, q, k, v))(*qkv))
    got = _gathered(runs, w, plan, "out")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dense = causal_attention(*(torch.from_numpy(a) for a in qkv)).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("w,plan", CASES)
def test_ulysses_gradients_match_jax(runs, qkv, cpu_devices, w, plan):
    mesh = _jax_mesh(w, plan, cpu_devices)
    grads = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(julysses(mesh, q, k, v) ** 2),
        argnums=(0, 1, 2)))(*qkv)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_gathered(runs, w, plan, name),
                                   np.asarray(want), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("w,plan", CASES)
def test_two_exchanges_each_way(runs, w, plan):
    """q, k and v travel in one exchange and the output in one: 2 forward,
    2 backward, on every rank (JAX's body makes four forward)."""
    assert {info[f"ulysses/{plan}/sp_launches"] for _, info in runs[w]} == \
        {4}


def test_ulysses_rejects_undividable_heads(cpu_devices):
    """kv heads not divisible by sp refuse loudly, before any collective,
    with JAX's message (ring attention has no such constraint)."""
    q = np.zeros((1, 16, 8, 8), np.float32)
    k = v = np.zeros((1, 16, 2, 8), np.float32)    # 2 kv heads, sp = 4
    mesh = jbuild_mesh(JMeshPlan(sp=4), cpu_devices[:4])
    with pytest.raises(Exception, match="divisible by sp") as jerr:
        jax.jit(lambda q, k, v: julysses(mesh, q, k, v))(q, k, v)
    comm = AxisComm(group=None, size=4, rank=0)
    with pytest.raises(AssertionError, match="divisible by sp") as terr:
        tulysses._ulysses_local(*(torch.from_numpy(a) for a in (q, k, v)),
                                comm)
    assert comm.launches == 0
    assert str(terr.value) in str(jerr.value)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=object(), sp="megatron"), ValueError, "unknown sp strategy"),
    (dict(mesh=object(), ring=True, sp="ulysses"), AssertionError,
     "conflicts"),
    (dict(sp="ring"), AssertionError, "needs the mesh"),
    (dict(ring=True), AssertionError, "needs the mesh"),
    (dict(mesh=object(), sp="ulysses", positions=True), AssertionError,
     "custom positions"),
])
def test_sp_argument_rules_raise_as_jax(kw, exc, match):
    tcfg, tree = worlds.llama_inputs()
    jc = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("positions"):
        jkw["positions"] = jnp.zeros((1, 8), jnp.int32)
        tkw["positions"] = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(exc, match=match):
        jllama.forward(jc, jp, jnp.zeros((1, 8), jnp.int32), **jkw)
    with pytest.raises(exc, match=match):
        tllama.forward(tcfg, tp, torch.zeros((1, 8), dtype=torch.int32),
                       **tkw)
