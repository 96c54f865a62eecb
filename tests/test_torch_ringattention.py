"""The port's ring attention (``grove_tpu_torch/ops/ringattention.py``)
over gloo worlds of 8 ranks (tests/torch_parallel_worlds.py runs them)
against the JAX package's ``ring_attention`` on its virtual CPU mesh of the
same (dp, sp, tp) plan and against the port's dense ``causal_attention``,
on the same numpy q, k, v (JAX's own test's shapes): the output blocks,
gathered, at rtol = atol = 2e-5 (tests/test_ringattention.py:30) and the
gradients of sum(out ** 2) with respect to q, k and v at 1e-4 (:73).
Also: the hops each call makes, and the ring of one (a local copy, no
collective)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worlds as worlds
from grove_tpu.ops.ringattention import ring_attention as jring
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu_torch.ops import ringattention as tring
from grove_tpu_torch.ops.attention import causal_attention
from grove_tpu_torch.parallel.mesh import AxisComm

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

PLANS = worlds.RING_PLANS[8]
DIMS = ("dp", "sp", "tp", None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.shared_run(tmp_path_factory)


@pytest.fixture(scope="module")
def qkv():
    return worlds.np_qkv(worlds.RING_SHAPE, 0)


def _gathered(runs, plan, key):
    return worlds.gather([arrays[f"ring/{plan}/{key}"]
                          for arrays, _ in runs[8]], plan, DIMS)


def _jax_mesh(plan, devices):
    dp, sp, tp = plan
    return jbuild_mesh(JMeshPlan(dp=dp, sp=sp, tp=tp), devices[:8])


@pytest.mark.parametrize("plan", PLANS)
def test_ring_matches_jax_and_dense(runs, qkv, cpu_devices, plan):
    mesh = _jax_mesh(plan, cpu_devices)
    want = np.asarray(jax.jit(lambda q, k, v: jring(mesh, q, k, v))(*qkv))
    got = _gathered(runs, plan, "out")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dense = causal_attention(*(torch.from_numpy(a) for a in qkv)).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("plan", PLANS)
def test_ring_gradients_match_jax(runs, qkv, cpu_devices, plan):
    """Each rank backs its own blocks' part of sum(out ** 2); the K/V
    cotangents come back around the ring through the hop's backward."""
    mesh = _jax_mesh(plan, cpu_devices)
    grads = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(jring(mesh, q, k, v) ** 2),
        argnums=(0, 1, 2)))(*qkv)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_gathered(runs, plan, name),
                                   np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("plan", PLANS)
def test_hops_per_call(runs, plan):
    """n hops forward, as JAX's loop makes (a block in the causal future
    skips its products, not its hop), and n - 1 backward (the last hop's
    result is unused on every rank), on every rank."""
    n = plan[1]
    assert {info[f"ring/{plan}/sp_launches"] for _, info in runs[8]} == \
        {2 * n - 1}


def test_ring_of_one_is_a_local_copy_and_matches_dense(qkv):
    """At sp = 1 the hop is a local copy (gloo refuses a send to its own
    rank; the hop of a ring of one is the identity): no collective runs,
    and the one step is the whole causal attention."""
    comm = AxisComm(group=None, size=1, rank=0)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    out = tring._ring_attention_local(q, k, v, comm)
    hop = comm.shift(k)
    assert comm.launches == 0
    assert torch.equal(hop, k) and hop.data_ptr() != k.data_ptr()
    np.testing.assert_allclose(out.numpy(), causal_attention(q, k, v).numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        out.numpy(), tring._ring_attention_local(q, k, v, None).numpy())


def test_block_attention_matches_jax(qkv):
    """``_block_attention`` on an offset block, one row fully masked: the
    max, exp-sum and weighted values of JAX's, the masked row zero."""
    from grove_tpu.ops import ringattention as jra
    q, k, v = (a[:, :8] for a in qkv)
    scale = q.shape[-1] ** -0.5
    want = jra._block_attention(*(jnp.asarray(a) for a in (q, k, v)), 8, 9,
                                scale)
    got = tring._block_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 8, 9, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    assert (got[1][..., 0] == 0).all() and (got[2][..., 0, :] == 0).all()
