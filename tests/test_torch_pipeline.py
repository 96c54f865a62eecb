"""The port's GPipe pipeline (``grove_tpu_torch/parallel/pipeline.py``)
over gloo worlds (tests/torch_parallel_worlds.py: pp = 2 in a world of 2,
pp = 4 and pp x tp = 2 x 2 in worlds of 4) against the JAX package's
``pipeline_forward`` on its virtual CPU mesh of the same plan, on the same
numpy weights (test-tiny in f32 at 4 layers, JAX's own test's config) and
tokens: the logits (every stage's, the vocab slices put together by tp
coordinate) at rtol = atol = 2e-4 and each rank's gradient slice of the
next-token loss at 5e-4 (tests/test_pipeline.py:33, :53)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worlds as worlds
from grove_tpu.models import llama as jllama
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu.parallel.pipeline import pipeline_forward as jpipeline
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.parallel import pipeline as tpipeline
from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            n_layers=4)
CASES = sorted(worlds.PIPE_CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.shared_run(tmp_path_factory)


@pytest.fixture(scope="module")
def inputs():
    _, tree = worlds.llama_inputs(n_layers=4)
    return tree, worlds.np_tokens(worlds.PIPE_TOKENS, J_CFG.vocab_size, 1)


@pytest.fixture(scope="module")
def jax_case(inputs, cpu_devices):
    """Per case: JAX's logits and the gradient of the next-token loss."""
    tree, tokens = inputs
    params = jax.tree.map(jnp.asarray, tree)
    toks = jnp.asarray(tokens)
    out = {}
    for name, (w, pp, tp, micro) in worlds.PIPE_CASES.items():
        mesh = jbuild_mesh(JMeshPlan(pp=pp, tp=tp), cpu_devices[:w])

        def loss(p, m=mesh, n=micro):
            logits = jpipeline(J_CFG, p, toks, m, n_microbatches=n)
            return jllama.next_token_loss(logits, toks), logits

        (value, logits), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        out[name] = dict(loss=float(value), logits=np.asarray(logits),
                         grads=jax.tree.map(np.asarray, grads))
    return out


@pytest.mark.parametrize("name", CASES)
def test_pipeline_logits_match_jax(runs, jax_case, name):
    w, _, tp, _ = worlds.PIPE_CASES[name]
    want = jax_case[name]["logits"]
    cols = want.shape[-1] // tp
    for arrays, info in runs[w]:
        c = info[f"pipe/{name}/coords"]["tp"]
        np.testing.assert_allclose(arrays[f"pipe/{name}/logits"],
                                   want[..., c * cols:(c + 1) * cols],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", CASES)
def test_pipeline_loss_matches_jax_on_every_stage(runs, jax_case, name):
    w = worlds.PIPE_CASES[name][0]
    want = jax_case[name]["loss"]
    for arrays, _ in runs[w]:
        assert abs(float(arrays[f"pipe/{name}/loss"]) - want) <= 1e-5 * want


@pytest.mark.parametrize("name", CASES)
def test_pipeline_gradient_slices_match_jax(runs, jax_case, name):
    """Each rank's gradient of its ``stage_params`` slices, through the
    stages' hops and (pp x tp) the tp sums: the slice of JAX's global
    gradient, 5e-4. The embedding, used by stage 0 alone, is whole on every
    stage."""
    w, pp, tp, _ = worlds.PIPE_CASES[name]
    grads = params_from_numpy(jax_case[name]["grads"], device="cpu")
    for rank, (arrays, _) in enumerate(runs[w]):
        want = worlds._flat(tpipeline.stage_params(
            Mesh(MeshPlan(pp=pp, tp=tp), rank), grads))
        for path, g in want.items():
            np.testing.assert_allclose(arrays[f"pipe/{name}/grad/{path}"],
                                       g.numpy(), rtol=5e-4, atol=5e-4,
                                       err_msg=f"rank {rank} {path}")


def test_stage_params_are_jax_in_specs():
    """``stage_params`` cuts as JAX's in_specs: the stage's layers, heads /
    kv heads / ff over tp, the head by vocab over tp, the embedding and
    the final norm whole."""
    cfg, tree = worlds.llama_inputs(n_layers=4)
    p = params_from_numpy(tree, device="cpu")
    s = tpipeline.stage_params(Mesh(MeshPlan(pp=2, tp=2), 3), p)
    layers = p["layers"]
    assert torch.equal(s["tok_embed"], p["tok_embed"])
    assert torch.equal(s["final_norm"], p["final_norm"])
    assert torch.equal(s["lm_head"], p["lm_head"][:, 128:])
    assert torch.equal(s["layers"]["wq"], layers["wq"][2:, :, 4:])
    assert torch.equal(s["layers"]["wk"], layers["wk"][2:, :, 2:])
    assert torch.equal(s["layers"]["wo"], layers["wo"][2:, 4:])
    assert torch.equal(s["layers"]["w_down"], layers["w_down"][2:, 64:])
    assert torch.equal(s["layers"]["mlp_norm"], layers["mlp_norm"][2:])


def test_pipeline_asserts_as_jax():
    """JAX's divisibility asserts; and full params where a stage's slices
    belong raise rather than run."""
    cfg, tree = worlds.llama_inputs(n_layers=4)
    p = params_from_numpy(tree, device="cpu")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(AssertionError, match="not divisible into 3 stages"):
        tpipeline.pipeline_forward(cfg, p, toks, Mesh(MeshPlan(pp=3)))
    with pytest.raises(AssertionError, match="microbatches"):
        tpipeline.pipeline_forward(cfg, p, toks, Mesh(MeshPlan(pp=2)),
                                   n_microbatches=3)
    with pytest.raises(AssertionError, match="not divisible by tp=3"):
        tpipeline.pipeline_forward(cfg, p, toks, Mesh(MeshPlan(pp=2, tp=3)))
    with pytest.raises(ValueError, match="stage_params"):
        tpipeline.pipeline_forward(cfg, p, toks, Mesh(MeshPlan(pp=2)))


def test_one_stage_is_the_plain_forward():
    """pp = 1 without a group: the schedule's M ticks run every layer on
    each microbatch; the logits are the plain forward's."""
    cfg, tree = worlds.llama_inputs(n_layers=4)
    p = params_from_numpy(tree, device="cpu")
    toks = torch.from_numpy(worlds.np_tokens((4, 8), cfg.vocab_size, 5))
    got = tpipeline.pipeline_forward(cfg, p, toks, Mesh(MeshPlan()),
                                     n_microbatches=2)
    np.testing.assert_allclose(got.numpy(),
                               tllama.forward(cfg, p, toks).numpy(),
                               rtol=1e-5, atol=1e-5)
