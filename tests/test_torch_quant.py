"""The port's int8 weight quantization against the JAX package's, bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.serving import quant as jquant
from grove_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import quant as tquant

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("shape,axes,dtype", [
    ((4, 32, 8, 16), (1,), jnp.bfloat16),      # wq-like
    ((4, 8, 16, 32), (1, 2), jnp.bfloat16),    # wo-like
    ((64, 300), (0,), jnp.bfloat16),           # lm_head-like
    ((300, 64), (1,), jnp.float32),            # tok_embed-like, f32
])
def test_quantize_tensor_bitwise(shape, axes, dtype):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.3,
                    dtype)
    w = w.at[0].set(0.0)  # an all-zero channel exercises the 1e-8 floor
    jq = jquant.quantize_tensor(w, axes)
    tq = tquant.quantize_tensor(tensor_from_numpy(np.asarray(w)), axes)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(_bits(tq.scale), _jbits(jq.scale))
    np.testing.assert_array_equal(_bits(tq.materialize()),
                                  _jbits(jq.materialize()))


def _tiny():
    return dataclasses.replace(jllama.CONFIGS["test-tiny"])


def test_quantize_params_and_sizes_match_jax():
    cfg = _tiny()
    jp = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jq = jquant.quantize_params(jp)
    tq = tquant.quantize_params(tp)
    for name in ("tok_embed", "lm_head"):
        np.testing.assert_array_equal(tq[name].q.numpy(),
                                      np.asarray(jq[name].q))
    for name, w in tq["layers"].items():
        if name in tquant._CONTRACT_AXES:
            np.testing.assert_array_equal(w.q.numpy(),
                                          np.asarray(jq["layers"][name].q))
            np.testing.assert_array_equal(
                _bits(w.scale), _jbits(jq["layers"][name].scale))
        else:
            assert isinstance(w, torch.Tensor)  # norms pass through
    assert tquant.params_bytes(tq) == jquant.params_bytes(jq)
    assert tquant.params_bytes(tp) == jquant.params_bytes(jp)


@pytest.mark.parametrize("name", ["test-tiny", "llama-1b", "llama-70b"])
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_kv_bytes_per_token_per_layer_equal(name, kv_quant):
    assert (tquant.kv_bytes_per_token_per_layer(tllama.CONFIGS[name],
                                                kv_quant)
            == jquant.kv_bytes_per_token_per_layer(jllama.CONFIGS[name],
                                                   kv_quant))


@pytest.mark.parametrize("name", ["test-tiny", "llama-1b", "llama-8b"])
def test_config_params_bytes_equal(name):
    assert (tllama.CONFIGS[name].params_bytes
            == jllama.CONFIGS[name].params_bytes)
