"""The port's Llama prefill and decode against the JAX package's on the same
weights (converted key for key) and the same tokens.

f32 on a small config is held to rtol = atol = 1e-4 (the frameworks order
their matmul sums differently); bf16 to the model-level bound
max |diff| <= 5e-2 * max |logit|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.ops.kvcache import KVCache as JKVCache
from grove_tpu.serving import quant as jquant
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops.flash import flash_causal_attention
from grove_tpu_torch.ops.kvcache import KVCache as TKVCache
from grove_tpu_torch.serving.quant import QTensor

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=256)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=256)
B, S, STEPS = 2, 128, 4


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _both_params(jcfg, quant=False):
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if quant:
        jp = jquant.quantize_params(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _run_both(jcfg, tcfg, jp, tp, tokens, steps):
    """Prefill then ``steps`` greedy decode steps on both sides; returns
    (jax logits list, port logits list, jax cache, port cache)."""
    b, s = tokens.shape
    jc = JKVCache.create(jcfg.n_layers, b, jcfg.max_seq_len, jcfg.n_kv_heads,
                         jcfg.head_dim, jcfg.dtype)
    tc = TKVCache.create(tcfg.n_layers, b, tcfg.max_seq_len, tcfg.n_kv_heads,
                         tcfg.head_dim, tcfg.dtype, "cpu")
    jl, jc = jllama.prefill(jcfg, jp, jnp.asarray(tokens), jc)
    tl, tc = tllama.prefill(tcfg, tp, torch.from_numpy(tokens), tc)
    j_out, t_out = [jl], [tl]
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.from_numpy(np.array(jtok))  # same tokens into both
    for _ in range(steps):
        jl, jc = jllama.decode_step(jcfg, jp, jtok, jc)
        tl, tc = tllama.decode_step(tcfg, tp, ttok, tc)
        j_out.append(jl)
        t_out.append(tl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.from_numpy(np.array(jtok))
    return j_out, t_out, jc, tc


def _tokens(seed=1, b=B, s=S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_params_from_numpy_bitwise_bf16_and_qtensor():
    cfg = jllama.CONFIGS["test-tiny"]  # bf16
    jp = jquant.quantize_params(jllama.init_params(cfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["final_norm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["final_norm"].view(torch.int16).numpy(),
                                  np.asarray(jp["final_norm"]).view(np.int16))
    for name in ("wq", "w_down"):
        jq, tq = jp["layers"][name], tp["layers"][name]
        assert isinstance(tq, QTensor)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.scale.view(torch.int16).numpy(),
                                      np.asarray(jq.scale).view(np.int16))
    assert tp["layers"]["attn_norm"].shape == jp["layers"]["attn_norm"].shape


@pytest.mark.parametrize("flash", ["1", "0"])
def test_prefill_and_decode_match_jax_f32(flash, monkeypatch):
    """With GROVE_FLASH_ATTENTION=1 JAX runs the Pallas kernel in
    interpret mode and the port its plain flash; with 0 both run the plain
    formulation."""
    monkeypatch.setenv("GROVE_FLASH_ATTENTION", flash)
    jp, tp = _both_params(J_CFG)
    before = flash_causal_attention.launches
    j_out, t_out, jc, tc = _run_both(J_CFG, T_CFG, jp, tp, _tokens(), STEPS)
    assert flash_causal_attention.launches == before  # CPU: no kernel
    for jl, tl in zip(j_out, t_out):
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(tc.k), _f32(jc.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(tc.v), _f32(jc.v), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_prefill_ragged_lengths_match_jax_f32():
    jp, tp = _both_params(J_CFG)
    tokens = _tokens(seed=2, b=3, s=16)
    lengths = np.array([16, 5, 9], np.int32)
    jc = JKVCache.create(J_CFG.n_layers, 3, 32, J_CFG.n_kv_heads,
                         J_CFG.head_dim, J_CFG.dtype)
    tc = TKVCache.create(T_CFG.n_layers, 3, 32, T_CFG.n_kv_heads,
                         T_CFG.head_dim, T_CFG.dtype, "cpu")
    jl, jc = jllama.prefill(J_CFG, jp, jnp.asarray(tokens), jc,
                            jnp.asarray(lengths))
    tl, tc = tllama.prefill(T_CFG, tp, torch.from_numpy(tokens), tc,
                            torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tc.lengths.numpy(), lengths)


def _model_bound(jl, tl):
    j, t = _f32(jl), _f32(tl)
    assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()


def test_prefill_and_decode_bf16_within_model_bound():
    jcfg = dataclasses.replace(J_CFG, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(T_CFG, dtype=torch.bfloat16)
    jp, tp = _both_params(jcfg)
    j_out, t_out, _, _ = _run_both(jcfg, tcfg, jp, tp, _tokens(seed=4, s=32),
                                   2)
    for jl, tl in zip(j_out, t_out):
        _model_bound(jl, tl)


def test_int8_params_match_jax():
    """The port's int8 path rounds each dequantized weight to bf16, as
    ``QTensor.materialize`` says. Under jit, XLA fuses that product into
    the matmul and keeps it in f32 (its default excess precision), so the
    JAX int8 run is held to the model-level bound, and the exact check is
    against JAX over the eagerly materialized (bf16-rounded) weights."""
    jp, tp = _both_params(J_CFG, quant=True)
    tokens = _tokens(seed=5, s=32)
    j_out, t_out, _, _ = _run_both(J_CFG, T_CFG, jp, tp, tokens, 2)
    for jl, tl in zip(j_out, t_out):
        _model_bound(jl, tl)
    dense = jax.tree.map(
        lambda w: w.materialize() if isinstance(w, jquant.QTensor) else w,
        jp, is_leaf=lambda w: isinstance(w, jquant.QTensor))
    j_out, t_out, _, _ = _run_both(J_CFG, T_CFG, dense, tp, tokens, 2)
    for jl, tl in zip(j_out, t_out):
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)


def test_init_params_shapes_match_jax():
    jp = jllama.init_params(jllama.CONFIGS["test-tiny"], jax.random.PRNGKey(0))
    tp = tllama.init_params(tllama.CONFIGS["test-tiny"],
                            torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
    # fan_in**-0.5 scaling: wo's fan-in is h * hd.
    cfg = tllama.CONFIGS["test-tiny"]
    std = tp["layers"]["wo"].float().std().item()
    assert abs(std - (cfg.n_heads * cfg.head_dim) ** -0.5) < 0.02


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.init_params(T_CFG, torch.Generator())
