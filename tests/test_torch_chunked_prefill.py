"""The port's chunked prefill (``llama.prefill_chunk``/``prefill_chunked``
and ``PrefillWorker(prefill_chunk=...)``) against the JAX package's on the
same weights and tokens.

f32 on a small config is held to rtol = atol = 1e-4, as the one-shot
prefill is (tests/test_torch_llama.py). With GROVE_FLASH_ATTENTION=1 and
c = 128, window 0 runs the flash path: the Pallas kernel in interpret mode
on the JAX side, the kernel's plain version on the port's (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.ops.kvcache import KVCache as JKVCache
from grove_tpu.serving import engine as jengine
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops.flash import flash_causal_attention
from grove_tpu_torch.ops.kvcache import KVCache as TKVCache
from grove_tpu_torch.serving import engine as tengine

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=256)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=256)
TOL = dict(rtol=1e-4, atol=1e-4)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _caches(b: int, max_len: int):
    jc = JKVCache.create(J_CFG.n_layers, b, max_len, J_CFG.n_kv_heads,
                         J_CFG.head_dim, J_CFG.dtype)
    tc = TKVCache.create(T_CFG.n_layers, b, max_len, T_CFG.n_kv_heads,
                         T_CFG.head_dim, T_CFG.dtype, "cpu")
    return jc, tc


def _tokens(seed: int, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, J_CFG.vocab_size, (b, s)).astype(np.int32)


# (GROVE_FLASH_ATTENTION, chunk, padded prompt length, ragged lengths):
# two windows of 128 with window 0 on the flash path; four windows of 8
# with a lane whose last token sits in each of windows 0, 1 and 3.
CASES = {"flash_c128": ("1", 128, 256, (256, 130, 77)),
         "plain_c8": ("0", 8, 32, (32, 13, 5))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_chunked_matches_jax_f32(params, case, monkeypatch):
    flash, chunk, s, lens = CASES[case]
    monkeypatch.setenv("GROVE_FLASH_ATTENTION", flash)
    jp, tp = params
    tokens = _tokens(1, len(lens), s)
    lengths = np.array(lens, np.int32)
    jc, tc = _caches(len(lens), s)
    jl, jc = jllama.prefill_chunked(J_CFG, jp, jnp.asarray(tokens), jc,
                                    chunk=chunk,
                                    lengths=jnp.asarray(lengths))
    before = flash_causal_attention.launches
    tl, tc2 = tllama.prefill_chunked(T_CFG, tp, torch.from_numpy(tokens),
                                     tc, chunk=chunk,
                                     lengths=torch.from_numpy(lengths))
    assert flash_causal_attention.launches == before  # CPU: no kernel
    assert tc2 is tc  # written in place
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    np.testing.assert_allclose(_f32(tc.k), _f32(jc.k), **TOL)
    np.testing.assert_allclose(_f32(tc.v), _f32(jc.v), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), lengths)


def test_prefill_chunk_window_matches_jax_f32(params):
    """One window at a nonzero offset: rows after the final norm, the cache
    rows it writes, and the lengths it sets."""
    jp, tp = params
    tokens = _tokens(2, 2, 24)
    jc, tc = _caches(2, 32)
    for off in (0, 8):
        jx, jc = jllama.prefill_chunk(J_CFG, jp,
                                      jnp.asarray(tokens[:, off:off + 8]),
                                      jc, off)
        tx, tc = tllama.prefill_chunk(T_CFG, tp,
                                      torch.from_numpy(tokens[:, off:off + 8]),
                                      tc, off)
        np.testing.assert_allclose(_f32(tx), _f32(jx), **TOL)
        np.testing.assert_allclose(_f32(tc.k), _f32(jc.k), **TOL)
        np.testing.assert_allclose(_f32(tc.v), _f32(jc.v), **TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(), [off + 8] * 2)


def test_prefill_chunked_matches_one_shot_and_decodes_alike(params):
    """The port's chunked prefill against its one-shot prefill: logits and
    cache rows within the f32 tolerance, and the same greedy next tokens
    from either cache."""
    _, tp = params
    tokens = torch.from_numpy(_tokens(3, 2, 32))
    _, one = _caches(2, 64)
    _, chunked = _caches(2, 64)
    lo, one = tllama.prefill(T_CFG, tp, tokens, one)
    lc, chunked = tllama.prefill_chunked(T_CFG, tp, tokens, chunked, chunk=8)
    np.testing.assert_allclose(_f32(lc), _f32(lo), **TOL)
    np.testing.assert_allclose(_f32(chunked.k), _f32(one.k), **TOL)
    nxt = torch.argmax(lo, -1).to(torch.int32)
    assert torch.equal(nxt, torch.argmax(lc, -1).to(torch.int32))
    do, _ = tllama.decode_step(T_CFG, tp, nxt, one)
    dc, _ = tllama.decode_step(T_CFG, tp, nxt, chunked)
    assert torch.equal(torch.argmax(do, -1), torch.argmax(dc, -1))


def test_prefill_chunked_rejects_ragged_windows(params):
    _, tp = params
    _, tc = _caches(1, 64)
    with pytest.raises(ValueError, match="chunks of 8"):
        tllama.prefill_chunked(T_CFG, tp,
                               torch.zeros((1, 12), dtype=torch.int32), tc,
                               chunk=8)


def test_chunked_prefill_worker_matches_jax(params):
    """PrefillWorker(prefill_chunk=8) against the JAX package's: next tokens
    and each result's KV slab and length, on ragged prompts."""
    jp, tp = params
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, J_CFG.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 32)]
    jw = jengine.PrefillWorker(J_CFG, jp, batch=3, max_prompt=32,
                               prefill_chunk=8)
    tw = tengine.PrefillWorker(T_CFG, tp, batch=3, max_prompt=32,
                               prefill_chunk=8, device="cpu")
    jr, tr = jw.prefill(prompts), tw.prefill(prompts)
    assert [r.next_token for r in tr] == [r.next_token for r in jr]
    assert [r.length for r in tr] == [len(p) for p in prompts]
    for j, t in zip(jr, tr):
        n = t.length
        np.testing.assert_allclose(_f32(t.k[:, :n]), _f32(j.k[:, :n]), **TOL)
        np.testing.assert_allclose(_f32(t.v[:, :n]), _f32(j.v[:, :n]), **TOL)
    with pytest.raises(ValueError, match="chunks of 12"):
        tengine.PrefillWorker(T_CFG, tp, max_prompt=32, prefill_chunk=12,
                              device="cpu")


def test_lanes_engine_fed_by_chunked_worker_matches_jax(params):
    """submit + admit_from_queue(chunked PrefillWorker), more requests than
    lanes: every request answers, with the JAX pair's tokens by rid."""
    jp, tp = params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, J_CFG.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 14, 7)]
    out = {}
    for side, eng, worker in (
            ("jax", jengine.DecodeEngine(J_CFG, jp, batch=2, max_len=48,
                                         xprof=False, reqtrace=False),
             jengine.PrefillWorker(J_CFG, jp, batch=2, max_prompt=16,
                                   prefill_chunk=8)),
            ("port", tengine.DecodeEngine(T_CFG, tp, batch=2, max_len=48,
                                          device="cpu"),
             tengine.PrefillWorker(T_CFG, tp, batch=2, max_prompt=16,
                                   prefill_chunk=8, device="cpu"))):
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        for _ in range(100):
            eng.admit_from_queue(worker)
            if len(eng.completed) == len(prompts):
                break
            eng.step()
        assert sorted(r.rid for r in eng.completed) == rids
        assert all(len(r.generated) == 6 for r in eng.completed)
        out[side] = {r.rid: list(r.generated) for r in eng.completed}
    assert out["port"] == out["jax"]
