"""The lanes model functions under tensor parallelism against the JAX
package's, and at ``tp=None`` against their composition before ``tp=``.

``llama.prefill``, ``prefill_chunked`` and ``decode_step`` with ``tp=`` run
in the gloo worlds of 2 and 4 ranks of tests/torch_parallel_worlds.py
(``scenario_lanes_tp``): the flagship config (``train.flagship_config``,
n_kv 4) in f32, a ragged batch of three prompts right-padded to 16, a
32-row cache holding each rank's n_kv / tp heads, then 8 greedy decode
steps. JAX runs the same functions on ``shard_params`` of a tp mesh of 2
and 4 of the conftest's virtual CPU devices. Tolerances: the logits of the
prefill and of every step within 1e-4, each rank's K/V heads within 1e-4
of the same heads of JAX's cache, and the greedy tokens exactly equal;
every rank's logits are the same bits (the gathered vocab)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worlds as worlds
from grove_tpu.models import llama as jllama
from grove_tpu.ops.kvcache import KVCache as JKVCache
from grove_tpu.parallel import shard_params as jshard_params
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama
from grove_tpu_torch.ops.attention import causal_attention, decode_attention
from grove_tpu_torch.ops.kvcache import KVCache, write_rows
from grove_tpu_torch.ops.rope import apply_rope

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

MODES = ("oneshot", "chunked")
TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.shared_run(tmp_path_factory)


@pytest.fixture(scope="module")
def inputs():
    return worlds.lanes_inputs()


def _jax_config(cfg):
    return jllama.LlamaConfig(**worlds.config_fields(cfg), dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_lanes(inputs, cpu_devices):
    """Per (world, mode): JAX's logits [1 + steps, b, vocab], tokens
    [steps, b] and the final cache, over a tp mesh of that world's size."""
    cfg, tree, toks = inputs
    jcfg = _jax_config(cfg)
    b = len(worlds.LANES_LENGTHS)
    lengths = jnp.asarray(worlds.LANES_LENGTHS, jnp.int32)
    out = {}
    for n in worlds.LANES_WORLDS:
        mesh = jbuild_mesh(JMeshPlan(tp=n), cpu_devices[:n])
        params = jshard_params(mesh, jax.tree.map(jnp.asarray, tree))
        for mode in MODES:
            def pf(p, t, lens, mode=mode):
                cache = JKVCache.create(jcfg.n_layers, b, worlds.LANES_CACHE,
                                        jcfg.n_kv_heads, jcfg.head_dim,
                                        jcfg.dtype)
                if mode == "oneshot":
                    return jllama.prefill(jcfg, p, t, cache, lens)
                return jllama.prefill_chunked(jcfg, p, t, cache,
                                              worlds.LANES_CHUNK, lens)

            step = jax.jit(lambda p, t, c: jllama.decode_step(jcfg, p, t, c))
            logits, cache = jax.jit(pf)(params, jnp.asarray(toks), lengths)
            all_logits, picked = [np.asarray(logits)], []
            for _ in range(worlds.LANES_STEPS):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                picked.append(np.asarray(tok))
                logits, cache = step(params, tok, cache)
                all_logits.append(np.asarray(logits))
            out[n, mode] = dict(logits=np.stack(all_logits),
                                tokens=np.stack(picked),
                                k=np.asarray(cache.k), v=np.asarray(cache.v),
                                lengths=np.asarray(cache.lengths))
    return out


def _cases():
    return [(n, m) for n in worlds.LANES_WORLDS for m in MODES]


@pytest.mark.parametrize("n,mode", _cases())
def test_greedy_tokens_match_jax_exactly(runs, jax_lanes, n, mode):
    want = jax_lanes[n, mode]["tokens"]
    for rank, (arrays, _) in enumerate(runs[n]):
        np.testing.assert_array_equal(arrays[f"lanes/{mode}/tokens"], want,
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("n,mode", _cases())
def test_logits_match_jax_and_agree_across_ranks(runs, jax_lanes, n, mode):
    """The prefill's and every step's logits within 1e-4 of JAX's, and each
    rank's the same bits as rank 0's."""
    want = jax_lanes[n, mode]["logits"]
    first = runs[n][0][0][f"lanes/{mode}/logits"]
    err = float(np.abs(first - want).max())
    assert err <= TOL, err
    for rank, (arrays, _) in enumerate(runs[n]):
        np.testing.assert_array_equal(arrays[f"lanes/{mode}/logits"], first,
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("n,mode", _cases())
def test_each_rank_holds_its_kv_heads(runs, jax_lanes, n, mode):
    """The cache after the last step: rank r's K/V are heads [r n_kv / tp,
    (r + 1) n_kv / tp) of JAX's, within 1e-4, and the lengths are JAX's."""
    want = jax_lanes[n, mode]
    for rank, (arrays, _) in enumerate(runs[n]):
        for name in ("k", "v"):
            got = arrays[f"lanes/{mode}/{name}"]
            heads = got.shape[3]
            assert heads * n == want[name].shape[3]
            ref = want[name][:, :, :, rank * heads:(rank + 1) * heads]
            err = float(np.abs(got - ref).max())
            assert err <= TOL, (rank, name, err)
        np.testing.assert_array_equal(arrays[f"lanes/{mode}/lengths"],
                                      want["lengths"])


@pytest.mark.parametrize("n,mode", _cases())
def test_collectives_per_call(runs, n, mode):
    """2 n_layers + 2 per forward (the embedding's sum, two sums per layer,
    the logits' gather): a chunked prefill runs the layers once per window
    and the head once."""
    cfg = worlds.lanes_config()
    per = 2 * cfg.n_layers + 1
    windows = worlds.LANES_TOKENS[1] // worlds.LANES_CHUNK \
        if mode == "chunked" else 1
    want = [per * windows + 1] + [per + 1] * worlds.LANES_STEPS
    for _, info in runs[n]:
        assert info[f"lanes/{mode}/collectives"] == want


# ---- tp=None: the composition the functions had before they took tp= ----

def _before_prefill(cfg, params, tokens, cache, lengths):
    """``llama.prefill`` as it was written before ``tp=``."""
    b, s = tokens.shape
    positions = torch.arange(s).expand(b, s)
    cos, sin = llama._rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                           tokens.device)

    def attend(i, q, k, v):
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        write_rows(cache.k[i], k, 0)
        write_rows(cache.v[i], v, 0)
        return causal_attention(q, k, v, q_offset=0)

    x = llama._decoder(cfg, params, llama.embed(cfg, params, tokens), attend,
                       wide=True)
    last = (lengths.to(torch.long) - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b), last]
    cache.lengths = lengths.to(torch.int32)
    return llama._logits(x_last, params["lm_head"]), cache


def _before_decode(cfg, params, tokens, cache):
    """``llama.decode_step`` as it was written before ``tp=``."""
    positions = cache.lengths[:, None]
    cos, sin = llama._rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                           tokens.device)
    new_lengths = cache.lengths + 1

    def attend(i, q, k, v):
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        kc = write_rows(cache.k[i], k, cache.lengths)
        vc = write_rows(cache.v[i], v, cache.lengths)
        return decode_attention(q, kc, vc, new_lengths)

    x = llama._decoder(cfg, params, llama.embed(cfg, params, tokens[:, None]),
                       attend)
    cache.lengths = new_lengths
    return llama._logits(x[:, 0], params["lm_head"]), cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tp_none_keeps_the_bits_it_had(inputs, dtype):
    cfg, tree, toks = inputs
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.dtype(str(dtype)[6:]))),
        tree), device="cpu")
    tokens = torch.from_numpy(toks)
    lengths = torch.tensor(worlds.LANES_LENGTHS, dtype=torch.int32)
    b = len(worlds.LANES_LENGTHS)

    def cache():
        return KVCache.create(cfg.n_layers, b, worlds.LANES_CACHE,
                              cfg.n_kv_heads, cfg.head_dim, cfg.dtype, "cpu")

    got, c1 = llama.prefill(cfg, params, tokens, cache(), lengths, tp=None)
    want, c2 = _before_prefill(cfg, params, tokens, cache(), lengths)
    assert torch.equal(got, want)
    for _ in range(worlds.LANES_STEPS):
        tok = torch.argmax(got, dim=-1).to(torch.int32)
        got, c1 = llama.decode_step(cfg, params, tok, c1, tp=None)
        want, c2 = _before_decode(cfg, params, tok, c2)
        assert torch.equal(got, want)
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)
    assert torch.equal(c1.lengths, c2.lengths)


def test_tp_none_chunked_matches_jax(inputs):
    """``prefill_chunked`` without tp against JAX's on unsharded params."""
    cfg, tree, toks = inputs
    jcfg = _jax_config(cfg)
    b = len(worlds.LANES_LENGTHS)
    jp = jax.tree.map(jnp.asarray, tree)
    jcache = JKVCache.create(jcfg.n_layers, b, worlds.LANES_CACHE,
                             jcfg.n_kv_heads, jcfg.head_dim, jcfg.dtype)
    want, _ = jllama.prefill_chunked(
        jcfg, jp, jnp.asarray(toks), jcache, worlds.LANES_CHUNK,
        jnp.asarray(worlds.LANES_LENGTHS, jnp.int32))
    got, _ = llama.prefill_chunked(
        cfg, params_from_numpy(tree, device="cpu"), torch.from_numpy(toks),
        KVCache.create(cfg.n_layers, b, worlds.LANES_CACHE, cfg.n_kv_heads,
                       cfg.head_dim, cfg.dtype, "cpu"),
        worlds.LANES_CHUNK, torch.tensor(worlds.LANES_LENGTHS,
                                         dtype=torch.int32))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= TOL, err
