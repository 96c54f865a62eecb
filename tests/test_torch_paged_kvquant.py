"""int8 paged KV in the port against the JAX package: the quantizing
scatter (bitwise, null-block routing included), the dequantizing attention,
the int8 model functions (logits within f32 1e-4, codes bitwise)
and mirrors of tests/test_spec_decode.py's int8 tests (the error bound
against a model-dtype pool, the pool's bytes, the env switch).

f32 on a small config is held to rtol = atol = 1e-4 (the frameworks order
their sums differently); quantization is held bitwise: a row's codes and
scale depend only on that row, through the same f32 arithmetic. JAX's side
runs jitted, as its engine runs it: under jit XLA folds the division of
the scale by 127 into a product with f32(1/127), while an eager call
divides, which rounds some scales one ulp apart.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.ops import attention as jattn
from grove_tpu.serving import kvcache as jkv
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops import kvquant, paged
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving import kvcache as tkv

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
NB, BS = 12, 4
TABLES = np.array([[3, 5, 7, 0], [2, 4, 9, 11], [0, 0, 0, 0]], np.int32)
N_KV, D = J_CFG.n_kv_heads, J_CFG.head_dim


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _q8_pools(seed, layers=J_CFG.n_layers):
    """Random int8 pools and positive scales, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (layers, NB, BS, N_KV, D)
    k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 0.05, shape[:-1]).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


def _rows(seed, shape, dtype):
    """Rows spread over magnitudes, with one all-zero row (the floor scale);
    the same values on both sides."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.uniform(1e-6, 40.0, shape[:-1] + (1,))).astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), dtype=getattr(jnp, dtype)), t


# ---- the quantizing scatter ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_is_bitwise_jax(dtype):
    """Codes and scales of 16k rows at magnitudes from 1e-6 to 40 equal
    ``_paged_scatter_q``'s arithmetic under XLA bit for bit (XLA takes the
    division by 127 as a product with f32(1/127))."""
    jx, tx = _rows(1, (4000, 4, 128), dtype)

    def quantize(x):
        f = x.astype(jnp.float32)
        scale = jnp.maximum(jnp.max(jnp.abs(f), axis=-1),
                            jllama.KV_SCALE_EPS) / 127.0
        q = jnp.clip(jnp.round(f / scale[..., None]), -127, 127)
        return q.astype(jnp.int8), scale

    jq, js = jax.jit(quantize)(jx)
    tq, ts = kvquant.quantize_rows(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert kvquant.KV_SCALE_EPS == jllama.KV_SCALE_EPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset,n_valid", [(0, 6), (5, 6), (9, 2),
                                            (11, 1), (13, 6)])
def test_paged_scatter_q_is_bitwise_jax(dtype, offset, n_valid):
    """int8 codes and scales land where JAX puts them, bit for bit: the
    padded tail rerouted to the null block, valid positions past the
    table's width too."""
    k, _, ks, _ = _q8_pools(2, layers=1)
    jrows, trows = _rows(3, (3, 6, N_KV, D), dtype)
    pos = np.broadcast_to(offset + np.arange(6)[None], (3, 6)).astype(np.int32)
    valid = np.broadcast_to(np.arange(6)[None] < n_valid, (3, 6))
    jk, jks = jax.jit(jllama._paged_scatter_q)(
        jnp.asarray(k[0]), jnp.asarray(ks[0]), jrows, jnp.asarray(TABLES),
        jnp.asarray(pos), valid=jnp.asarray(valid))
    tk, tks = torch.from_numpy(k[0].copy()), torch.from_numpy(ks[0].copy())
    out = kvquant.paged_scatter_q_ref(tk, tks, trows,
                                      torch.from_numpy(TABLES),
                                      torch.from_numpy(pos),
                                      valid=torch.from_numpy(valid.copy()))
    assert out is tk  # in place
    # Rerouted rows may collide only in the null block (garbage by design).
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tks.numpy()[1:], np.asarray(jks)[1:])
    if offset + n_valid <= 12:  # within every row's backed blocks
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))


def test_scatter_wrapper_runs_both_pools_on_the_cpu():
    """``paged_scatter_q`` on CPU tensors is the plain version on K and on
    V, and counts no launch."""
    k, v, ks, vs = (torch.from_numpy(x[0].copy()) for x in _q8_pools(4, 1))
    want = [t.clone() for t in (k, v, ks, vs)]
    _, rk = _rows(5, (3, 6, N_KV, D), "float32")
    _, rv = _rows(6, (3, 6, N_KV, D), "float32")
    tables = torch.from_numpy(TABLES)
    pos = (2 + torch.arange(6, dtype=torch.int32))[None].expand(3, 6)
    before = kvquant.paged_scatter_q.launches
    kvquant.paged_scatter_q(k, v, ks, vs, rk, rv, tables, pos)
    assert kvquant.paged_scatter_q.launches == before
    kvquant.paged_scatter_q_ref(want[0], want[2], rk, tables, pos)
    kvquant.paged_scatter_q_ref(want[1], want[3], rv, tables, pos)
    for got, ref in zip((k, v, ks, vs), want):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="float32 scales"):
        kvquant.paged_scatter_q(k, v, ks.double(), vs, rk, rv, tables, pos)
    with pytest.raises(ValueError, match="do not match"):
        kvquant.paged_scatter_q(k, v, ks, vs, rk, rv, tables, pos[:, :2])


# ---- the dequantizing attention ----

def test_paged_gather_q_is_bitwise_jax():
    k, _, ks, _ = _q8_pools(7, layers=1)
    for dtype in ("float32", "bfloat16"):
        want = jllama._paged_gather_q(jnp.asarray(k[0]), jnp.asarray(ks[0]),
                                      jnp.asarray(TABLES),
                                      getattr(jnp, dtype))
        got = paged.paged_gather_q(torch.from_numpy(k[0]),
                                   torch.from_numpy(ks[0]),
                                   torch.from_numpy(TABLES),
                                   getattr(torch, dtype))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_plain_int8_attention_matches_jax(dtype, tol):
    """Both int8 wrappers on CPU tensors (their plain versions) against
    JAX's ``_paged_gather_q`` + decode / causal attention."""
    k, v, ks, vs = _q8_pools(8, layers=1)
    k, v, ks, vs = k[0], v[0], ks[0], vs[0]
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal(
        (3, 8, 8, D)).astype(np.float32)).to(getattr(torch, dtype))
    jq = jnp.asarray(q.float().numpy(), dtype=getattr(jnp, dtype))
    jdt = getattr(jnp, dtype)
    jk = jllama._paged_gather_q(jnp.asarray(k), jnp.asarray(ks),
                                jnp.asarray(TABLES), jdt)
    jv = jllama._paged_gather_q(jnp.asarray(v), jnp.asarray(vs),
                                jnp.asarray(TABLES), jdt)
    tk, tv, tks, tvs, tt = (torch.from_numpy(x)
                            for x in (k, v, ks, vs, TABLES))
    lengths = np.array([1, BS + 1, 4 * BS], np.int32)
    want = jattn.decode_attention(jq[:, :1], jk, jv, jnp.asarray(lengths))
    got = paged.paged_decode_attention_q8(q[:, :1], tk, tv, tks, tvs, tt,
                                          torch.from_numpy(lengths))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    want = jattn.causal_attention(jq, jk, jv, q_offset=jnp.int32(5))
    got = paged.paged_chunk_attention_q8(
        q, tk, tv, tks, tvs, tt, torch.full((3,), 5, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    with pytest.raises(ValueError, match="dtype mismatch"):
        paged.paged_decode_attention_q8(q[:, :1], tk.float(), tv.float(),
                                        tks, tvs, tt,
                                        torch.from_numpy(lengths))


# ---- the int8 model functions ----

def test_int8_chunk_then_decode_match_jax(params):
    """A chunk that runs past one table's backed blocks, then three decode
    steps, over int8 pools: logits within 1e-4 of JAX's at every call; the
    int8 codes bitwise equal after all of them, and the scales within
    1e-6 relative: the K/V rows they quantize come out of f32 products
    that the frameworks sum in another order (a few ulp apart), so a
    row's absmax, and its scale, may move by as much
    (test_paged_scatter_q_is_bitwise_jax holds the quantizer itself
    bitwise on equal rows)."""
    jp, tp = params
    k, v, ks, vs = _q8_pools(10)
    j = [jnp.asarray(x) for x in (k, v, ks, vs)]
    t = [torch.from_numpy(x.copy()) for x in (k, v, ks, vs)]
    toks = np.random.default_rng(11).integers(0, 256, (3, 8)).astype(np.int32)
    chunk = jax.jit(functools.partial(jllama.prefill_chunk_paged, J_CFG))
    step = jax.jit(functools.partial(jllama.decode_step_paged, J_CFG))
    out = chunk(jp, jnp.asarray(toks), j[0], j[1], jnp.asarray(TABLES),
                jnp.int32(9), jnp.int32(2), jnp.int32(3), k_scale=j[2],
                v_scale=j[3])
    jl, j = out[0], list(out[1:])
    tl = tllama.prefill_chunk_paged(T_CFG, tp, torch.from_numpy(toks), t[0],
                                    t[1], torch.from_numpy(TABLES), 9, 2, 3,
                                    k_scale=t[2], v_scale=t[3])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    lengths = np.array([6, 10, 0], np.int32)
    dec = np.array([3, 77, 0], np.int32)
    for _ in range(3):
        out = step(jp, jnp.asarray(dec), j[0], j[1], jnp.asarray(TABLES),
                   jnp.asarray(lengths), k_scale=j[2], v_scale=j[3])
        jl, j = out[0], list(out[1:])
        tl = tllama.decode_step_paged(
            T_CFG, tp, torch.from_numpy(dec.copy()), t[0], t[1],
            torch.from_numpy(TABLES), torch.from_numpy(lengths),
            k_scale=t[2], v_scale=t[3])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        dec = np.asarray(jnp.argmax(jl, -1), np.int32)
        lengths = lengths + 1
    for got, want in zip(t[:2], j[:2]):
        np.testing.assert_array_equal(got.numpy()[:, 1:],
                                      np.asarray(want)[:, 1:])
    for got, want in zip(t[2:], j[2:]):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-6,
                                   atol=0)


def test_paged_block_copy_q_matches_jax():
    k, v, ks, vs = _q8_pools(12)
    src, dst = np.array([3, 0, 5], np.int32), np.array([8, 0, 2], np.int32)
    j = jllama.paged_block_copy_q(
        *(jnp.asarray(x) for x in (k, v, ks, vs, k, v, ks, vs)),
        jnp.asarray(src), jnp.asarray(dst))
    t = [torch.from_numpy(x.copy()) for x in (k, v, ks, vs)]
    tllama.paged_block_copy_q(*t, *t, torch.from_numpy(src).long(),
                              torch.from_numpy(dst).long())
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- mirrors of tests/test_spec_decode.py's int8 tests ----

def test_int8_kv_logit_error_bound(params):
    """Decode logits off a quantized pool stay within the JAX package's
    pinned bound of the f32 pool's on the same prefilled context."""
    _, tp = params
    b, s = 2, 12
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, T_CFG.vocab_size, (b, s)).astype(np.int32))

    def rollout(quant):
        n_blocks, bs = 16, 8
        kv = tkv.PagedKV.create(T_CFG.n_layers, n_blocks, bs,
                                T_CFG.n_kv_heads, T_CFG.head_dim,
                                torch.float32, quant=quant, device="cpu")
        alloc = tkv.BlockAllocator(num_blocks=n_blocks, block_size=bs)
        seqs = [tkv.SeqBlocks(alloc) for _ in range(b)]
        for sb in seqs:
            assert sb.ensure(s + 1)
        tables = torch.from_numpy(tkv.pad_tables([sb.blocks for sb in seqs],
                                                 4))
        logits = tllama.prefill_chunk_paged(T_CFG, tp, prompts, kv.k, kv.v,
                                            tables, 0, s - 1, s, **kv.scales)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = tllama.decode_step_paged(T_CFG, tp, tok, kv.k, kv.v, tables,
                                       torch.full((b,), s,
                                                  dtype=torch.int32),
                                       **kv.scales)
        return out.double().numpy()

    full, quant = rollout("off"), rollout("int8")
    err = np.abs(full - quant).max()
    spread = np.abs(full).max()
    assert 0 < err <= 0.02 * spread + 0.05, (err, spread)


def test_int8_kv_pool_bytes_halve():
    """int8 halves (better) the f32 pool, scales included, exactly as the
    JAX package counts it."""
    f32 = tkv.PagedKV.create(2, 32, 8, 4, 64, torch.float32, device="cpu")
    q8 = tkv.PagedKV.create(2, 32, 8, 4, 64, torch.float32, quant="int8",
                            device="cpu")
    assert q8.quantized and q8.k.dtype == torch.int8
    assert q8.pool_bytes < 0.5 * f32.pool_bytes
    assert not f32.quantized and f32.k_scale is None
    jq8 = jkv.PagedKV.create(2, 32, 8, 4, 64, jnp.float32, quant="int8")
    assert q8.pool_bytes == jq8.pool_bytes


def test_int8_env_switch(params, monkeypatch):
    _, tp = params

    def eng():
        return tengine.PagedDecodeEngine(T_CFG, tp, batch=2, max_len=48,
                                         block_size=8, device="cpu")

    monkeypatch.delenv("GROVE_KV_QUANT", raising=False)
    assert not eng().kv.quantized and eng().kv.k_scale is None
    monkeypatch.setenv("GROVE_KV_QUANT", "int8")
    e = eng()
    assert e.kv.quantized and e.kv_quant == "int8"
    assert e.prefix_stats()["cached_bytes"] == 0
    assert e._block_bytes == 2 * T_CFG.n_layers * 8 * T_CFG.n_kv_heads * (
        T_CFG.head_dim + 4)
    monkeypatch.setenv("GROVE_KV_QUANT", "off")
    assert not eng().kv.quantized
    with pytest.raises(ValueError):
        tengine.PagedDecodeEngine(T_CFG, tp, batch=2, max_len=48,
                                  kv_quant="fp4", device="cpu")
