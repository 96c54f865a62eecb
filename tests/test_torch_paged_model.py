"""The port's paged model functions and the plain paged attention against
the JAX package's on the same weights (converted key for key), pools,
tables and tokens (the kernels' own tests, which need no JAX, are
tests/test_torch_paged_kernels.py).

f32 on a small config is held to rtol = atol = 1e-4 (the frameworks order
their sums differently); bf16 logits to the model-level bound
max |diff| <= 5e-2 * max |logit|; the bf16 attention outputs to 2e-2 (two
bf16 roundings: the output, one ulp = 2^-8 relative, and P before P.V).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.ops import attention as jattn
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops import kvquant, paged

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
NB, BS = 12, 4
TABLES = np.array([[3, 5, 7, 0], [2, 4, 9, 11], [0, 0, 0, 0]], np.int32)
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _pools(seed, layers=J_CFG.n_layers, n_kv=J_CFG.n_kv_heads,
           d=J_CFG.head_dim):
    rng = np.random.default_rng(seed)
    shape = (layers, NB, BS, n_kv, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# ---- the scatter: bitwise, with the valid reroute ----

@pytest.mark.parametrize("offset,n_valid", [(0, 6), (5, 6), (6, 6), (9, 2),
                                            (11, 1), (13, 6)])
def test_paged_scatter_is_bitwise_jax(offset, n_valid):
    """A chunk's rows land where JAX puts them, bit for bit: the padded
    tail rerouted to the null block, and valid positions past the table's
    width too (JAX's take_along_axis fills the column with the int32
    minimum, which times the even block size wraps to block 0)."""
    k, _ = _pools(1, layers=1)
    rng = np.random.default_rng(2)
    kv = rng.standard_normal((3, 6, J_CFG.n_kv_heads,
                              J_CFG.head_dim)).astype(np.float32)
    pos = np.broadcast_to(offset + np.arange(6)[None], (3, 6)).astype(np.int32)
    valid = np.broadcast_to(np.arange(6)[None] < n_valid, (3, 6))
    want = np.asarray(jllama._paged_scatter(
        jnp.asarray(k[0]), jnp.asarray(kv), jnp.asarray(TABLES),
        jnp.asarray(pos), valid=jnp.asarray(valid)))
    got = torch.from_numpy(k[0].copy())
    out = kvquant.paged_scatter_ref(got, torch.from_numpy(kv),
                                    torch.from_numpy(TABLES),
                                    torch.from_numpy(pos),
                                    valid=torch.from_numpy(valid.copy()))
    assert out is got  # in place
    # Colliding (rerouted) rows land only in the null block, whose
    # contents are garbage by design: compare every other block bitwise.
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    if offset + n_valid <= 12:  # within every row's backed blocks
        np.testing.assert_array_equal(got.numpy(), want)


def test_only_rerouted_rows_collide_and_only_in_the_null_block():
    """The duplicate-index invariant behind in-place scatters on CUDA
    (where duplicate writes land in no defined order): over random tables,
    chunk offsets and backed capacities, every valid row is the only
    writer of its slot, and that slot lies in a real block; only rerouted
    rows share slots, all in the null block."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        b, w = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        blocks = rng.permutation(np.arange(1, NB))[:b * w].reshape(b, w)
        n_backed = rng.integers(0, w + 1, size=b)
        tables = np.where(np.arange(w)[None] < n_backed[:, None], blocks, 0)
        c = int(rng.integers(1, 9))
        offset = int(rng.integers(0, w * BS))
        pos = torch.from_numpy(np.broadcast_to(
            offset + np.arange(c)[None], (b, c)).astype(np.int64).copy())
        valid = pos < torch.from_numpy(n_backed)[:, None] * BS
        _assert_valid_rows_write_alone(tables, pos, valid)


def _random_tables(rng):
    b, w = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    blocks = rng.permutation(np.arange(1, NB))[:b * w].reshape(b, w)
    n_backed = rng.integers(0, w + 1, size=b)
    tables = np.where(np.arange(w)[None] < n_backed[:, None], blocks, 0)
    return tables, n_backed


def _assert_valid_rows_write_alone(tables, pos, valid) -> None:
    """Each valid row is the only writer of its slot, in a real block."""
    b, c = pos.shape
    k = torch.zeros((NB, BS, 1, 1))
    rows = torch.arange(b * c, dtype=torch.float32).reshape(b, c, 1, 1)
    kvquant.paged_scatter_ref(k, rows + 1, torch.from_numpy(tables), pos,
                              valid=valid)
    flat = k.reshape(-1)
    for i, r in enumerate((rows + 1).reshape(-1)):
        if valid.reshape(-1)[i]:
            hits = (flat == r).nonzero()
            assert len(hits) == 1 and hits[0, 0] >= BS


def test_verify_rows_collide_only_in_the_null_block():
    """The same invariant for the speculative step's writes: a verify chunk
    of c = k + 1 rows at each sequence's own length and every draft step's
    row (lengths + j), each sequence capped by its limit as the engine sets
    it (what its blocks hold, and max_len; 0 for a padded row, whose length
    is 0). The rows past the limits all land in the null block."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        tables, n_backed = _random_tables(rng)
        b, w = tables.shape
        max_len = int(rng.integers(1, w * BS + 1))
        limit = np.minimum(n_backed * BS, max_len)
        live = limit > 0
        lengths = np.where(live, rng.integers(0, np.maximum(limit, 1)), 0)
        k = int(rng.integers(1, 8))
        pos = torch.from_numpy(
            (lengths[:, None] + np.arange(k + 1)[None]).astype(np.int64))
        valid = pos < torch.from_numpy(limit)[:, None]
        _assert_valid_rows_write_alone(tables, pos, valid)
        for j in range(k):  # the draft steps: one row each
            _assert_valid_rows_write_alone(tables, pos[:, j:j + 1],
                                           valid[:, j:j + 1])


# ---- the model functions ----

@pytest.mark.parametrize("offset,n_valid,logit_idx", [
    (0, 8, 7), (5, 3, 2), (4, 8, 5), (9, 3, 2)])  # 9: padding past the table
def test_prefill_chunk_paged_matches_jax_f32(params, offset, n_valid,
                                              logit_idx):
    jp, tp = params
    k, v = _pools(4)
    toks = np.random.default_rng(5).integers(0, 256, (3, 8)).astype(np.int32)
    jl, jk, jv = jllama.prefill_chunk_paged(
        J_CFG, jp, jnp.asarray(toks), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(TABLES), jnp.int32(offset), jnp.int32(logit_idx),
        jnp.int32(n_valid))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl = tllama.prefill_chunk_paged(T_CFG, tp, torch.from_numpy(toks), tk, tv,
                                    torch.from_numpy(TABLES), offset,
                                    logit_idx, n_valid)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               rtol=1e-4, atol=1e-4)


def test_prefill_chunk_logit_idx_clamps_into_the_chunk(params):
    _, tp = params
    k, v = (torch.from_numpy(x) for x in _pools(4))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 8)).astype(np.int32))
    tables = torch.from_numpy(TABLES[:1])
    last = tllama.prefill_chunk_paged(T_CFG, tp, toks, k.clone(), v.clone(),
                                      tables, 0, 7, 8)
    past = tllama.prefill_chunk_paged(T_CFG, tp, toks, k.clone(), v.clone(),
                                      tables, 0, 40, 8)
    torch.testing.assert_close(past, last, rtol=0, atol=0)


@pytest.mark.parametrize("offset,n_valid,logit_idx", [(0, 8, 7), (9, 3, 2)])
def test_prefill_chunk_device_scalars_equal_ints(params, offset, n_valid,
                                                 logit_idx):
    """Offset, logit row and valid count as int32 device scalars (what a
    captured chunk reads) or as Python ints: bitwise equal logits and
    pools."""
    _, tp = params
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 8)).astype(np.int32))
    outs = []
    for scalars in (False, True):
        k, v = (torch.from_numpy(x) for x in _pools(4))
        args = (offset, logit_idx, n_valid)
        if scalars:
            args = tuple(torch.tensor([a], dtype=torch.int32) for a in args)
        logits = tllama.prefill_chunk_paged(T_CFG, tp, toks, k, v,
                                            torch.from_numpy(TABLES), *args)
        outs.append((logits, k, v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_decode_step_paged_matches_jax_f32(params):
    jp, tp = params
    k, v = _pools(6)
    lengths = np.array([6, 10, 0], np.int32)  # the last: an idle slot
    toks = np.array([3, 77, 0], np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    for step in range(3):
        jl, jk, jv = jllama.decode_step_paged(
            J_CFG, jp, jnp.asarray(toks), jk, jv, jnp.asarray(TABLES),
            jnp.asarray(lengths))
        tl = tllama.decode_step_paged(T_CFG, tp, torch.tensor(toks), tk,
                                      tv, torch.from_numpy(TABLES),
                                      torch.from_numpy(lengths))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
        toks = np.asarray(jnp.argmax(jl, -1), np.int32)
        lengths = lengths + 1
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               rtol=1e-4, atol=1e-4)


def test_paged_functions_bf16_within_model_bound():
    jcfg = dataclasses.replace(J_CFG, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(T_CFG, dtype=torch.bfloat16)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _pools(7))
    jk, jv = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
              for x in (k, v))
    toks = np.random.default_rng(8).integers(0, 256, (3, 8)).astype(np.int32)
    jl, _, _ = jllama.prefill_chunk_paged(
        jcfg, jp, jnp.asarray(toks), jk, jv, jnp.asarray(TABLES),
        jnp.int32(4), jnp.int32(7), jnp.int32(8))
    tl = tllama.prefill_chunk_paged(tcfg, tp, torch.from_numpy(toks),
                                    k.clone(), v.clone(),
                                    torch.from_numpy(TABLES), 4, 7, 8)
    j, t = _f32(jl), _f32(tl)
    assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()
    lengths = np.array([6, 15, 3], np.int32)
    jl, _, _ = jllama.decode_step_paged(jcfg, jp, jnp.asarray(toks[:, 0]),
                                        jk, jv, jnp.asarray(TABLES),
                                        jnp.asarray(lengths))
    tl = tllama.decode_step_paged(tcfg, tp, torch.from_numpy(toks[:, 0]),
                                  k.clone(), v.clone(),
                                  torch.from_numpy(TABLES),
                                  torch.from_numpy(lengths))
    j, t = _f32(jl), _f32(tl)
    assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()


def test_paged_block_copy_matches_jax():
    k, v = _pools(9)
    src, dst = np.array([3, 0, 5], np.int32), np.array([8, 0, 2], np.int32)
    jk, jv = jllama.paged_block_copy(jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(src), jnp.asarray(dst))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tllama.paged_block_copy(tk, tv, tk, tv, torch.from_numpy(src).long(),
                            torch.from_numpy(dst).long())
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---- the plain paged attention against JAX's gather + attention ----

def _attn_inputs(seed, b, c, h, n_kv, d, w, dtype):
    rng = np.random.default_rng(seed)
    nb = 1 + b * w
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, BS, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((nb, BS, n_kv, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb)).reshape(b, w).astype(np.int32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                   for x in (q, k, v))
    return q, k, v, tables


def _both(arrays, dtype):
    jx = [jnp.asarray(a, dtype=dtype) if a.dtype == np.float32
          else jnp.asarray(a) for a in arrays]
    tdt = getattr(torch, dtype)
    tx = [torch.from_numpy(a.copy()).to(tdt) if a.dtype == np.float32
          else torch.from_numpy(a.copy()) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("h,n_kv,d", [(8, 4, 8), (4, 4, 16), (8, 1, 8)])
def test_plain_paged_decode_matches_jax(dtype, tol, h, n_kv, d):
    q, k, v, tables = _attn_inputs(10, 3, 1, h, n_kv, d, 4, dtype)
    lengths = np.array([1, BS + 1, 4 * BS], np.int32)
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(
        [q, k, v, tables, lengths], dtype)
    want = jattn.decode_attention(jq, jllama._paged_gather(jk, jt),
                                  jllama._paged_gather(jv, jt), jl)
    got = paged.paged_decode_attention(tq, tk, tv, tt, tl)
    np.testing.assert_allclose(_f32(got), _f32(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("offset", [0, 5, 13])
def test_plain_paged_chunk_matches_jax(dtype, tol, offset):
    q, k, v, tables = _attn_inputs(11, 2, 8, 8, 4, 8, 6, dtype)
    (jq, jk, jv, jt), (tq, tk, tv, tt) = _both([q, k, v, tables], dtype)
    want = jattn.causal_attention(jq, jllama._paged_gather(jk, jt),
                                  jllama._paged_gather(jv, jt),
                                  q_offset=jnp.int32(offset))
    got = paged.paged_chunk_attention(
        tq, tk, tv, tt, torch.full((2,), offset, dtype=torch.int32))
    np.testing.assert_allclose(_f32(got), _f32(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
