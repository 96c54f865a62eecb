"""PyTorch port ops against the JAX package's ops on the same inputs.

Inputs come from numpy (seeded) and go through both; f32 throughout, held
to rtol = atol = 1e-5 (the two frameworks sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.ops import attention as jattn
from grove_tpu.ops import kvcache as jkv
from grove_tpu.ops.norms import rms_norm as j_rms_norm
from grove_tpu.ops.rope import apply_rope as j_apply_rope
from grove_tpu.ops.rope import rope_table as j_rope_table
from grove_tpu_torch.ops import attention as tattn
from grove_tpu_torch.ops import kvcache as tkv
from grove_tpu_torch.ops.norms import rms_norm as t_rms_norm
from grove_tpu_torch.ops.rope import apply_rope as t_apply_rope
from grove_tpu_torch.ops.rope import rope_table as t_rope_table

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 64), _rand(rng, 64)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = t_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm_bf16_casts_back():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_rand(rng, 2, 4, 32)).to(torch.bfloat16)
    w = torch.ones(32, dtype=torch.bfloat16)
    assert t_rms_norm(x, w).dtype == torch.bfloat16


@pytest.mark.parametrize("max_len,head_dim,theta", [
    (128, 8, 10000.0), (2048, 128, 10000.0), (64, 32, 500000.0)])
def test_rope_table_bitwise(max_len, head_dim, theta):
    jc, js = j_rope_table(max_len, head_dim, theta)
    tc, ts = t_rope_table(max_len, head_dim, theta)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(2)
    b, s, h, d = 2, 6, 4, 16
    x = _rand(rng, b, s, h, d)
    pos = rng.integers(0, 64, size=(b, s)).astype(np.int32)
    jc, js = j_rope_table(64, d)
    tc, ts = t_rope_table(64, d)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos)))
    got = t_apply_rope(torch.from_numpy(x), tc, ts,
                       torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("q_offset", [0, 4, "vector"])
def test_causal_attention_matches_jax(q_offset):
    rng = np.random.default_rng(3)
    b, sq, skv, h, n_kv, d = 3, 8, 12, 8, 2, 16
    q, k, v = (_rand(rng, b, sq, h, d), _rand(rng, b, skv, n_kv, d),
               _rand(rng, b, skv, n_kv, d))
    if q_offset == "vector":
        off = np.array([0, 2, 4], np.int32)
        j_off, t_off = jnp.asarray(off), torch.from_numpy(off)
    else:
        j_off = t_off = q_offset
    want = np.asarray(jattn.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=j_off))
    got = tattn.causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=t_off).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_attention_ragged_lengths_match_jax():
    rng = np.random.default_rng(4)
    b, max_len, h, n_kv, d = 4, 16, 8, 4, 8
    q = _rand(rng, b, 1, h, d)
    kc, vc = _rand(rng, b, max_len, n_kv, d), _rand(rng, b, max_len, n_kv, d)
    lengths = np.array([1, 5, 16, 9], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths)))
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pos", [0, 3, 10, 14, -2, -13, -20])
def test_write_row_matches_dynamic_update_slice(pos):
    """Including the clamp: a start past max_len - s moves to the last
    legal start, with no error; a negative start counts once from the end,
    then clamps."""
    rng = np.random.default_rng(5)
    max_len, s, n_kv, d = 12, 4, 2, 8
    row, kv = _rand(rng, max_len, n_kv, d), _rand(rng, s, n_kv, d)
    want = np.asarray(jkv.write_row(jnp.asarray(row), jnp.asarray(kv), pos))
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = tkv.write_row(torch.from_numpy(row.copy()),
                            torch.from_numpy(kv), p).numpy()
        np.testing.assert_array_equal(got, want)


def test_write_rows_per_lane_positions_match_vmapped_write_row():
    rng = np.random.default_rng(6)
    b, max_len, s, n_kv, d = 4, 10, 1, 2, 4
    rows, kv = _rand(rng, b, max_len, n_kv, d), _rand(rng, b, s, n_kv, d)
    pos = np.array([0, 4, 9, 15], np.int32)  # the last one clamps
    want = np.asarray(jax.vmap(jkv.write_row)(
        jnp.asarray(rows), jnp.asarray(kv), jnp.asarray(pos)))
    got = tkv.write_rows(torch.from_numpy(rows.copy()), torch.from_numpy(kv),
                         torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)


def test_kvcache_create_and_has_room():
    c = tkv.KVCache.create(2, 3, 8, 2, 4, torch.float32, "cpu")
    assert tuple(c.k.shape) == (2, 3, 8, 2, 4) and c.max_len == 8
    c.lengths = torch.tensor([0, 7, 8], dtype=torch.int32)
    j = jkv.KVCache.create(2, 3, 8, 2, 4, jnp.float32)._replace(
        lengths=jnp.asarray([0, 7, 8], jnp.int32))
    for n in (1, 2):
        np.testing.assert_array_equal(c.has_room(n).numpy(),
                                      np.asarray(j.has_room(n)))
