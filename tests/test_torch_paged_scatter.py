"""The model-dtype paged KV write (``paged_scatter``, grove_tpu_torch/ops/
kvquant.py) against the JAX package's ``_paged_scatter``: bitwise, with
rows past the table's width and rows that ``valid`` masks out; its routing
and checks on the CPU; and on a CUDA card the kernel against its plain
version, bitwise (it is a copy).

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_paged_scatter.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu_torch.ops import kvquant

# Without the repo's conftest (on the machine with the card) JAX would take
# the GPU, whose f32 products run at reduced precision.
jax.config.update("jax_platforms", "cpu")
# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

NB, BS, N_KV, D = 12, 4, 4, 8
TABLES = np.array([[3, 5, 7, 0], [2, 4, 9, 11], [0, 0, 0, 0]], np.int32)


def _case(seed, offset, n_valid, c=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pools = [rng.standard_normal((NB, BS, N_KV, D)).astype(dtype)
             for _ in range(2)]
    rows = [rng.standard_normal((3, c, N_KV, D)).astype(dtype)
            for _ in range(2)]
    pos = np.broadcast_to(offset + np.arange(c)[None], (3, c)).astype(
        np.int32)
    valid = np.broadcast_to(np.arange(c)[None] < n_valid, (3, c)).copy()
    return pools, rows, pos, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset,n_valid", [(0, 6), (5, 6), (6, 6), (9, 2),
                                            (11, 1), (13, 6)])
def test_paged_scatter_is_bitwise_jax(dtype, offset, n_valid):
    """K and V of a chunk in one call land where JAX's ``_paged_scatter``
    puts them, bit for bit: a padded tail rerouted to the null block, valid
    positions past a table's width too (JAX fills the column with the int32
    minimum, which times the even block size wraps to block 0)."""
    pools, rows, pos, valid = _case(1, offset, n_valid)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = [np.asarray(jllama._paged_scatter(
        jnp.asarray(p, jdt), jnp.asarray(r, jdt), jnp.asarray(TABLES),
        jnp.asarray(pos), valid=jnp.asarray(valid)).astype(jnp.float32))
        for p, r in zip(pools, rows)]
    got = [torch.from_numpy(p.copy()).to(tdt) for p in pools]
    before = kvquant.paged_scatter.launches
    kvquant.paged_scatter(*got, *(torch.from_numpy(r).to(tdt) for r in rows),
                          torch.from_numpy(TABLES), torch.from_numpy(pos),
                          torch.from_numpy(valid))
    assert kvquant.paged_scatter.launches == before  # CPU: no kernel
    for g, w in zip(got, want):
        # Rerouted rows may collide in the null block, whose contents are
        # garbage by design: every other block bitwise, all of it where no
        # row collides.
        np.testing.assert_array_equal(g.float().numpy()[1:], w[1:])
        if offset + n_valid <= 12:
            np.testing.assert_array_equal(g.float().numpy(), w)


def test_cpu_route_is_the_plain_version_on_each_pool():
    pools, rows, pos, valid = _case(2, 3, 4)
    got = [torch.from_numpy(p.copy()) for p in pools]
    want = [torch.from_numpy(p.copy()) for p in pools]
    t = [torch.from_numpy(x) for x in (*rows, TABLES, pos, valid)]
    kvquant.paged_scatter(*got, *t)
    for pool, r in zip(want, t[:2]):
        kvquant.paged_scatter_ref(pool, r, t[2], t[3], t[4])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rows_cast_to_the_pools_type():
    pools, rows, pos, _ = _case(3, 0, 6)
    got = [torch.from_numpy(p.copy()).to(torch.bfloat16) for p in pools]
    kvquant.paged_scatter(*got, *(torch.from_numpy(r) for r in rows),
                          torch.from_numpy(TABLES), torch.from_numpy(pos))
    want = torch.from_numpy(rows[0][0, 0]).to(torch.bfloat16)
    assert torch.equal(got[0][TABLES[0, 0], 0], want)


def test_wrapper_rejects_bad_inputs():
    pools, rows, pos, valid = _case(4, 0, 6)
    kp, vp = (torch.from_numpy(p) for p in pools)
    k, v = (torch.from_numpy(r) for r in rows)
    tables, tpos = torch.from_numpy(TABLES), torch.from_numpy(pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kvquant.paged_scatter(kp.to(torch.int8), vp.to(torch.int8), k, v,
                              tables, tpos)
    with pytest.raises(ValueError, match="one type"):
        kvquant.paged_scatter(kp, vp.to(torch.bfloat16), k, v, tables, tpos)
    with pytest.raises(ValueError, match="shape mismatch"):
        kvquant.paged_scatter(kp, vp, k[..., :4], v, tables, tpos)
    with pytest.raises(ValueError, match="do not match"):
        kvquant.paged_scatter(kp, vp, k, v, tables, tpos[:, :2])
    with pytest.raises(ValueError, match="cuda or cpu"):
        kvquant.paged_scatter(kp, vp, k.to("meta"), v.to("meta"), tables,
                              tpos)


def test_kernel_is_bitwise_plain_on_cuda():
    """The copy kernel against its plain version, bitwise, in f32 and bf16,
    with one sequence's chunk running past its table's width and the
    other's padded tail marked invalid (distinct null-block slots), at
    llama-1b's row (8 kv heads x 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_kv, d, bs, w, c = 8, 128, 16, 4, 32
    nb = 1 + 2 * w
    tables = (1 + torch.randperm(nb - 1, device="cuda")).reshape(2, w).to(
        torch.int32)
    steps = torch.arange(c, dtype=torch.int32, device="cuda")
    pos = torch.stack([36 + steps, steps])
    valid = torch.ones((2, c), dtype=torch.bool, device="cuda")
    valid[1, 24:] = False
    for dtype in (torch.float32, torch.bfloat16):
        k, v = (torch.randn((2, c, n_kv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        mine = [torch.randn((nb, bs, n_kv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2)]
        ref = [t.clone() for t in mine]
        before = kvquant.paged_scatter.launches
        kvquant.paged_scatter(*mine, k, v, tables, pos, valid)
        torch.cuda.synchronize()
        assert kvquant.paged_scatter.launches == before + 1
        kvquant.paged_scatter_ref(ref[0], k, tables, pos, valid)
        kvquant.paged_scatter_ref(ref[1], v, tables, pos, valid)
        assert all(torch.equal(a, b) for a, b in zip(mine, ref))
