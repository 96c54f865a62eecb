"""The paged path's fused rope + KV write (``paged_rope_scatter`` and
``paged_rope_scatter_q``, grove_tpu_torch/ops/kvquant.py) against the JAX
package's ``apply_rope`` on q and k followed by ``_paged_scatter`` or
``_paged_scatter_q``: bitwise, on CPU tensors (the wrappers' plain route),
with an offset chunk, a padded tail marked invalid, positions past the
table's width and past the rope table; then its checks on the CPU, and on a
CUDA card the kernel against its plain version, bitwise.

JAX's ``apply_rope`` runs eagerly: its products and sums then round to f32
one by one, as PyTorch's and the kernel's do (under jit XLA:CPU contracts
the f32 rope into fused multiply-adds). ``_paged_scatter_q`` runs jitted,
as the JAX engine runs it: XLA then folds its division by 127 into a
product with f32(1/127), which is what the port computes.

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_rope_write.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.ops import rope as jrope
from grove_tpu_torch.ops import kvquant
from grove_tpu_torch.ops.rope import rope_table

# Without the repo's conftest (on the machine with the card) JAX would take
# the GPU, whose f32 products run at reduced precision.
jax.config.update("jax_platforms", "cpu")
# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

NB, BS, H, N_KV, C = 12, 4, 4, 2, 6
TABLES = np.array([[3, 5, 7, 0], [2, 4, 9, 11], [0, 0, 0, 0]], np.int32)
ROPE_LEN = 16  # the table's 4 blocks of 4 reach position 15 too


def _case(seed, d, offset, n_valid, dtype):
    """Numpy inputs (rows already of ``dtype``'s values) and the same
    tensors for torch."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)

    def rows(*shape):
        x = rng.standard_normal(shape) * rng.uniform(0.1, 8.0, shape[:-1]
                                                     + (1,))
        return torch.from_numpy(x.astype(np.float32)).to(tdt)

    q, k, v = rows(3, C, H, d), rows(3, C, N_KV, d), rows(3, C, N_KV, d)
    k[0, 0, 0] = 0  # an all-zero row takes the floor scale
    pos = np.broadcast_to(offset + np.arange(C)[None], (3, C)).astype(
        np.int32)
    valid = np.broadcast_to(np.arange(C)[None] < n_valid, (3, C)).copy()
    return q, k, v, pos, valid


def _j(t: torch.Tensor, dtype: str):
    return jnp.asarray(t.float().numpy(), dtype=getattr(jnp, dtype))


@pytest.mark.parametrize("pool", ["model", "int8"])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset,n_valid", [(0, 6), (9, 2), (13, 6)])
def test_cpu_route_is_bitwise_jax(pool, d, dtype, offset, n_valid):
    """q, the pools and the int8 scales equal JAX's ``apply_rope`` then
    ``_paged_scatter`` / ``_paged_scatter_q`` bit for bit: offset 13 runs
    past the table's width (rows to the null block) and past the rope
    table (rows take its last entry); offset 9 with 2 valid rows reroutes
    the padded tail."""
    q, k, v, pos, valid = _case(d + offset, d, offset, n_valid, dtype)
    jc, js = jrope.rope_table(ROPE_LEN, d)
    cos, sin = rope_table(ROPE_LEN, d)
    jpos, jvalid, jtables = (jnp.asarray(x) for x in (pos, valid, TABLES))
    jq = jrope.apply_rope(_j(q, dtype), jc, js, jpos)
    jk = jrope.apply_rope(_j(k, dtype), jc, js, jpos)
    rng = np.random.default_rng(7)
    if pool == "model":
        pools = [torch.from_numpy(rng.standard_normal(
            (NB, BS, N_KV, d)).astype(np.float32)).to(getattr(torch, dtype))
            for _ in range(2)]
        want = [jllama._paged_scatter(_j(p, dtype), r, jtables, jpos,
                                      valid=jvalid)
                for p, r in zip(pools, (jk, _j(v, dtype)))]
        scales = [None, None]
        wrapper, args = kvquant.paged_rope_scatter, pools
    else:
        pools = [torch.from_numpy(rng.integers(
            -127, 128, (NB, BS, N_KV, d)).astype(np.int8)) for _ in range(2)]
        scales = [torch.from_numpy(rng.uniform(
            1e-3, 0.05, (NB, BS, N_KV)).astype(np.float32))
            for _ in range(2)]
        scatter_q = jax.jit(jllama._paged_scatter_q)
        outs = [scatter_q(jnp.asarray(p.numpy()), jnp.asarray(s.numpy()), r,
                          jtables, jpos, valid=jvalid)
                for p, s, r in zip(pools, scales, (jk, _j(v, dtype)))]
        want = [o[0] for o in outs] + [o[1] for o in outs]
        wrapper, args = kvquant.paged_rope_scatter_q, pools + scales
    before = wrapper.launches
    got_q = wrapper(*args, q, k, v, cos, sin, torch.from_numpy(TABLES),
                    torch.from_numpy(pos), torch.from_numpy(valid))
    assert wrapper.launches == before  # CPU: no kernel
    np.testing.assert_array_equal(got_q.float().numpy(),
                                  np.asarray(jq, np.float32))
    got = pools + [s for s in scales if s is not None]
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        # Rerouted rows may collide in the null block, whose contents are
        # garbage by design: every other block bitwise, all of it where no
        # row collides.
        np.testing.assert_array_equal(g[1:], w[1:])
        if offset + n_valid <= 12:
            np.testing.assert_array_equal(g, w)


def test_wrappers_reject_bad_inputs():
    q, k, v, pos, valid = _case(1, 8, 0, 6, "float32")
    cos, sin = rope_table(ROPE_LEN, 8)
    kp, vp = (torch.zeros((NB, BS, N_KV, 8)) for _ in range(2))
    kq, vq = (torch.zeros((NB, BS, N_KV, 8), dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.zeros((NB, BS, N_KV)) for _ in range(2))
    t, p = torch.from_numpy(TABLES), torch.from_numpy(pos)
    with pytest.raises(ValueError, match="pools of the rows' type"):
        kvquant.paged_rope_scatter(kp.bfloat16(), vp.bfloat16(), q, k, v,
                                   cos, sin, t, p)
    with pytest.raises(ValueError, match="share one type"):
        kvquant.paged_rope_scatter(kp, vp, q.bfloat16(), k, v, cos, sin, t,
                                   p)
    with pytest.raises(ValueError, match=r"q must be \[b, s, h, d\]"):
        kvquant.paged_rope_scatter(kp, vp, q[:, :2], k, v, cos, sin, t, p)
    with pytest.raises(ValueError, match="rope tables"):
        kvquant.paged_rope_scatter(kp, vp, q, k, v, cos.double(), sin, t, p)
    with pytest.raises(ValueError, match="rope tables"):
        kvquant.paged_rope_scatter(kp, vp, q, k, v, cos[:, :2], sin, t, p)
    with pytest.raises(ValueError, match="float32 scales"):
        kvquant.paged_rope_scatter_q(kq, vq, ks.double(), vs, q, k, v, cos,
                                     sin, t, p)
    with pytest.raises(ValueError, match="do not match"):
        kvquant.paged_rope_scatter_q(kq, vq, ks, vs, q, k, v, cos, sin, t,
                                     p[:, :2])
    with pytest.raises(ValueError, match="cuda or cpu"):
        kvquant.paged_rope_scatter(kp, vp, q.to("meta"), k, v, cos, sin, t,
                                   p)


def test_kernel_is_bitwise_plain_on_cuda():
    """The fused kernel against its plain version, bitwise on q, both pools
    and the int8 scales, over both pool kinds, f32 and bf16 rows, at
    llama-1b's heads (16 q, 8 kv, 128 wide) and test-tiny's width (8): one
    sequence's chunk past its table's width and past a short rope table,
    the other's padded tail marked invalid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    bs, w, c = 16, 4, 32
    nb = 1 + 2 * w
    tables = (1 + torch.randperm(nb - 1, device="cuda")).reshape(2, w).to(
        torch.int32)
    steps = torch.arange(c, dtype=torch.int32, device="cuda")
    pos = torch.stack([40 + steps, steps])  # 64..71 past the table
    valid = torch.ones((2, c), dtype=torch.bool, device="cuda")
    valid[1, 24:] = False
    for h, n_kv, d in ((16, 8, 128), (8, 4, 8)):
        cos, sin = rope_table(60, d, device="cuda")  # 60.. past the table
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((2, c, h, d), generator=gen,
                            device="cuda").to(dtype)
            k, v = (3 * torch.randn((2, c, n_kv, d), generator=gen,
                                    device="cuda").to(dtype)
                    for _ in range(2))
            for int8 in (False, True):
                if int8:
                    pools = [torch.randint(-127, 128, (nb, bs, n_kv, d),
                                           generator=gen, device="cuda",
                                           dtype=torch.int8)
                             for _ in range(2)]
                    pools += [torch.rand((nb, bs, n_kv), generator=gen,
                                         device="cuda") for _ in range(2)]
                    wrapper = kvquant.paged_rope_scatter_q
                else:
                    pools = [torch.randn((nb, bs, n_kv, d), generator=gen,
                                         device="cuda").to(dtype)
                             for _ in range(2)]
                    wrapper = kvquant.paged_rope_scatter
                mine = [t.clone() for t in pools]
                before = wrapper.launches
                got = wrapper(*mine, q, k, v, cos, sin, tables, pos, valid)
                torch.cuda.synchronize()
                assert wrapper.launches == before + 1
                scales = pools[2:] if int8 else [None, None]
                want = kvquant.paged_rope_scatter_ref(
                    pools[0], pools[1], *scales, q, k, v, cos, sin, tables,
                    pos, valid)
                assert torch.equal(got, want), (h, d, dtype, int8)
                assert all(torch.equal(a, b) for a, b in zip(mine, pools)), \
                    (h, d, dtype, int8)
