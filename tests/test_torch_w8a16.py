"""The W8A16 GEMM (grove_tpu_torch/ops/w8a16.py) against the JAX package's
int8-weight projections, its routing and checks on the CPU, the partition
that keeps rows invariant, and on a CUDA card the kernel against its plain
version.

The weights are quantized by the JAX package's ``quantize_tensor`` on the
same numpy weight, and JAX computes ``jnp.einsum(eq, x,
QTensor.materialize())`` (the LM head with ``preferred_element_type=f32``).
Tolerances: f32 rtol = atol = 1e-4 (the frameworks order their sums
differently); bf16 out rtol 1e-2 and atol 1e-2 * max |out| (one bf16
rounding of the output, 2^-8 relative, after sums taken in another order,
which can move a value across a rounding boundary). The CPU route is held
bitwise to the model's former arithmetic (materialize, then einsum), and on
the card the rows are held bitwise across M.

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_w8a16.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.serving import quant as jquant
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops import w8a16
from grove_tpu_torch.serving import engine
from grove_tpu_torch.serving.quant import QTensor

# Without the repo's conftest (on the machine with the card) JAX would take
# the GPU, whose f32 products run at reduced precision.
jax.config.update("jax_platforms", "cpu")
# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

_TINY = jllama.CONFIGS["test-tiny"]
_D, _H, _KV, _HD, _FF, _V = (_TINY.d_model, _TINY.n_heads, _TINY.n_kv_heads,
                             _TINY.head_dim, _TINY.d_ff, _TINY.vocab_size)
# name: (einsum, weight shape, contracted axes, x shape) of one test-tiny
# layer, as llama._qkv / _attn_out / _mlp_block / head use them.
WEIGHTS = {
    "wq": ("bsd,dhk->bshk", (_D, _H, _HD), (0,), (2, 5, _D)),
    "wk": ("bsd,dhk->bshk", (_D, _KV, _HD), (0,), (2, 5, _D)),
    "wv": ("bsd,dhk->bshk", (_D, _KV, _HD), (0,), (2, 5, _D)),
    "wo": ("bshk,hkd->bsd", (_H, _HD, _D), (0, 1), (2, 5, _H, _HD)),
    "w_gate": ("bsd,df->bsf", (_D, _FF), (0,), (2, 5, _D)),
    "w_up": ("bsd,df->bsf", (_D, _FF), (0,), (2, 5, _D)),
    "w_down": ("bsf,fd->bsd", (_FF, _D), (0,), (2, 5, _FF)),
    "lm_head": ("bsd,dv->bsv", (_D, _V), (0,), (2, 5, _D)),
}
BF16_RTOL = 1e-2


def _both(name, dtype, seed=0):
    """The same numpy weight quantized by the JAX package, as JAX and port
    QTensors, and the same x on both sides."""
    eq, shape, axes, x_shape = WEIGHTS[name]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w), axes)
    tq = QTensor(q=torch.from_numpy(np.array(jq.q)),
                 scale=torch.from_numpy(
                     np.array(jq.scale).view(np.int16)).view(
                         torch.bfloat16))
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(
        np.float32)).to(dtype)
    jx = jnp.asarray(x.float().numpy(), dtype=getattr(jnp, str(dtype)[6:]))
    return eq, jq, tq, jx, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(WEIGHTS))
def test_projection_matches_jax(name, dtype):
    """Each test-tiny weight through the port's projection (the W8A16
    wrapper on CPU tensors) against JAX's einsum over the materialized
    weight."""
    eq, jq, tq, jx, x = _both(name, dtype)
    if name == "lm_head":
        want = jnp.einsum(eq, jx, jq.materialize(),
                          preferred_element_type=jnp.float32)
        got = tllama._logits(x, tq)
    else:
        want = jnp.einsum(eq, jx, jq.materialize())
        got = tllama._proj(eq, x, tq)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == (torch.float32 if name == "lm_head" else dtype)
    assert tuple(got.shape) == want.shape
    if dtype == torch.float32 or name == "lm_head":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(WEIGHTS))
def test_cpu_route_is_bitwise_the_materialized_einsum(name, dtype):
    """On CPU tensors the projection equals what the model computed before
    the kernel, bit for bit: the materialized bf16 weight, then the einsum
    at the promoted type (the LM head: both upcast to f32)."""
    eq, _, tq, _, x = _both(name, dtype, seed=1)
    before = w8a16.w8a16_matmul.launches
    w = tq.materialize()
    if name == "lm_head":
        got, want = tllama._logits(x[0], tq), x[0].float() @ w.float()
    else:
        dt = torch.promote_types(x.dtype, w.dtype)
        got, want = tllama._proj(eq, x, tq), torch.einsum(eq, x.to(dt),
                                                          w.to(dt))
    assert torch.equal(got, want)
    assert w8a16.w8a16_matmul.launches == before  # CPU: no kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_projections_are_each_weights_own(dtype):
    """QKV (and gate/up) in one call equal each weight's own projection bit
    for bit, on CPU tensors, with no launch."""
    _, _, wq, _, x = _both("wq", dtype, seed=2)
    _, _, wk, _, _ = _both("wk", dtype, seed=3)
    _, _, wv, _, _ = _both("wv", dtype, seed=4)
    before = w8a16.w8a16_matmul.launches
    got = tllama._projs("bsd,dhk->bshk", x, [wq, wk, wv])
    for g, w in zip(got, (wq, wk, wv)):
        assert torch.equal(g, tllama._proj("bsd,dhk->bshk", x, w))
    assert w8a16.w8a16_matmul.launches == before


def test_dense_weights_keep_einsum():
    x = torch.randn(2, 3, 8)
    w = torch.randn(8, 4, 2)
    before = w8a16.w8a16_matmul.launches
    assert torch.equal(tllama._proj("bsd,dhk->bshk", x, w),
                       torch.einsum("bsd,dhk->bshk", x, w))
    assert w8a16.w8a16_matmul.launches == before


def _args(M=4, K=64, N=32, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(M * 7 + K + N)
    x = torch.randn((M, K), generator=g).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    scale = (torch.rand((N,), generator=g) * 0.01 + 1e-3).to(torch.bfloat16)
    return x, q, scale


def test_wrapper_defaults_to_the_promoted_type():
    for dtype in (torch.float32, torch.bfloat16):
        x, q, scale = _args(dtype=dtype)
        out = w8a16.w8a16_matmul(x, q, scale)
        assert out.dtype == dtype and tuple(out.shape) == (4, 32)
        assert torch.equal(out, w8a16.w8a16_matmul_ref(x, q, scale, dtype))


def test_wrapper_rejects_bad_inputs():
    x, q, scale = _args()
    with pytest.raises(ValueError, match="span devices"):
        w8a16.w8a16_matmul(x, q.to("meta"), scale)
    with pytest.raises(ValueError, match="cuda or cpu"):
        w8a16.w8a16_matmul(x.to("meta"), q.to("meta"), scale.to("meta"))
    with pytest.raises(ValueError, match="int8"):
        w8a16.w8a16_matmul(x, q.to(torch.int16), scale)
    with pytest.raises(ValueError, match="int8"):
        w8a16.w8a16_matmul(x, q, scale.float())
    with pytest.raises(ValueError, match="activations"):
        w8a16.w8a16_matmul(x.half(), q, scale)
    with pytest.raises(ValueError, match="activations"):
        w8a16.w8a16_matmul(x.float(), q, scale, torch.bfloat16)
    with pytest.raises(ValueError, match="mismatch"):
        w8a16.w8a16_matmul(x[:, :32], q, scale)
    with pytest.raises(ValueError, match="mismatch"):
        w8a16.w8a16_matmul(x, q, scale[:16])
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        w8a16.w8a16_matmul(x[None], q, scale)
    with pytest.raises(ValueError, match="1 to 3 weights"):
        w8a16.w8a16_matmul_group(x, [(q, scale)] * 4)
    with pytest.raises(ValueError, match="1 to 3 weights"):
        w8a16.w8a16_matmul_group(x, [], torch.bfloat16)


LLAMA_1B_LAUNCHES = [  # (K, N of each weight) of llama-1b's GEMM launches
    (2048, (2048, 1024, 1024)), (2048, (2048,)), (2048, (5632, 5632)),
    (5632, (2048,)), (2048, (32000,)), (2048, (1024,))]


@pytest.mark.parametrize("K,ns", LLAMA_1B_LAUNCHES)
def test_partition_depends_only_on_the_weights_up_to_256_rows(K, ns):
    """Row invariance by construction: every M <= 256 takes the same tile
    and split of K. The split is a power of two of at most MAX_SPLIT (one
    cluster, each rank owning whole 16-column tiles) and leaves each part
    at least MIN_SPLIT_STEPS k-steps."""
    parts = {w8a16.partition(M, K, ns, torch.bfloat16)
             for M in range(1, w8a16.ROW_INVARIANT_M + 1)}
    assert len(parts) == 1
    wide, split, (bm, bn) = parts.pop()
    assert not wide and (bm, bn) == w8a16.SMALL_TILE
    assert split == w8a16.split_count(K, ns)
    assert split in (1, 2, 4, 8) and split <= w8a16.MAX_SPLIT
    assert split <= (K // w8a16.BK) // w8a16.MIN_SPLIT_STEPS
    assert (bn // split) % 16 == 0  # each rank's columns: whole mma tiles
    # f32 activations: the CUDA-core kernel, unsplit, at every M.
    for M in (1, 32, 4096):
        assert w8a16.partition(M, K, ns, torch.float32) == (
            False, 1, w8a16.FMA_TILE)
    # Above 256 rows: the wide tile, no split.
    assert w8a16.partition(4096, K, ns, torch.bfloat16) == (
        True, 1, w8a16.WIDE_TILE)
    # The dense build: its own split (its residency), from K and the
    # weights alone at every M, slabs above 256 rows; so is a slabbed int8
    # call's.
    for build, tile in (("int8", w8a16.SMALL_TILE),
                        ("bf16", w8a16.DENSE_TILE)):
        want = (False, w8a16.split_count(K, ns, build), tile)
        parts = {w8a16.partition(M, K, ns, torch.bfloat16, build,
                                 slabbed=True) for M in range(1, 1025)}
        assert parts == {want}, build
    assert {w8a16.partition(M, K, ns, torch.bfloat16, "bf16")
            for M in (1, 256, 257, 4096)} == {
        (False, w8a16.split_count(K, ns, "bf16"), w8a16.DENSE_TILE)}


def test_split_fills_the_card_where_columns_are_few():
    """N = 1,024 gives 8 column tiles of 128; the split doubles while the
    doubled CTAs fit in one wave at three per SM, up to the cluster's 8 and
    while each part keeps two k-steps: the CTAs reach the SM count (132)
    wherever the cluster and K allow, and never exceed one wave."""
    for K, ns in LLAMA_1B_LAUNCHES:
        n_tiles = w8a16.column_tiles(ns)
        split = w8a16.split_count(K, ns)
        steps = K // w8a16.BK
        assert (n_tiles * split >= w8a16.SMS or split == w8a16.MAX_SPLIT
                or 2 * split * w8a16.MIN_SPLIT_STEPS > steps)
        assert split == 1 or n_tiles * split <= w8a16.RESIDENT_CTAS
        assert (split == w8a16.MAX_SPLIT
                or 2 * split * n_tiles > w8a16.RESIDENT_CTAS
                or 2 * split * w8a16.MIN_SPLIT_STEPS > steps)
    # llama-1b: QKV 32 tiles, wo and w_down 16, gate/up 88, the head 250.
    assert [w8a16.split_count(K, ns) for K, ns in LLAMA_1B_LAUNCHES] == [
        8, 8, 4, 8, 1, 8]
    assert w8a16.split_count(64, (64,)) == 1  # test-tiny: one k-step
    assert w8a16.split_count(256, (64,)) == 2  # two k-steps per part
    assert w8a16.column_tiles((32, 64, 48)) == 3  # a tile per ragged weight
    assert w8a16.column_tiles((32, 64, 48), 64) == 3


def _trans_register(tile, lane, k0):
    """What ``ldmatrix.trans`` of the int8 tile ``tile`` [k][16 columns],
    seen as an 8 x 8 b16 matrix of column pairs at k rows k0 .. k0 + 7,
    gives ``lane``: stored element (row 2 tig + e, b16 column gid) for e =
    0, 1, as four bytes (k, c), (k, c + 1), (k + 1, c), (k + 1, c + 1)."""
    gid, tig = lane // 4, lane % 4
    k, c = k0 + 2 * tig, 2 * gid
    return [tile[k, c], tile[k, c + 1], tile[k + 1, c], tile[k + 1, c + 1]]


@pytest.mark.parametrize("r", range(16))
def test_swapped_fragment_row_holds_its_mapped_column(r):
    """The small kernel's A fragment, built as csrc/w8a16_gemm.cu builds it
    (``dequant_a``: bytes 0 and 2 of an ldmatrix.trans register make the
    row-gid register, bytes 1 and 3 the row gid + 8 one; k 0..7 feed a0/a1,
    k 8..15 a2/a3), holds in row r the 16 k values of weight column
    ``fragment_column(r)``, at the k positions m16n8k16's A layout gives
    (a0: row gid, k 2 tig, 2 tig + 1; a1: row gid + 8; a2, a3: k + 8)."""
    tile = np.arange(16 * 16).reshape(16, 16)  # [k][column], all distinct
    got = {}
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for half, k0 in ((0, 0), (1, 8)):  # a0/a1, then a2/a3
            b = _trans_register(tile, lane, k0)
            for row, pair in ((gid, (b[0], b[2])), (gid + 8, (b[1], b[3]))):
                for e, v in enumerate(pair):
                    got[(row, 8 * half + 2 * tig + e)] = v
    col = w8a16.fragment_column(r)
    assert [got[(r, k)] for k in range(16)] == list(tile[:, col])
    # A permutation of the 16 columns, which the epilogue undoes: row gid
    # is column 2 gid, row gid + 8 column 2 gid + 1.
    assert sorted(w8a16.fragment_column(i) for i in range(16)) == list(
        range(16))
    assert col == (2 * r if r < 8 else 2 * (r - 8) + 1)


# ---- on the card ----

def _cuda_args(gen, M, K, N, dtype):
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand((N,), generator=gen, device="cuda") * 2e-3
             + 1e-4).to(torch.bfloat16)
    return x, q, scale


@pytest.mark.parametrize("M,K,N,dtype,out", [
    (32, 2048, 2048, torch.bfloat16, torch.bfloat16),
    (32, 2048, 1024, torch.bfloat16, torch.bfloat16),
    (32, 2048, 5632, torch.bfloat16, torch.bfloat16),
    (32, 5632, 2048, torch.bfloat16, torch.bfloat16),
    (32, 2048, 32000, torch.bfloat16, torch.float32),
    (5, 64, 32, torch.bfloat16, torch.bfloat16),
    (300, 2048, 1024, torch.bfloat16, torch.bfloat16),
    (1, 128, 256, torch.float32, torch.float32),
    (40, 2048, 1024, torch.float32, torch.float32),
    (32, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (32, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16),
    (7, 128, (64, 32, 48), torch.bfloat16, torch.float32),
    (300, 2048, (1024, 512), torch.bfloat16, torch.bfloat16),
    (9, 64, (256, 32), torch.float32, torch.float32),
    (1, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (8, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (64, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16),
    (256, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (4096, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16)])
def test_kernel_matches_plain_on_cuda(M, K, N, dtype, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    ns = N if isinstance(N, tuple) else (N,)
    gen = torch.Generator(device="cuda").manual_seed(M + K + sum(ns))
    weights = [_cuda_args(gen, M, K, n, dtype)[1:] for n in ns]
    x = _cuda_args(gen, M, K, 16, dtype)[0]
    before = w8a16.w8a16_matmul.launches
    outs = w8a16.w8a16_matmul_group(x, weights, out)
    torch.cuda.synchronize()
    assert w8a16.w8a16_matmul.launches == before + 1
    for got, (q, scale) in zip(outs, weights):
        want = w8a16.w8a16_matmul_ref(x, q, scale, out)
        assert got.dtype == out
        if out == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * want.abs().max().item())
        else:
            torch.testing.assert_close(
                got.float(), want.float(), rtol=BF16_RTOL,
                atol=BF16_RTOL * want.float().abs().max().item())


@pytest.mark.parametrize("K,ns,out", [
    (2048, (2048, 1024, 1024), torch.bfloat16), (2048, (2048,), torch.bfloat16),
    (2048, (32000,), torch.float32), (2048, (5632, 5632), torch.bfloat16),
    (5632, (2048,), torch.bfloat16)])
def test_rows_do_not_depend_on_m_on_cuda(K, ns, out):
    """Each row of a launch with M rows equals, bit for bit, the same row
    inside a launch with 256 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(K + sum(ns))
    weights = [_cuda_args(gen, 1, K, n, torch.bfloat16)[1:] for n in ns]
    x = _cuda_args(gen, 256, K, 16, torch.bfloat16)[0]
    whole = w8a16.w8a16_matmul_group(x, weights, out)
    for M in (1, 2, 7, 8, 31, 32, 33, 64, 128, 255):
        for a, w in zip(w8a16.w8a16_matmul_group(x[:M], weights, out),
                        whole):
            assert torch.equal(a, w[:M]), M


def test_mixed_devices_raise_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, q, scale = _args()
    with pytest.raises(ValueError, match="span devices"):
        w8a16.w8a16_matmul(x.cuda(), q, scale.cuda())
    with pytest.raises(ValueError, match="K %"):
        w8a16.w8a16_matmul(x[:, :48].cuda(), q[:48].cuda(), scale.cuda())


def test_bf16_build_split_fills_the_card_at_its_residency():
    """The dense kernel's split takes one residency constant for every M
    (96: the card ran llama-1b's launches fastest with the splits it
    gives). The split doubles while the doubled CTAs stay within it.
    llama-1b: QKV 2, wo and w_down 4, gate/up 1, the head 1."""
    assert w8a16.RESIDENT["bf16"] == 96
    assert w8a16.RESIDENT["int8"] == w8a16.RESIDENT_CTAS
    for K, ns in LLAMA_1B_LAUNCHES:
        split = w8a16.split_count(K, ns, "bf16")
        n_tiles = w8a16.column_tiles(ns)
        assert split == 1 or n_tiles * split <= w8a16.RESIDENT["bf16"]
        assert (split == w8a16.MAX_SPLIT
                or 2 * split * n_tiles > w8a16.RESIDENT["bf16"])
        assert split <= w8a16.split_count(K, ns)
    assert [w8a16.split_count(K, ns, "bf16")
            for K, ns in LLAMA_1B_LAUNCHES] == [2, 4, 1, 4, 1, 8]
    # The tiny draft's K = 32: one partial k-step, no split.
    assert w8a16.split_count(32, (16, 8, 8), "bf16") == 1


_DRAFT = tllama.draft_config(tllama.CONFIGS["llama-1b"])
DRAFT_LAUNCHES = [  # the tiny draft's: QKV, wo, gate/up, w_down, the head
    (_DRAFT.d_model, (_DRAFT.n_heads * _DRAFT.head_dim,
                      _DRAFT.n_kv_heads * _DRAFT.head_dim,
                      _DRAFT.n_kv_heads * _DRAFT.head_dim)),
    (_DRAFT.n_heads * _DRAFT.head_dim, (_DRAFT.d_model,)),
    (_DRAFT.d_model, (_DRAFT.d_ff, _DRAFT.d_ff)),
    (_DRAFT.d_ff, (_DRAFT.d_model,)),
    (_DRAFT.d_model, (_DRAFT.vocab_size,))]


@pytest.mark.parametrize("K,ns", LLAMA_1B_LAUNCHES + DRAFT_LAUNCHES
                         + [(32, (16, 8, 8))])
def test_dense_geometry_follows_m_only_in_its_tile_count(K, ns):
    """The dense kernel's launch at M <= 256: the columns per CTA and the
    split (with the k order, all that enters a row's sums) are the same at
    every M; the token tiles (ceil(M / 64)) follow M, and with them the
    wgmma's n (64 a tile), the ring and, at four token tiles only, which
    CTA serves which rows (whole column tiles and halves, so the CTAs).
    The epilogue's partial tile fits the ring it reuses."""
    geos = [w8a16.dense_geometry(M, K, ns)
            for M in range(1, w8a16.ROW_INVARIANT_M + 1)]
    fixed = ("columns", "split", "per_sm")
    assert len({tuple(g[k] for k in fixed) for g in geos}) == 1
    g = geos[0]
    assert (g["columns"], g["split"], g["per_sm"]) == (
        128, w8a16.split_count(K, ns, "bf16"), 1)
    assert g["ctas"] == w8a16.column_tiles(ns) * g["split"]
    assert len({g["ctas"] for g in geos[:192]}) == 1
    by_tiles = {}
    for M, g in enumerate(geos, 1):
        assert g["token_tiles"] == -(-M // 64), M
        assert g["n"] == 64 * g["token_tiles"], M
        assert g["build"] == f"dense{g['token_tiles']}", M
        assert by_tiles.setdefault(g["token_tiles"], g) == g, M
        stage = 128 * 64 * 2 + g["token_tiles"] * 64 * 64 * 2
        # the epilogue's f32 partial tile, rows of 132 floats
        if g["token_tiles"] < 4:
            assert g["stages"] == 200 * 1024 // stage
            assert 64 * g["token_tiles"] * 132 * 4 <= g["stages"] * stage
        else:
            assert g["stages"] == w8a16.DENSE4_RING // stage
            assert g["half_stages"] == w8a16.DENSE4_RING // (
                128 * 64 * 2 + 2 * 64 * 64 * 2)
            assert 256 * 132 * 4 <= w8a16.DENSE4_RING
    assert sorted(by_tiles) == [1, 2, 3, 4]
    # One CTA per SM, a ring of ~200 KB: 8 stages at one token tile; at
    # four, 192 KB: 4 stages of a whole column tile, 6 of a half.
    assert [(r["stages"], r["smem_bytes"])
            for _, r in sorted(by_tiles.items())] == [
        (8, 197760), (6, 197728), (5, 205904), (4, 197728)]
    four = by_tiles[4]
    tiles = w8a16.column_tiles(ns)
    assert four["whole"] == w8a16.dense_whole(K, ns)
    assert 0 <= four["whole"] <= tiles
    assert four["ctas"] == (2 * tiles - four["whole"]) * four["split"]
    for M in (0, 257):
        with pytest.raises(ValueError, match="1 to 256 rows"):
            w8a16.dense_geometry(M, K, ns)


def _published(d, h, kv, ff, vocab):
    """(K, N of each weight) of a Llama-shaped model's five launches (head
    size 128), and the name of each."""
    return [("qkv", d, (h * 128, kv * 128, kv * 128)),
            ("wo", h * 128, (d,)), ("gate_up", d, (ff, ff)),
            ("w_down", ff, (d,)), ("lm_head", d, (vocab,))]


# Yi-1.5-9B and Mistral-7B-v0.3 (benchmark/configs/), with the whole column
# tiles the four-tile build runs at each launch.
PUBLISHED_LAUNCHES = [
    pytest.param(K, ns, whole, id=f"{model}-{name}")
    for model, dims, wholes in (
        ("yi-1.5-9b", (4096, 32, 4, 11008, 64000), (40, 0, 86, 0, 500)),
        ("mistral-7b", (4096, 32, 8, 14336, 32768), (48, 0, 224, 0, 256)))
    for (name, K, ns), whole in zip(_published(*dims), wholes)]


@pytest.mark.parametrize("K,ns,whole", PUBLISHED_LAUNCHES)
def test_four_tile_build_at_published_launches(K, ns, whole):
    """At the benchmark's models' launches the four-tile build fits one
    CTA's shared memory (232,448 bytes on an H100), its partial tile of a
    whole column tile (256 rows) and of a half (128 rows) fits the ring it
    is staged over, and its split is the one-tile build's: a row's sums at
    M = 256 are its sums at M = 1. Whole tiles where they fill the card
    (QKV, the head), halves where the whole tiles leave half of it idle
    (wo, w_down), half the tiles whole where the whole tiles take 1.3
    waves (Yi's gate/up: 172 tiles, 258 CTAs)."""
    g4, g1 = (w8a16.dense_geometry(M, K, ns) for M in (256, 1))
    assert g4["smem_bytes"] <= 232448
    for rows in (256, 128):
        assert rows * (g4["columns"] + 4) * 4 <= w8a16.DENSE4_RING
    assert g4["split"] == g1["split"]
    assert g4["whole"] == whole
    assert g4["ctas"] == (2 * w8a16.column_tiles(ns) - whole) * g4["split"]


def test_dense_whole_fills_the_card_waves():
    """Halves where they fit one wave and their clusters are at most 2;
    whole tiles where those fit one wave or need over 1.5; between, half
    the tiles whole."""
    assert w8a16.dense_whole(4096, (4096,)) == 0           # 32 tiles x 2
    assert w8a16.dense_whole(2048, (2048,)) == 16          # split 4: whole
    assert w8a16.dense_whole(4096, (4096, 512, 512)) == 40  # 80 CTAs
    assert w8a16.dense_whole(4096, (11008, 11008)) == 86   # 172 CTAs
    assert w8a16.dense_whole(4096, (14336, 14336)) == 224  # 224 CTAs
    assert w8a16.dense_whole(32, (16, 8, 8)) == 0


def test_dense_launches_fill_the_card_with_few_long_ctas():
    """No M axis: a dense launch's CTAs are its column tiles of 128 times
    the split, the same at every M, one CTA per SM. llama-1b's five
    launches (and wk alone) hold 64 to 250 CTAs: each pays its ring's fill
    and the cluster epilogue once, which the card showed costs more than
    the SMs the smaller launches leave idle. Every launch fits one wave
    but the head (250 CTAs, no cluster); the split-8 clusters would not
    (15 clusters of 8 co-resident at one CTA per SM)."""
    ctas = [w8a16.dense_geometry(32, K, ns)["ctas"]
            for K, ns in LLAMA_1B_LAUNCHES]
    assert ctas == [64, 64, 88, 64, 250, 64]
    assert all(c <= w8a16.SMS for c in ctas if c != 250)
    assert [w8a16.dense_geometry(32, K, ns)["split"]
            for K, ns in DRAFT_LAUNCHES] == [4, 4, 4, 8, 1]
    assert [w8a16.dense_geometry(256, K, ns)["ctas"]
            for K, ns in DRAFT_LAUNCHES] == [32, 16, 88, 32, 250]


def test_dense_launch_counter_counts_each_build():
    """Each launch of a dense call is counted under its build
    (``dense_builds``): by the token tiles of its slab, ``fma`` for f32. A
    graph capture's counts move to each replay, by build too
    (``serving/engine.py``: ``take_captured``, ``add_replayed``)."""
    b = w8a16.dense_builds
    assert [b(M, "bf16") for M in (1, 64, 65, 128, 129, 192, 193, 256)] == [
        ["dense1"], ["dense1"], ["dense2"], ["dense2"], ["dense3"],
        ["dense3"], ["dense4"], ["dense4"]]
    assert b(257, "bf16") == ["dense4", "dense1"]
    assert b(700, "bf16") == ["dense4", "dense4", "dense3"]
    assert b(700, "f32") == ["fma"]
    assert set(w8a16.dense_matmul.launches_by_build) == {
        "dense1", "dense2", "dense3", "dense4", "fma"}

    def wrapper(by_build=True):
        def w():
            pass
        w.launches = 5
        if by_build:
            w.launches_by_build = {"dense1": 3, "dense4": 2}
        return w

    dense, plain, idle = wrapper(), wrapper(False), wrapper()
    counters = (dense, plain, idle)
    before = engine.launch_counts(counters)
    dense.launches += 3           # what a capture of one chunk counts
    dense.launches_by_build["dense4"] += 2
    dense.launches_by_build["dense1"] += 1
    plain.launches += 4
    moved = engine.take_captured(counters, before)
    assert [(w.launches, getattr(w, "launches_by_build", None))
            for w in counters] == [(5, {"dense1": 3, "dense4": 2}),
                                   (5, None),
                                   (5, {"dense1": 3, "dense4": 2})]
    for _ in range(2):            # two replays
        engine.add_replayed(moved)
    assert dense.launches == 11 and plain.launches == 13
    assert dense.launches_by_build == {"dense1": 5, "dense4": 6}
    assert idle.launches == 5 and idle.launches_by_build == {
        "dense1": 3, "dense4": 2}


def test_slab_boundaries():
    """Above 256 rows a slabbed call runs consecutive slabs of 256 rows
    from row 0, the last one ragged: every row once, in order
    (M = 257..1,024; up to 256 one slab)."""
    for M in range(1, 1025):
        parts = w8a16.slabs(M)
        assert len(parts) == -(-M // w8a16.ROW_INVARIANT_M), M
        assert parts[0][0] == 0
        for (r0, n), (r1, _) in zip(parts, parts[1:]):
            assert n == w8a16.ROW_INVARIANT_M and r1 == r0 + n, M
        r_last, n_last = parts[-1]
        assert 1 <= n_last <= w8a16.ROW_INVARIANT_M, M
        assert r_last + n_last == M, M
    assert w8a16.slabs(257) == [(0, 256), (256, 1)]
    assert w8a16.slabs(1024) == [(0, 256), (256, 256), (512, 256),
                                 (768, 256)]


def _dense(name, dtype, seed=0):
    """A test-tiny weight as stored, and an x, made with numpy."""
    eq, shape, _, x_shape = WEIGHTS[name]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    return eq, torch.from_numpy(w).to(dtype), torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(WEIGHTS))
def test_dense_cpu_route_is_the_einsum(name, dtype):
    """The dense wrapper on CPU tensors is the model's einsum on dense
    weights bit for bit (the LM head: the f32 product of the upcast
    values), with no launch counted; so is the model's projection."""
    eq, w, x = _dense(name, dtype)
    w_axes, out_axes = eq.split(",")[1].split("->")
    n_contract = sum(a not in out_axes for a in w_axes)
    k = w.shape[:n_contract].numel()
    before = w8a16.dense_matmul.launches
    if name == "lm_head":
        got = w8a16.dense_matmul(x.reshape(-1, k), w, torch.float32)
        want = x.reshape(-1, k).float() @ w.float()
        assert torch.equal(tllama._logits(x, w).reshape(-1, w.shape[1]),
                           want)
    else:
        got = w8a16.dense_matmul(x.reshape(-1, k), w.reshape(k, -1))
        want = torch.einsum(eq, x, w).reshape(got.shape)
        assert torch.equal(tllama._proj(eq, x, w).reshape(got.shape), want)
    assert torch.equal(got, want)
    assert w8a16.dense_matmul.launches == before


def test_dense_wrapper_types_and_raises():
    x = torch.randn(4, 64)
    w = torch.randn(64, 32)
    assert w8a16.dense_matmul(x, w).dtype == torch.float32
    assert torch.equal(w8a16.dense_matmul(x.bfloat16(), w.bfloat16(),
                                          torch.float32),
                       x.bfloat16().float() @ w.bfloat16().float())
    outs = w8a16.dense_matmul_group(x, [w, w[:, :16]])
    assert [tuple(o.shape) for o in outs] == [(4, 32), (4, 16)]
    with pytest.raises(ValueError, match="span devices"):
        w8a16.dense_matmul(x, w.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        w8a16.dense_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="mismatch"):
        w8a16.dense_matmul(x[:, :32], w)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        w8a16.dense_matmul(x[None], w)
    with pytest.raises(ValueError, match="1 to 3 weights"):
        w8a16.dense_matmul_group(x, [w] * 4)


# ---- the dense build and slabs on the card ----

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.parametrize("M,K,N,xt,out", [
    (32, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (32, 2048, (2048,), torch.bfloat16, torch.bfloat16),
    (32, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16),
    (32, 5632, (2048,), torch.bfloat16, torch.bfloat16),
    (32, 2048, (32000,), torch.bfloat16, torch.float32),
    (64, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (64, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16),
    (128, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (128, 2048, (32000,), torch.bfloat16, torch.float32),
    (128, 5632, (2048,), torch.bfloat16, torch.bfloat16),
    (200, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16),
    (200, 2048, (2048,), torch.bfloat16, torch.bfloat16),
    (256, 5632, (2048,), torch.bfloat16, torch.bfloat16),
    (256, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
    (256, 2048, (32000,), torch.bfloat16, torch.float32),
    (256, 512, (1408, 1408), torch.bfloat16, torch.bfloat16),
    (256, 4096, (4096, 512, 512), torch.bfloat16, torch.bfloat16),
    (256, 4096, (4096,), torch.bfloat16, torch.bfloat16),
    (200, 4096, (11008, 11008), torch.bfloat16, torch.bfloat16),
    (129, 11008, (4096,), torch.bfloat16, torch.bfloat16),
    (7, 32, (16, 8, 8), torch.bfloat16, torch.bfloat16),
    (130, 32, (16, 8, 8), torch.bfloat16, torch.float32),
    (5, 64, (40,), torch.bfloat16, torch.float32),
    (300, 512, (1408, 1408), torch.bfloat16, torch.bfloat16),
    (9, 64, (256, 32), torch.float32, torch.float32),
    (600, 100, (24,), torch.float32, torch.float32)])
def test_dense_kernel_matches_plain_on_cuda(M, K, N, xt, out):
    """The dense build (bf16: the wgmma dense kernel, one to four token
    tiles, in slabs above 256 rows; f32: the CUDA-core kernel) against
    ``dense_matmul_ref``; each launch counted under its build."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(M + K + sum(N))
    x = torch.randn((M, K), generator=gen, device="cuda").to(xt)
    ws = [(torch.randn((K, n), generator=gen, device="cuda")
           * K ** -0.5).to(xt) for n in N]
    before = w8a16.dense_matmul.launches
    by_build = dict(w8a16.dense_matmul.launches_by_build)
    outs = w8a16.dense_matmul_group(x, ws, out)
    torch.cuda.synchronize()
    slabs = len(w8a16.slabs(M)) if xt == torch.bfloat16 else 1
    assert w8a16.dense_matmul.launches == before + slabs
    builds = w8a16.dense_builds(M, "bf16" if xt == torch.bfloat16 else "f32")
    assert {k: v - by_build[k] for k, v in
            w8a16.dense_matmul.launches_by_build.items()} == {
        k: builds.count(k) for k in by_build}
    for got, w in zip(outs, ws):
        want = w8a16.dense_matmul_ref(x, w, out)
        assert got.dtype == out
        if out == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * want.abs().max().item())
        else:
            torch.testing.assert_close(
                got.float(), want.float(), rtol=BF16_RTOL,
                atol=BF16_RTOL * want.float().abs().max().item())


@pytest.mark.parametrize("K,ns,out", [
    (2048, (2048, 1024, 1024), torch.bfloat16), (2048, (2048,), torch.bfloat16),
    (2048, (32000,), torch.float32), (2048, (5632, 5632), torch.bfloat16),
    (5632, (2048,), torch.bfloat16), (32, (16, 8, 8), torch.bfloat16),
    (4096, (4096, 512, 512), torch.bfloat16), (4096, (4096,), torch.bfloat16),
    (4096, (11008, 11008), torch.bfloat16), (11008, (4096,), torch.bfloat16)])
def test_dense_rows_do_not_depend_on_m_on_cuda(K, ns, out):
    """Each row of a dense launch with M rows equals, bit for bit, the same
    row inside a launch with 256 rows (every token-tile count, 1 to 4; at
    four, whole column tiles and halves), and inside a slabbed one of 700.
    The last four: Yi-1.5-9B's projections."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(K + sum(ns))
    ws = [torch.randn((K, n), generator=gen, device="cuda").to(
        torch.bfloat16) for n in ns]
    x = torch.randn((700, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    whole = w8a16.dense_matmul_group(x[:256], ws, out)
    for M in (1, 2, 7, 8, 31, 32, 33, 64, 65, 128, 129, 192, 193, 200, 255,
              256):
        for a, w in zip(w8a16.dense_matmul_group(x[:M], ws, out), whole):
            assert torch.equal(a, w[:M]), M
    slabbed = w8a16.dense_matmul_group(x, ws, out)
    for r0, n in w8a16.slabs(700):
        part = w8a16.dense_matmul_group(x[r0:r0 + n], ws, out)
        for a, w in zip(part, slabbed):
            assert torch.equal(a, w[r0:r0 + n]), r0


@pytest.mark.parametrize("tiles", [1, 2, 3, 4])
def test_dense_build_info_matches_its_geometry_on_cuda(tiles):
    """The built dense kernel for 1 to 4 token tiles: no spill, the tile,
    shared memory, stages and CTAs per SM ``dense_geometry`` mirrors, and
    its clusters of 8 co-resident."""
    _cuda_or_skip()
    geo = w8a16.dense_geometry(64 * tiles, 2048, (2048,))
    info = w8a16.kernel_info(geo["build"])
    assert info["local_bytes"] == 0
    assert info["tile"] == (geo["n"], geo["columns"])
    assert (info["smem_bytes"], info["stages"], info["per_sm"]) == (
        geo["smem_bytes"], geo["stages"], geo["per_sm"])
    assert info["cluster"] == 8 and info["resident"] >= 1


@pytest.mark.parametrize("M", [257, 512, 777])
def test_int8_slabs_keep_rows_on_cuda(M):
    """A slabbed int8 call above 256 rows: one launch per slab, each row
    bitwise the same row at M <= 256; the unslabbed call takes the wide
    kernel in one launch."""
    _cuda_or_skip()
    K, ns = 2048, (2048, 1024, 1024)
    gen = torch.Generator(device="cuda").manual_seed(M)
    weights = [_cuda_args(gen, 1, K, n, torch.bfloat16)[1:] for n in ns]
    x = _cuda_args(gen, M, K, 16, torch.bfloat16)[0]
    before = w8a16.w8a16_matmul.launches
    slabbed = w8a16.w8a16_matmul_group(x, weights, torch.bfloat16,
                                       slabbed=True)
    assert w8a16.w8a16_matmul.launches == before + len(w8a16.slabs(M))
    for r0 in range(0, M, 61):
        n = min(61, M - r0)
        part = w8a16.w8a16_matmul_group(x[r0:r0 + n], weights,
                                        torch.bfloat16)
        for a, w in zip(part, slabbed):
            assert torch.equal(a, w[r0:r0 + n]), r0
    before = w8a16.w8a16_matmul.launches
    wide = w8a16.w8a16_matmul_group(x, weights, torch.bfloat16)
    assert w8a16.w8a16_matmul.launches == before + 1
    for a, w in zip(wide, slabbed):
        torch.testing.assert_close(a.float(), w.float(), rtol=BF16_RTOL,
                                   atol=BF16_RTOL * w.float().abs().max()
                                   .item())


def test_dense_shapes_the_kernel_cannot_take_raise_on_cuda():
    _cuda_or_skip()
    x = torch.randn((4, 60), device="cuda").to(torch.bfloat16)
    w = torch.randn((60, 32), device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="K % 8"):
        w8a16.dense_matmul(x, w)
    with pytest.raises(ValueError, match="dense kernel takes"):
        w8a16.dense_matmul(x.float(), w)
