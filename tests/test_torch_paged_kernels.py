"""The paged attention wrappers (grove_tpu_torch/ops/paged.py) without the
JAX package: their routing and checks on the CPU, the row property the
kernels keep, and on a CUDA card each kernel against its plain version and
the paged engine's captured graphs against its eager CPU steps.

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_paged_kernels.py``).
Tolerances: f32 1e-4 (summation order); bf16 2e-2 (two bf16 roundings:
the output, one ulp = 2^-8 relative, and P before P.V). The bf16 row
property is bitwise.
"""

import numpy as np
import pytest
import torch

from grove_tpu_torch.ops import paged

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

BS = 4
BF16_TOL = 2e-2


def _attn_inputs(seed, b, c, h, n_kv, d, w):
    rng = np.random.default_rng(seed)
    nb = 1 + b * w
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, BS, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((nb, BS, n_kv, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb)).reshape(b, w).astype(np.int32)
    return q, k, v, tables


def test_chunk_row_depends_only_on_its_position():
    """The property the kernels keep and the prefix cache relies on: a row
    at absolute position p gets the same numbers whether it sits in a
    chunk at offset 0 or 4, and whatever the table width."""
    q, k, v, tables = _attn_inputs(12, 1, 12, 8, 4, 8, 4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tt = torch.from_numpy(tables)
    whole = paged.paged_chunk_attention(tq, tk, tv, tt,
                                        torch.zeros(1, dtype=torch.int32))
    tail = paged.paged_chunk_attention(tq[:, 4:], tk, tv, tt,
                                       torch.full((1,), 4, dtype=torch.int32))
    np.testing.assert_allclose(tail.numpy(), whole[:, 4:].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cpu_calls_never_count_a_launch():
    q, k, v, tables = _attn_inputs(13, 2, 1, 8, 4, 8, 2)
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, k, v, tables))
    before = (paged.paged_decode_attention.launches,
              paged.paged_chunk_attention.launches)
    paged.paged_decode_attention(tq, tk, tv, tt,
                                 torch.full((2,), 5, dtype=torch.int32))
    paged.paged_chunk_attention(tq, tk, tv, tt,
                                torch.zeros(2, dtype=torch.int32))
    assert (paged.paged_decode_attention.launches,
            paged.paged_chunk_attention.launches) == before


def test_wrappers_reject_bad_inputs():
    q, k, v, tables = _attn_inputs(14, 2, 1, 8, 4, 8, 2)
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, k, v, tables))
    lengths = torch.full((2,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        paged.paged_decode_attention(tq, tk, tv, tt.long(), lengths)
    with pytest.raises(ValueError, match="batch"):
        paged.paged_decode_attention(tq, tk, tv, tt, lengths[:1])
    with pytest.raises(ValueError, match="group"):
        paged.paged_decode_attention(tq[:, :, :6], tk, tv, tt, lengths)
    with pytest.raises(ValueError, match="one query"):
        paged.paged_decode_attention(torch.cat([tq, tq], 1), tk, tv, tt,
                                     lengths)


def test_span_count_and_scratch_size():
    """The split-K geometry the wrapper allocates for: spans tile the table
    width from position 0 (never the lengths), the last one ragged, each
    (query row, span) keeps acc[d], m and l."""
    s = paged.SPLIT_KEYS
    assert s % 32 == 0
    assert paged.n_spans(1, 4) == 1
    assert paged.n_spans(s // 16, 16) == 1
    assert paged.n_spans(s // 16 + 1, 16) == 2
    assert paged.n_spans(64, 16) == 1024 // s
    assert paged.n_spans(128, 16) == 2048 // s
    assert paged.scratch_elems(32, 1, 16, 128, 64, 16) == \
        32 * 16 * (1024 // s) * 130
    q = torch.zeros((2, 3, 8, 16))
    part = paged._scratch(q, 5, 4)
    assert part.dtype == torch.float32
    assert part.numel() == 2 * 3 * 8 * paged.n_spans(5, 4) * 18


# ---- the int8 kernel's fragment maps and geometry (csrc/paged_attn.cu) ----

def _a_layout(lane):
    """m16n8k16's A fragment: (row, k) of registers a0, a0', a1, a1', a2,
    a2', a3, a3' of ``lane`` (' the high bf16 half)."""
    gid, tig = lane // 4, lane % 4
    return [(gid + 8 * (x & 1), 2 * tig + 8 * (x >> 1) + e)
            for x in range(4) for e in range(2)]


def _b_layout(lane):
    """m16n8k16's B fragment: (k, n) of b0, b0', b1, b1' of ``lane``."""
    gid, tig = lane // 4, lane % 4
    return [(2 * tig + 8 * h + e, gid) for h in range(2) for e in range(2)]


@pytest.mark.parametrize("d", [8, 64, 128])
def test_int8_score_terms_pair_the_same_column(d):
    """S = qs K^T over an int8 pool: lane (gid, tig) reads the bytes
    [2 kNT tig, 2 kNT (tig + 1)) of its keys' rows, word ks of them (bytes
    4 ks .. 4 ks + 3, dq4: b0 = bytes 0, 1, b1 = 2, 3) is K's B fragment of
    k step ks, and q's A fragment takes the columns ``q8_column`` names.
    Every score then sums q[c] k[key, c] over each column c once."""
    nt = 8 if d <= 64 else 16
    kd = 8 * nt
    terms = {}  # (row, key) -> [(q column, k column)]
    for ks in range(nt // 2):
        a, b = {}, {}
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            for (r, k), j in zip(_a_layout(lane), (0, 1, 0, 1, 2, 3, 2, 3)):
                a[(r, k)] = paged.q8_column(tig, ks, j, d)
            seg = 2 * nt * tig + 4 * ks  # the lane's word ks
            for (k, n), byte in zip(_b_layout(lane), range(4)):
                b[(k, n)] = (n, seg + byte)  # key n of the 8-key tile
        for r in range(16):
            for n in range(8):
                for k in range(16):
                    key, col = b[(k, n)]
                    assert key == n
                    terms.setdefault((r, n), []).append((a[(r, k)], col))
    for pairs in terms.values():
        assert all(qc == kc for qc, kc in pairs)
        assert sorted(qc for qc, _ in pairs) == list(range(kd))


def _trans_bytes(rows, lane):
    """``ldmatrix.trans`` of 8 int8 rows x 16 bytes read as an 8 x 8 b16
    matrix: lane (gid, tig) gets b16 column gid of rows 2 tig and
    2 tig + 1, as bytes (row, byte): (2 tig, 2 gid), (2 tig, 2 gid + 1),
    (2 tig + 1, 2 gid), (2 tig + 1, 2 gid + 1)."""
    gid, tig = lane // 4, lane % 4
    return [(rows[2 * tig + i // 2], 2 * gid + i % 2) for i in range(4)]


@pytest.mark.parametrize("c", range(8))
def test_int8_output_terms_pair_each_key_with_one_column(c):
    """O += P V over an int8 pool: ldmatrix.trans over the 16-byte chunk c
    of keys 0..7 (register r0) and 8..15 (r1), dq4_keys splitting each
    register by byte column (x: bytes 0, 2; y: 1, 3), b0 / b1 of
    accumulator tile 2 c + e. Each output column sums p[key] v[key, col]
    over all 16 keys once, col as ``q8_output_column`` says, and the
    kernel's four stores per row (acc[2 c][0], acc[2 c + 1][0],
    acc[2 c][1], acc[2 c + 1][1]) land on columns 16 c + 4 tig + 0..3."""
    for e in range(2):
        b = {}
        for lane in range(32):
            r0 = _trans_bytes(list(range(8)), lane)
            r1 = _trans_bytes(list(range(8, 16)), lane)
            halves = [(r0[e], r0[2 + e]), (r1[e], r1[2 + e])]
            for (k, n), (key, byte) in zip(_b_layout(lane),
                                           [x for h in halves for x in h]):
                b[(k, n)] = (key, 16 * c + byte)
        for n in range(8):
            keys = [b[(k, n)][0] for k in range(16)]
            cols = {b[(k, n)][1] for k in range(16)}
            assert keys == list(range(16))  # P's k order: the keys in order
            assert cols == {paged.q8_output_column(c, e, n)}
    for tig in range(4):
        stored = [paged.q8_output_column(c, e, 2 * tig + i)
                  for i, e in ((0, 0), (0, 1), (1, 0), (1, 1))]
        assert stored == [16 * c + 4 * tig + i for i in range(4)]
    assert sorted(paged.q8_output_column(cc, e, n) for cc in range(8)
                  for e in range(2) for n in range(8)) == list(range(128))


def test_int8_geometry():
    """The int8 ring at llama-1b: a decode step's items hold 4 kv heads,
    one warp each, in 17,408-byte stages (two 8 KB boxes, one per K and V,
    and 512 bytes of scales), six deep; a chunk's items one kv head over
    four warps that share each tile's fragments (a 16 KB exchange), eight
    stages of 5,120 bytes. Every call shape the tests and the engine make
    keeps two CTAs per SM and at least two stages."""
    dec = paged.q8_geometry(1, 16, 8, 128, 16)
    assert (dec["hb"], dec["rt"], dec["stage_bytes"], dec["stages"],
            dec["xch_bytes"], dec["smem_bytes"]) == (4, 1, 17408, 6, 0,
                                                     105600)
    assert dec["tma"] and dec["swizzle"] and dec["slot"] == 8192
    chunk = paged.q8_geometry(32, 16, 8, 128, 16)
    assert (chunk["hb"], chunk["rt"], chunk["stage_bytes"], chunk["stages"],
            chunk["xch_bytes"]) == (1, 4, 5120, 8, 16384)
    tiny = paged.q8_geometry(40, 12, 4, 8, 4)  # d = 8: rows by cp.async
    assert not tiny["tma"] and tiny["slot"] == 4 * 16
    assert not paged.q8_geometry(1, 8, 2, 64, 32)["swizzle"]
    for c in (1, 2, 5, 7, 32, 40):
        for h, n_kv in ((16, 8), (8, 1), (12, 4), (8, 8), (32, 2), (16, 2)):
            for d in (8, 24, 64, 120, 128):
                for bs in (4, 16, 32):
                    geo = paged.q8_geometry(c, h, n_kv, d, bs)
                    assert geo["ctas_per_sm"] == 2
                    assert 2 <= geo["stages"] <= paged.MAX_STAGES_Q8
                    assert geo["hb"] * geo["rt"] <= paged.CONSUMER_WARPS
                    assert geo["stage_bytes"] % 1024 == 0


# ---- the kernels themselves (need a CUDA card) ----

def _cuda_pools(gen, nb, bs, n_kv, d, dtype):
    k = torch.randn((nb, bs, n_kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((nb, bs, n_kv, d), generator=gen, device="cuda").to(dtype)
    return k, v


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,h,n_kv,d,w,bs,lengths", [
    (5, 16, 8, 128, 8, BS, None),
    (3, 8, 8, 64, 4, BS, None),
    (4, 8, 1, 64, 2, BS, None),
    (4, 12, 4, 8, 3, BS, None),
    # llama-1b's serving geometry, lengths at block, span and table edges
    (10, 16, 8, 128, 32, 16,
     (1, 16, 17, 127, 128, 129, 255, 256, 257, 512)),
])
def test_kernels_match_plain_on_cuda(dtype, tol, b, h, n_kv, d, w, bs,
                                     lengths):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nb = 1 + b * w
    k, v = _cuda_pools(gen, nb, bs, n_kv, d, dtype)
    tables = (1 + torch.randperm(nb - 1, device="cuda")).reshape(b, w).to(
        torch.int32)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    if lengths is None:
        lengths = torch.randint(1, w * bs + 1, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = paged.paged_decode_attention.launches
    out = paged.paged_decode_attention(q, k, v, tables, lengths)
    torch.cuda.synchronize()
    assert paged.paged_decode_attention.launches == before + 1
    ref = paged.paged_decode_attention_ref(q, k, v, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    qc = torch.randn((b, 40, h, d), generator=gen, device="cuda").to(dtype)
    # Offsets anywhere in the table: some rows run past its last position.
    offs = torch.randint(0, w * bs, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    out = paged.paged_chunk_attention(qc, k, v, tables, offs)
    torch.cuda.synchronize()
    ref = paged.paged_chunk_attention_ref(qc, k, v, tables, offs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_bf16_rows_depend_only_on_position_on_cuda():
    """The card-side twin of test_chunk_row_depends_only_on_its_position,
    bitwise, at llama-1b's heads in bf16: a chunk at offset 0 against its
    tail at offset 19; table width W against 2W (chunk and decode); decode
    at length p + 1 against the chunk's row at position p (the bf16 kernel
    runs both through the same per-row instructions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_kv, g, d, w, bs, c, k0 = 8, 2, 128, 8, 16, 48, 19
    dtype = torch.bfloat16
    k, v = _cuda_pools(gen, 1 + 2 * w, bs, n_kv, d, dtype)
    tables = (1 + torch.randperm(2 * w, device="cuda")).reshape(2, w).to(
        torch.int32)
    wide = torch.cat([tables, torch.zeros_like(tables)], 1)
    q = torch.randn((2, c, n_kv * g, d), generator=gen,
                    device="cuda").to(dtype)
    zero = torch.zeros((2,), dtype=torch.int32, device="cuda")
    whole = paged.paged_chunk_attention(q, k, v, tables, zero)
    tail = paged.paged_chunk_attention(q[:, k0:], k, v, tables, zero + k0)
    padded = paged.paged_chunk_attention(q, k, v, wide, zero)
    lens = torch.arange(1, c + 1, dtype=torch.int32, device="cuda")
    dec_q = q[0][:, None].contiguous()
    dec = paged.paged_decode_attention(
        dec_q, k, v, tables[:1].expand(c, w).contiguous(), lens)
    dec_wide = paged.paged_decode_attention(
        dec_q, k, v, wide[:1].expand(c, 2 * w).contiguous(), lens)
    assert torch.equal(tail, whole[:, k0:])
    assert torch.equal(padded, whole)
    assert torch.equal(dec_wide, dec)
    assert torch.equal(dec[:, 0], whole[0])


def test_engine_graphs_match_eager_cpu_on_cuda():
    """test-tiny f32 through the paged engine on the card (kernels, one
    captured graph per decode bucket) and on the CPU (plain versions,
    eager steps): the same greedy tokens per request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (graphs and kernels)")
    import dataclasses

    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.serving.engine import PagedDecodeEngine
    cfg = dataclasses.replace(CONFIGS["test-tiny"], dtype=torch.float32,
                              max_seq_len=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 19, 3, 11, 7)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                 {n: w.to(dev) for n, w in v.items()})
             for k, v in params.items()}
        eng = PagedDecodeEngine(cfg, p, batch=4, max_len=48, block_size=8,
                                prefill_chunk=8, host_sync_interval=4,
                                device=dev)
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        for _ in range(500):
            eng.admit_from_queue()
            if len(eng.completed) == len(prompts):
                break
            eng.step()
        eng.sync()
        out[dev] = {r.rid: r.generated for r in eng.completed}
        if dev == "cuda":
            assert eng.graphs_captured == \
                len(eng._steps) + len(eng._prefills) > 0
    assert out["cuda"] == out["cpu"]


# ---- int8 pools ----

def _q8(k, v):
    from grove_tpu_torch.ops.kvquant import quantize_rows
    (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
    return kq, vq, ks, vs


def test_int8_cpu_calls_never_count_a_launch():
    q, k, v, tables = _attn_inputs(15, 2, 1, 8, 4, 8, 2)
    tq, tt = torch.from_numpy(q), torch.from_numpy(tables)
    kq, vq, ks, vs = _q8(torch.from_numpy(k), torch.from_numpy(v))
    before = (paged.paged_decode_attention_q8.launches,
              paged.paged_chunk_attention_q8.launches)
    dec = paged.paged_decode_attention_q8(
        tq, kq, vq, ks, vs, tt, torch.full((2,), 5, dtype=torch.int32))
    paged.paged_chunk_attention_q8(tq, kq, vq, ks, vs, tt,
                                   torch.zeros(2, dtype=torch.int32))
    assert (paged.paged_decode_attention_q8.launches,
            paged.paged_chunk_attention_q8.launches) == before
    ref = paged.paged_decode_attention_ref(
        tq, kq, vq, tt, torch.full((2,), 5, dtype=torch.int32), ks, vs)
    assert torch.equal(dec, ref)
    with pytest.raises(ValueError, match="scales"):
        paged.paged_decode_attention_q8(tq, kq, vq, ks[:1], vs, tt,
                                        torch.full((2,), 5,
                                                   dtype=torch.int32))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,h,n_kv,d,w,bs", [
    (5, 16, 8, 128, 8, BS), (4, 8, 1, 64, 2, BS), (4, 12, 4, 8, 3, BS),
    (10, 16, 8, 128, 32, 16),
    (32, 16, 8, 128, 64, 16),   # llama-1b's decode shape
    (6, 8, 2, 64, 8, 32)])      # d = 64, block size 32
def test_int8_kernels_match_plain_on_cuda(dtype, tol, b, h, n_kv, d, w, bs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    nb = 1 + b * w
    kq, vq, ks, vs = _q8(*_cuda_pools(gen, nb, bs, n_kv, d, torch.float32))
    tables = (1 + torch.randperm(nb - 1, device="cuda")).reshape(b, w).to(
        torch.int32)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    lengths = torch.randint(1, w * bs + 1, (b,), generator=gen,
                            device="cuda", dtype=torch.int32)
    before = paged.paged_decode_attention_q8.launches
    out = paged.paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lengths)
    torch.cuda.synchronize()
    assert paged.paged_decode_attention_q8.launches == before + 1
    ref = paged.paged_decode_attention_ref(q, kq, vq, tables, lengths, ks,
                                           vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    qc = torch.randn((b, 40, h, d), generator=gen, device="cuda").to(dtype)
    offs = torch.randint(0, w * bs, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    out = paged.paged_chunk_attention_q8(qc, kq, vq, ks, vs, tables, offs)
    torch.cuda.synchronize()
    ref = paged.paged_chunk_attention_ref(qc, kq, vq, tables, offs, ks, vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_q_kernel_is_bitwise_plain_on_cuda(dtype):
    """The quantizing scatter kernel against its plain version, bitwise on
    codes and scales, with a chunk running past its table's width and a
    padded tail marked invalid (distinct null-block slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from grove_tpu_torch.ops.kvquant import (paged_scatter_q,
                                             paged_scatter_q_ref)
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_kv, d, bs, w, c = 4, 64, 16, 4, 32
    nb = 1 + 2 * w
    tables = (1 + torch.randperm(nb - 1, device="cuda")).reshape(2, w).to(
        torch.int32)
    steps = torch.arange(c, dtype=torch.int32, device="cuda")
    pos = torch.stack([36 + steps, steps])
    valid = torch.ones((2, c), dtype=torch.bool, device="cuda")
    valid[1, 24:] = False
    k = (5 * torch.randn((2, c, n_kv, d), generator=gen,
                         device="cuda")).to(dtype)
    v = torch.randn((2, c, n_kv, d), generator=gen, device="cuda").to(dtype)
    mine = [torch.zeros((nb, bs, n_kv, d), dtype=torch.int8, device="cuda")
            for _ in range(2)] + [
        torch.zeros((nb, bs, n_kv), device="cuda") for _ in range(2)]
    ref = [t.clone() for t in mine]
    paged_scatter_q(*mine, k, v, tables, pos, valid)
    paged_scatter_q_ref(ref[0], ref[2], k, tables, pos, valid)
    paged_scatter_q_ref(ref[1], ref[3], v, tables, pos, valid)
    for a, b in zip(mine, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which,c", [("partial", 1), ("partial_chunk", 32)])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_build_matches_its_geometry_on_cuda(which, c, d):
    """The built int8 kernels' shared memory and ring depth are what
    ``q8_geometry`` says (llama-1b's heads, block size 16), and they do not
    spill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    info = paged.kernel_info(which, torch.bfloat16, d, int8_pool=True)
    geo = paged.q8_geometry(c, 16, 8, d, 16)
    assert (info["smem_bytes"], info["stages"]) == (geo["smem_bytes"],
                                                    geo["stages"])
    assert info["local_bytes"] == 0


def test_bf16_int8_rows_depend_only_on_position_on_cuda():
    """test_bf16_rows_depend_only_on_position_on_cuda over int8 pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    n_kv, g, d, w, bs, c, k0 = 8, 2, 128, 8, 16, 48, 19
    kq, vq, ks, vs = _q8(*_cuda_pools(gen, 1 + 2 * w, bs, n_kv, d,
                                      torch.float32))
    tables = (1 + torch.randperm(2 * w, device="cuda")).reshape(2, w).to(
        torch.int32)
    wide = torch.cat([tables, torch.zeros_like(tables)], 1)
    q = torch.randn((2, c, n_kv * g, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    zero = torch.zeros((2,), dtype=torch.int32, device="cuda")

    def chunk(qq, t, off):
        return paged.paged_chunk_attention_q8(qq, kq, vq, ks, vs, t, off)

    def decode(t, lens):
        return paged.paged_decode_attention_q8(q[0][:, None].contiguous(),
                                               kq, vq, ks, vs, t, lens)

    whole = chunk(q, tables, zero)
    lens = torch.arange(1, c + 1, dtype=torch.int32, device="cuda")
    dec = decode(tables[:1].expand(c, w).contiguous(), lens)
    assert torch.equal(chunk(q[:, k0:], tables, zero + k0), whole[:, k0:])
    assert torch.equal(chunk(q, wide, zero), whole)
    assert torch.equal(decode(wide[:1].expand(c, 2 * w).contiguous(), lens),
                       dec)
    assert torch.equal(dec[:, 0], whole[0])


def test_engine_int8_and_sampled_graphs_on_cuda():
    """test-tiny f32 through the paged engine on the card with int8 KV: the
    same greedy tokens as on the CPU; sampled, the same seed twice gives
    the same tokens, two seeds differ, and top_k = 1 equals greedy (graph
    replays draw fresh noise from the registered generator)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (graphs and kernels)")
    import dataclasses

    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.serving.engine import (PagedDecodeEngine,
                                                SamplerConfig)
    cfg = dataclasses.replace(CONFIGS["test-tiny"], dtype=torch.float32,
                              max_seq_len=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 19, 3, 11, 7)]

    def run(dev, **kw):
        p = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                 {n: w.to(dev) for n, w in v.items()})
             for k, v in params.items()}
        eng = PagedDecodeEngine(cfg, p, batch=4, max_len=48, block_size=8,
                                prefill_chunk=8, host_sync_interval=4,
                                kv_quant="int8", device=dev, **kw)
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=12)
        for _ in range(500):
            eng.admit_from_queue()
            if len(eng.completed) == len(prompts):
                break
            eng.step()
        eng.sync()
        return {r.rid: r.generated for r in eng.completed}

    greedy = run("cuda")
    assert greedy == run("cpu")

    def sampler(seed, top_k=8):
        return SamplerConfig(temperature=1.5, top_k=top_k, seed=seed)

    assert run("cuda", sampler=sampler(1)) == run("cuda", sampler=sampler(1))
    assert run("cuda", sampler=sampler(1)) != run("cuda", sampler=sampler(2))
    assert run("cuda", sampler=sampler(1, top_k=1)) == greedy
