"""Speculative decoding's kernel shapes without the JAX package: on the CPU
the verify chunk's and the spec step's launch accounting and the rows a
capped step leaves alone; on a CUDA card the verify chunk through the
kernels against its plain run, a decode row against the verify chunk's row
at the same position (bitwise, model-dtype and int8 pools, at the serving
shape b = 32, c = 4), and the spec engine's captured graphs against the
plain engine's tokens.

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_spec_kernels.py``).
Tolerances: f32 1e-4 (summation order); the row property and the tokens
are bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from grove_tpu_torch.models import llama
from grove_tpu_torch.ops import kvquant, paged, w8a16
from grove_tpu_torch.serving.engine import PagedDecodeEngine

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

CFG = dataclasses.replace(llama.CONFIGS["test-tiny"], dtype=torch.float32,
                          max_seq_len=64)
WRAPPERS = (paged.paged_decode_attention, paged.paged_chunk_attention,
            paged.paged_decode_attention_q8, paged.paged_chunk_attention_q8,
            kvquant.paged_rope_scatter, kvquant.paged_rope_scatter_q,
            kvquant.paged_scatter, kvquant.paged_scatter_q,
            w8a16.w8a16_matmul)


def _inputs(cfg, device, int8: bool, seed: int = 0):
    """Pools (int8 ones quantized as the write does it), tables, lengths
    and limits of 4 sequences (one capped mid-chunk, one padded), and a
    [4, 4] chunk of tokens."""
    gen = torch.Generator().manual_seed(seed)
    nb, bs = 17, 4
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.head_dim)
    k, v = (torch.randn(shape, generator=gen) for _ in range(2))
    if int8:
        (k, ks), (v, vs) = kvquant.quantize_rows(k), kvquant.quantize_rows(v)
        pools = [k, v, ks, vs]
    else:
        pools = [k.to(cfg.dtype), v.to(cfg.dtype)]
    tables = torch.tensor([[3, 5, 7, 0], [2, 4, 9, 11], [0, 0, 0, 0],
                           [6, 8, 10, 12]], dtype=torch.int32)
    lengths = torch.tensor([6, 10, 0, 13], dtype=torch.int32)
    limit = torch.tensor([8, 16, 0, 16], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (4, 4), generator=gen,
                         dtype=torch.int32)
    return [t.to(device) for t in (*pools, tables, lengths, limit, toks)]


def _scales(pools):
    return dict(k_scale=pools[2], v_scale=pools[3]) if len(pools) == 4 \
        else {}


@pytest.mark.parametrize("int8", [False, True])
def test_cpu_verify_and_spec_count_no_launch(int8):
    """The plain route counts no kernel launch, the verify chunk returns
    [b, c, vocab] f32 logits, and the spec step's outputs are int32."""
    params = llama.init_params(CFG, torch.Generator().manual_seed(1),
                               device="cpu")
    *pools, tables, lengths, limit, toks = _inputs(CFG, "cpu", int8)
    before = [w.launches for w in WRAPPERS]
    logits = llama.verify_chunk_paged(CFG, params, toks, pools[0], pools[1],
                                      tables, lengths, limit=limit,
                                      **_scales(pools))
    out = llama.spec_step_paged(CFG, CFG, params, params, toks[:, 0],
                                pools[0], pools[1], None, None, tables,
                                lengths, limit, 3, self_draft=True,
                                **_scales(pools))
    assert [w.launches for w in WRAPPERS] == before
    assert logits.shape == (4, 4, CFG.vocab_size)
    assert logits.dtype == torch.float32
    assert [tuple(t.shape) for t in out] == [(4, 4), (4,), (4,)]
    assert all(t.dtype == torch.int32 for t in out)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.parametrize("int8", [False, True])
def test_verify_chunk_kernels_match_plain_on_cuda(int8):
    """test-tiny f32: the verify chunk through the kernels (the fused write,
    the chunk attention, one launch each per layer) against its plain run
    on the CPU: logits of the rows under their limits and the pools (the
    null block aside) within 1e-4, int8 codes within one step."""
    _cuda_or_skip()
    params = llama.init_params(CFG, torch.Generator().manual_seed(2),
                               device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                 {n: w.to(dev) for n, w in v.items()})
             for k, v in params.items()}
        *pools, tables, lengths, limit, toks = _inputs(CFG, dev, int8)
        for w in WRAPPERS:
            w.launches = 0
        logits = llama.verify_chunk_paged(CFG, p, toks, pools[0], pools[1],
                                          tables, lengths, limit=limit,
                                          **_scales(pools))
        counts = {w.__name__: w.launches for w in WRAPPERS}
        outs[dev] = [logits.cpu()] + [t.cpu() for t in pools]
    L = CFG.n_layers
    want = {w.__name__: 0 for w in WRAPPERS}
    want["paged_chunk_attention_q8" if int8 else "paged_chunk_attention"] = L
    want["paged_rope_scatter_q" if int8 else "paged_rope_scatter"] = L
    assert counts == want
    valid = (lengths[:, None] + torch.arange(4, device="cuda")[None]
             < limit[:, None]).cpu()
    torch.testing.assert_close(outs["cuda"][0][valid], outs["cpu"][0][valid],
                               rtol=1e-4, atol=1e-4)
    for got, ref in zip(outs["cuda"][1:], outs["cpu"][1:]):
        got, ref = got[:, 1:], ref[:, 1:]
        if got.dtype == torch.int8:
            assert (got.int() - ref.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_rows_equal_verify_rows_on_cuda(int8):
    """bf16, llama-1b's heads, the spec shape (b = 32, c = 4, lengths
    512..1,020, W = 64): the decode row at length p + 1 equals the verify
    chunk's row at position p, bitwise, over a bf16 and an int8 pool. What
    spec == greedy rests on for attention."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, c, n_kv, g, d, W, bs = 32, 4, 8, 2, 128, 64, 16
    nb = 1 + b * W
    k = torch.randn((nb, bs, n_kv, d), generator=gen, device="cuda")
    v = torch.randn((nb, bs, n_kv, d), generator=gen, device="cuda")
    tables = (1 + torch.randperm(nb - 1, device="cuda")).reshape(b, W).to(
        torch.int32)
    lengths = torch.randint(512, W * bs - c + 1, (b,), generator=gen,
                            device="cuda", dtype=torch.int32)
    q = torch.randn((b, c, n_kv * g, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    if int8:
        (kq, ks), (vq, vs) = kvquant.quantize_rows(k), kvquant.quantize_rows(v)

        def chunk(qq, off):
            return paged.paged_chunk_attention_q8(qq, kq, vq, ks, vs, tables,
                                                  off)

        def decode(qq, lens):
            return paged.paged_decode_attention_q8(qq, kq, vq, ks, vs,
                                                   tables, lens)
    else:
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)

        def chunk(qq, off):
            return paged.paged_chunk_attention(qq, kb, vb, tables, off)

        def decode(qq, lens):
            return paged.paged_decode_attention(qq, kb, vb, tables, lens)
    rows = chunk(q, lengths)
    for i in range(c):
        dec = decode(q[:, i:i + 1].contiguous(), lengths + i + 1)
        assert torch.equal(dec[:, 0], rows[:, i]), i


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
@pytest.mark.parametrize("draft", ["self", "tiny"])
def test_spec_engine_graphs_equal_plain_on_cuda(kv_quant, draft):
    """test-tiny bf16 with int8 weights on the card: the spec engine (one
    captured graph per spec bucket and per chunk width, none plain) gives
    the plain engine's greedy tokens per request."""
    _cuda_or_skip()
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    params = {k: (v.cuda() if isinstance(v, torch.Tensor) else
                  {n: w.cuda() for n, w in v.items()})
              for k, v in params.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 19, 3, 11, 7)]
    out = {}
    for spec in (False, True):
        kw = dict(spec_decode=True, spec_k=3,
                  draft_params="self" if draft == "self" else None) \
            if spec else {}
        eng = PagedDecodeEngine(cfg, params, batch=4, max_len=48,
                                block_size=8, prefill_chunk=8,
                                host_sync_interval=4, quant="int8",
                                kv_quant=kv_quant, device="cuda", **kw)
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=9)
        for _ in range(500):
            eng.admit_from_queue()
            if len(eng.completed) == len(prompts):
                break
            eng.step()
        eng.sync()
        out[spec] = {r.rid: r.generated for r in eng.completed}
        if spec:
            assert not eng._steps
            assert eng.graphs_captured == \
                len(eng._specs) + len(eng._prefills) > 0
    assert out[True] == out[False]


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
@pytest.mark.parametrize("draft", ["self", "tiny"])
def test_spec_equals_plain_with_bf16_weights_on_cuda(kv_quant, draft):
    """test-tiny bf16 with the engine's default weights (no quantization)
    on the card: every projection, the target's and the draft's, goes
    through the dense GEMM build (rows independent of M), and the spec
    engine gives the plain engine's greedy tokens per request."""
    _cuda_or_skip()
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    params = llama.init_params(cfg, torch.Generator().manual_seed(5),
                               device="cpu")
    params = {k: (v.cuda() if isinstance(v, torch.Tensor) else
                  {n: w.cuda() for n, w in v.items()})
              for k, v in params.items()}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (6, 21, 2, 13, 9)]
    out = {}
    for spec in (False, True):
        kw = dict(spec_decode=True, spec_k=3,
                  draft_params="self" if draft == "self" else None) \
            if spec else {}
        eng = PagedDecodeEngine(cfg, params, batch=4, max_len=48,
                                block_size=8, prefill_chunk=8,
                                host_sync_interval=4, kv_quant=kv_quant,
                                device="cuda", **kw)
        before = w8a16.dense_matmul.launches
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=9)
        for _ in range(500):
            eng.admit_from_queue()
            if len(eng.completed) == len(prompts):
                break
            eng.step()
        eng.sync()
        assert w8a16.dense_matmul.launches > before
        out[spec] = {r.rid: r.generated for r in eng.completed}
    assert out[True] == out[False]
