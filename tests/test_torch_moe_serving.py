"""Serving a Mixtral-shaped MoE through the port's paged engine
(``make_engine(MoeConfig, params, mode="paged")``), against the
benchmark's plain float32 reference (``benchmark/reference/mixtral.py``),
which is tied here to ``models/moe.py``'s dense forward (itself held to the
JAX package's ``_moe_block`` by ``tests/test_torch_moe_ep.py``):

- the engine with chunked prefill, paged decode and the prefix cache on
  (prompts that share blocks), in f32 and bf16, every served token's logit
  against the reference's best at its position;
- the reference against ``moe.forward`` at f32;
- the expert layer's plain path (ops/moe.py) against a dense evaluation of
  every expert under the extremes: every token on one expert, experts left
  empty, one row;
- the counters of ``payload()["moe"]``; the host-sync scan over the expert
  layer;
- on the card (skipped here: the kernels have no CPU mode), the route,
  expert GEMM and combine kernels against their plain versions at
  Mixtral-8x7B's widths, each row's bits across M, and the layer under a
  CUDA graph capture; the engine on the card against the reference.
"""

import ast
import dataclasses
import inspect
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.reference import mixtral as ref_mixtral  # noqa: E402
from grove_tpu_torch.models import llama, moe  # noqa: E402
from grove_tpu_torch.ops import moe as moe_ops  # noqa: E402
from grove_tpu_torch.ops.w8a16 import dense_matmul  # noqa: E402
from grove_tpu_torch.serving.engine import make_engine  # noqa: E402
from test_torch_host_sync import host_syncs  # noqa: E402

torch.set_num_threads(1)

CFG = dataclasses.replace(moe.MOE_CONFIGS["moe-test-tiny"],
                          dtype=torch.float32, max_seq_len=128)
# The card's kernels take K % 64 == 0 and the router's dense GEMM N % 8 ==
# 0: a tiny model whose expert width and expert count are.
CARD_CFG = dataclasses.replace(CFG, d_ff=128, n_experts=8,
                               dtype=torch.bfloat16)
GEOM = dict(batch=4, max_len=96, block_size=8, prefill_chunk=16,
            host_sync_interval=4, prefix_cache=True, mode="paged")
MAX_NEW = 8
# f32: the engine and the reference compute one function in f32 in other
# orders, so a served token's logit lies within ~1e-6 of the best; 1e-4 of
# the logits' scale leaves room. bf16: the tiny benchmark cells' limit on
# the mean gap (benchmark/tests/tiny.py), for the same reason as there: a
# bf16 model's rounding moves logits by ~1e-3, and on random weights the top
# two of a small vocabulary often lie that close.
F32_GAP = 1e-4
BF16_MEAN_GAP = 1e-2
# On the card the bf16 model rounds at other places than on the CPU (the
# GEMMs' split sums, the paged kernels), and over 40 served tokens of a
# 256-word vocabulary one near-tie decides the mean: one token off its best
# read 0.014 there. A fault in the expert layer (an expert dropped, weights
# not renormalised) moves every routed row and reads far above.
BF16_CARD_MEAN_GAP = 5e-2


def params_for(cfg, seed: int, device="cpu"):
    """Random MoE params with norms away from 1 (a dropped norm weight
    shows), in the config's type."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = moe.init_params(dataclasses.replace(cfg, dtype=torch.float32), g,
                        device)
    lay = p["layers"]
    for name in ("attn_norm", "mlp_norm"):
        lay[name] = 1 + 0.1 * torch.randn(lay[name].shape, generator=g,
                                          device=device)
    p["final_norm"] = 1 + 0.1 * torch.randn(p["final_norm"].shape,
                                            generator=g, device=device)
    return _cast(p, cfg.dtype)


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def ref_config(cfg) -> ref_mixtral.Config:
    return ref_mixtral.Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        n_experts=cfg.n_experts, experts_per_token=cfg.experts_per_token)


def prompts():
    """Five prompts of 5 to 41 tokens, the first and the third sharing
    their first 24 (three whole 8-token blocks: the third, served after the
    first, hits the prefix cache), most longer than one 16-token chunk."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, CFG.vocab_size, size=24)
    a, b = (np.concatenate([shared, rng.integers(0, CFG.vocab_size,
                                                 size=n)]) for n in (9, 17))
    c, d, e = (rng.integers(0, CFG.vocab_size, size=n) for n in (5, 41, 30))
    return [p.astype(np.int32) for p in (a, c, b, d, e)]


def serve(cfg, params, device="cpu"):
    """Serve ``prompts()`` two at a time (the second pair hits the cached
    prefix); returns the finished requests by submission order, and the
    engine."""
    eng = make_engine(cfg, params, device=device, **GEOM)
    eng.warmup()
    ps = prompts()
    for i in range(0, len(ps), 2):
        for p in ps[i:i + 2]:
            eng.submit(p, max_new_tokens=MAX_NEW)
        want = min(i + 2, len(ps))
        for _ in range(5000):
            eng.admit_from_queue()
            if len(eng.completed) >= want:
                break
            eng.step()
        eng.sync()
    assert len(eng.completed) == len(ps)
    return sorted(eng.completed, key=lambda r: r.rid), eng


def gaps(cfg, params, reqs):
    """Each served token's gap below the reference's best logit, and the
    logits' scale (largest |logit|), over all requests."""
    rcfg = ref_config(cfg)
    p32 = _cast(params, torch.float32)
    out, scale = [], 0.0
    for req, prompt in zip(reqs, prompts()):
        seq = torch.as_tensor(list(prompt) + req.generated[:-1],
                              dtype=torch.long)
        ref = ref_mixtral.logits(rcfg, p32, seq, len(prompt) - 1)
        toks = torch.as_tensor(req.generated)
        out.append(ref.max(-1).values - ref.gather(1, toks[:, None])[:, 0])
        scale = max(scale, float(ref.abs().max()))
    return torch.cat(out), scale


@pytest.fixture(scope="module")
def served_f32():
    params = params_for(CFG, 11)
    reqs, eng = serve(CFG, params)
    return params, reqs, eng


def test_engine_serves_the_reference_in_f32(served_f32):
    params, reqs, eng = served_f32
    g, scale = gaps(CFG, params, reqs)
    assert all(len(r.generated) == MAX_NEW for r in reqs)
    assert float(g.max()) <= F32_GAP * scale
    # The paths the test means to cover ran: chunks (a 41-token prompt
    # takes three), decode steps, prefix-cache hits.
    assert eng.chunks > len(reqs) and eng.steps > 0
    assert eng.prefix_stats()["tokens_matched_total"] >= 24


def test_engine_serves_the_reference_in_bf16():
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    params = params_for(cfg, 12)
    reqs, _ = serve(cfg, params)
    g, _ = gaps(cfg, params, reqs)
    assert float(g.mean()) <= BF16_MEAN_GAP


def test_expert_counters(served_f32):
    _, reqs, eng = served_f32
    got = eng.payload()["moe"]
    E, k, L = CFG.n_experts, CFG.experts_per_token, CFG.n_layers
    assert got["experts"] == E
    # Every dispatch (warm-up's too) routes its rows through each layer.
    assert got["dispatches"] % L == 0 and got["dispatches"] >= \
        L * (eng.steps + eng.chunks)
    assert sum(got["assignments"]) % k == 0
    assert got["dispatches"] <= got["experts_touched"] <= \
        E * got["dispatches"]


def test_counters_off_with_the_observatory():
    eng = make_engine(CFG, params_for(CFG, 13), device="cpu", xprof=False,
                      **GEOM)
    assert eng.payload()["moe"] is None


def test_reference_matches_the_port_moe_forward():
    params = params_for(CFG, 14)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, CFG.vocab_size, size=(1, 40)))
    with torch.no_grad():
        want = moe.forward(CFG, params, tokens)[0]
    got = ref_mixtral.logits(ref_config(CFG), params, tokens[0], 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def dense_experts(h, logits, ws, k):
    """Every expert on every row, masked by the top-k softmax weights:
    ``_moe_block``'s evaluation, in f32."""
    idx, w = moe_ops.route_ref(logits, k)
    E = ws[0].shape[0]
    mask = torch.zeros(h.shape[0], E).scatter_(1, idx, w)
    hf = h.float()
    out = torch.zeros(h.shape[0], ws[2].shape[2])
    for e in range(E):
        y = (F.silu(hf @ ws[0][e].float()) * (hf @ ws[1][e].float())) \
            @ ws[2][e].float()
        out += mask[:, e:e + 1] * y
    return out


def expert_weights(E=4, d=64, ff=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) * s[1] ** -0.5
            for s in ((E, d, ff), (E, d, ff), (E, ff, d))]


def pipeline(h, logits, ws, k, stats=None):
    x, offsets, slot, w = moe_ops.moe_route(logits, h, k, stats)
    gate, up = moe_ops.expert_matmul_group(x, offsets, ws[:2], h.shape[0])
    y = moe_ops.expert_matmul(F.silu(gate) * up, offsets, ws[2],
                              h.shape[0])
    return moe_ops.moe_combine(y, slot, w, k), offsets


@pytest.mark.parametrize("case", ["one_expert", "empty_experts", "one_row",
                                  "router"])
def test_expert_layer_plain_path_extremes(case):
    ws = expert_weights()
    g = torch.Generator().manual_seed(7)
    M = 1 if case == "one_row" else 37
    h = torch.randn(M, 64, generator=g)
    logits = torch.randn(M, 4, generator=g)
    if case == "one_expert":
        logits[:, 2] += 50.0                 # every first choice expert 2
    elif case == "empty_experts":
        logits[:, :2] -= 50.0                # experts 0 and 1 get nothing
    stats = torch.zeros(6, dtype=torch.int64)
    got, offsets = pipeline(h, logits, ws, 2, stats)
    want = dense_experts(h, logits, ws, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    counts = (offsets[1:] - offsets[:-1]).tolist()
    assert sum(counts) == 2 * M and stats[:4].tolist() == counts
    assert stats[4] == sum(c > 0 for c in counts) and stats[5] == 1
    if case == "one_expert":
        assert counts[2] == M
    if case == "empty_experts":
        assert counts[:2] == [0, 0]
    if case == "router":  # the layer itself, its router's f32 logits
        router = torch.randn(64, 4, generator=g) * 0.125
        layer = moe_ops.expert_layer(h, router, *ws, 2)
        assert torch.equal(layer, pipeline(h, h @ router, ws, 2)[0])


def test_a_rows_output_does_not_follow_the_rows_beside_it():
    """A row alone and the same row among 20 give one output within a bf16
    rounding on the plain path (CPU matmuls may split sums by M; the card's
    rows are held bitwise in the CUDA tests)."""
    ws = [w.to(torch.bfloat16) for w in expert_weights()]
    g = torch.Generator().manual_seed(8)
    h = torch.randn(20, 64, generator=g).to(torch.bfloat16)
    router = (torch.randn(64, 4, generator=g) * 0.125).to(torch.bfloat16)
    whole = moe_ops.expert_layer(h, router, *ws, 2)
    for i in (0, 7, 19):
        one = moe_ops.expert_layer(h[i:i + 1], router, *ws, 2)
        assert float((one[0].float() - whole[i].float()).abs().max()) <= \
            1e-2 * float(whole.float().abs().max())


def test_expert_layer_has_no_host_sync():
    """The expert layer's wrappers and the decoder's slot for it wait for
    nothing on the device (tests/test_torch_host_sync.py's rule)."""
    def fn(module, name):
        tree = ast.parse(textwrap.dedent(inspect.getsource(module)))
        return next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                    and n.name == name)
    for name in ("expert_layer", "moe_route", "expert_matmul_group",
                 "expert_matmul", "moe_combine", "expert_build", "_plan",
                 "_device_only", "_stream", "_raise"):
        assert host_syncs(fn(moe_ops, name)) == [], name
    assert host_syncs(fn(llama, "_ffn")) == []


def test_moe_config_counts_its_experts():
    c = moe.MOE_CONFIGS["mixtral-8x7b"]
    d, ff, E = c.d_model, c.d_ff, c.n_experts
    dense = llama.LlamaConfig(**{f.name: getattr(c, f.name)
                                 for f in dataclasses.fields(
                                     llama.LlamaConfig)})
    extra = c.n_layers * ((E - 1) * 3 * d * ff + d * E)
    assert c.params_bytes == dense.params_bytes + 2 * extra
    assert c.mlp_params == 2 * 3 * d * ff + d * E


# ---- on the card ----

MIXTRAL = (4096, 14336, 8, 2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def mixtral_layer():
    _card()
    d, ff, E, _ = MIXTRAL
    g = torch.Generator(device="cuda").manual_seed(21)

    def w(shape, fan_in):
        return (torch.randn(shape, generator=g, device="cuda")
                * fan_in ** -0.5).to(torch.bfloat16)
    ws = [w((E, d, ff), d), w((E, d, ff), d), w((E, ff, d), ff)]
    router = w((d, E), d)
    h = torch.randn(256, d, generator=g, device="cuda").to(torch.bfloat16)
    return ws, router, h


@pytest.mark.parametrize("M", [1, 16, 64, 256])
def test_expert_kernels_match_plain_on_cuda(mixtral_layer, M):
    ws, router, h = mixtral_layer
    k = MIXTRAL[3]
    logits = dense_matmul(h[:M], router, torch.float32)
    got = moe_ops.moe_route(logits, h[:M], k)
    want = moe_ops.moe_route_ref(logits, h[:M], k)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=1e-7)
    x, offsets, slot, w = got
    gate, up = moe_ops.expert_matmul_group(x, offsets, ws[:2], M)
    for out, ref in ((gate, moe_ops.expert_matmul_ref(x, offsets, ws[:1])),
                     (up, moe_ops.expert_matmul_ref(x, offsets, ws[1:2]))):
        scale = float(ref[0].float().abs().max())
        torch.testing.assert_close(out.float(), ref[0].float(), rtol=1e-2,
                                   atol=1e-2 * scale)
    y = moe_ops.expert_matmul(F.silu(gate) * up, offsets, ws[2], M)
    assert torch.equal(moe_ops.moe_combine(y, slot, w, k),
                       moe_ops.moe_combine_ref(y, slot, w, k))


def test_expert_rows_keep_their_bits_across_m_on_cuda(mixtral_layer):
    ws, router, h = mixtral_layer
    whole = moe_ops.expert_layer(h, router, *ws, MIXTRAL[3])
    for M in (1, 16, 64, 255):
        assert torch.equal(moe_ops.expert_layer(h[:M], router, *ws,
                                                MIXTRAL[3]), whole[:M])


def test_uneven_groups_on_cuda(mixtral_layer):
    ws, router, h = mixtral_layer
    k = MIXTRAL[3]
    logits = torch.randn(256, 8, device="cuda")
    logits[:, 5] += 100.0             # every first choice expert 5: passes
    logits[:, :2] -= 100.0            # experts 0 and 1 empty
    got, offsets = pipeline(h, logits, ws, k)
    x, off, slot, w = moe_ops.moe_route_ref(logits, h, k)
    gate, up = moe_ops.expert_matmul_ref(x, off, ws[:2])
    y = moe_ops.expert_matmul_ref(F.silu(gate) * up, off, ws[2:])[0]
    want = moe_ops.moe_combine_ref(y, slot, w, k)
    assert (offsets[6] - offsets[5]).item() == 256
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * float(want.float().abs().max()))


def test_expert_layer_under_graph_capture_on_cuda(mixtral_layer):
    ws, router, h = mixtral_layer
    k, E = MIXTRAL[3], MIXTRAL[2]
    static = h[:64].clone()
    stats = torch.zeros(E + 2, dtype=torch.int64, device="cuda")
    moe_ops.expert_layer(static, router, *ws, k, stats)
    torch.cuda.synchronize()
    before = stats.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe_ops.expert_layer(static, router, *ws, k, stats)
    static.copy_(h[100:164])
    graph.replay()
    assert torch.equal(out, moe_ops.expert_layer(h[100:164], router, *ws,
                                                 k))
    moved = (stats - before).tolist()
    assert moved[E + 1] == 1 and sum(moved[:E]) == 64 * k


def test_engine_serves_the_reference_on_cuda():
    _card()
    params = params_for(CARD_CFG, 15, "cuda")
    launches = moe_ops.expert_matmul.launches
    reqs, eng = serve(CARD_CFG, params, "cuda")
    assert eng.graphs_captured > 0
    assert moe_ops.expert_matmul.launches > launches
    g, _ = gaps(CARD_CFG, _to_cpu(params), reqs)
    assert float(g.mean()) <= BF16_CARD_MEAN_GAP


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}
