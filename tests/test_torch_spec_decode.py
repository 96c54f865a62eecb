"""Speculative decoding in the port against the JAX package's: the verify
chunk and the fused spec step on the same weights (converted key for key),
pools, tables and tokens; the spec engine against the JAX spec engine
(tokens keyed by request id and ``spec_stats()``); mirrors of
tests/test_spec_decode.py's spec tests with the port's engines on the CPU;
and spec == greedy bitwise inside torch.

f32 on test-tiny is held to rtol = atol = 1e-4 (the frameworks order their
sums differently); tokens, committed counts and lengths exactly; int8 codes
bitwise and int8 scales within 1e-6 relative (the K/V rows they quantize
come out of f32 products summed in another order, so a row's absmax may
move by an ulp: tests/test_torch_paged_kvquant.py holds the quantizer
itself bitwise on equal rows).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.serving import engine as jengine
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import engine as tengine

# Without the repo's conftest JAX could take a GPU.
jax.config.update("jax_platforms", "cpu")
# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
NB, BS = 16, 4
TABLES = np.array([[3, 5, 7, 0], [2, 4, 9, 11], [0, 0, 0, 0],
                   [6, 8, 10, 12]], np.int32)
# lengths, limits: a row capped inside the chunk (its m clamps at 1), a
# roomy row, a padded row (limit 0) and a row whose cap is its table's end.
LENGTHS = np.array([6, 10, 0, 13], np.int32)
LIMITS = np.array([8, 16, 0, 16], np.int32)
GEOM = dict(batch=4, max_len=48, block_size=8, prefill_chunk=8,
            host_sync_interval=4)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def draft():
    """JAX's derived tiny draft (its draft_config, PRNGKey(1)), and the same
    weights converted: what both engines take as ``(cfg, params)``."""
    jd = jllama.draft_config(J_CFG)
    jdp = jllama.init_params(jd, jax.random.PRNGKey(1))
    return ((jd, jdp), (tllama.draft_config(T_CFG),
                        params_from_numpy(jax.tree.map(np.asarray, jdp),
                                          device="cpu")))


def _pools(seed, cfg, int8: bool):
    """Random pools for ``cfg`` as numpy: f32, or int8 codes with positive
    f32 scales."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.head_dim)
    if not int8:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
    return ([rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(2)]
            + [rng.uniform(1e-3, 0.05, shape[:-1]).astype(np.float32)
               for _ in range(2)])


def _check_pools(got, want, codes_atol=0, scales_rtol=1e-6):
    """Every block but the null block (where rerouted rows collide):
    f32 pools within 1e-4, int8 codes within ``codes_atol``, scales within
    ``scales_rtol``."""
    for t, j in zip(got, want):
        t, j = t.numpy()[:, 1:], np.asarray(j)[:, 1:]
        if t.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= codes_atol, diff.max()
            assert (diff > 0).mean() <= 1e-3
        elif len(got) == 4 and t.ndim == 4:
            np.testing.assert_allclose(t, j, rtol=scales_rtol, atol=0)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def _scales(pools):
    return dict(k_scale=pools[2], v_scale=pools[3]) if len(pools) == 4 \
        else {}


def test_draft_config_matches_jax():
    for name in ("test-tiny", "llama-1b", "llama-8b"):
        j = jllama.draft_config(jllama.CONFIGS[name])
        t = tllama.draft_config(tllama.CONFIGS[name])
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "head_dim", "max_seq_len"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    d = tllama.draft_config(tllama.CONFIGS["llama-1b"])
    assert (d.d_model, d.n_layers, d.n_heads, d.n_kv_heads, d.head_dim,
            d.d_ff) == (512, 4, 4, 2, 128, 1408)


@pytest.mark.parametrize("int8", [False, True])
def test_verify_chunk_matches_jax(params, int8):
    """A 4-row verify chunk at per-sequence offsets with rows capped by
    their limits: the rows under their limit give JAX's logits (a capped
    row's K/V went to the null block, so its logits are nobody's), and the
    pools hold JAX's rows."""
    jp, tp = params
    pools = _pools(1, J_CFG, int8)
    toks = np.random.default_rng(2).integers(0, 256, (4, 4)).astype(np.int32)
    fn = jax.jit(functools.partial(jllama.verify_chunk_paged, J_CFG))
    jpools = [jnp.asarray(x) for x in pools]
    out = fn(jp, jnp.asarray(toks), jpools[0], jpools[1],
             jnp.asarray(TABLES), jnp.asarray(LENGTHS),
             limit=jnp.asarray(LIMITS), **_scales(jpools))
    tpools = [torch.from_numpy(x.copy()) for x in pools]
    tl = tllama.verify_chunk_paged(
        T_CFG, tp, torch.from_numpy(toks), tpools[0], tpools[1],
        torch.from_numpy(TABLES), torch.from_numpy(LENGTHS),
        limit=torch.from_numpy(LIMITS), **_scales(tpools))
    assert tl.shape == (4, 4, T_CFG.vocab_size) and tl.dtype == torch.float32
    valid = LENGTHS[:, None] + np.arange(4)[None] < LIMITS[:, None]
    assert valid.sum() == 9
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(out[0])[valid],
                               rtol=1e-4, atol=1e-4)
    _check_pools(tpools, out[1:])
    # Without logits: the same pools, and nothing returned.
    again = [torch.from_numpy(x.copy()) for x in pools]
    assert tllama.verify_chunk_paged(
        T_CFG, tp, torch.from_numpy(toks), again[0], again[1],
        torch.from_numpy(TABLES), torch.from_numpy(LENGTHS),
        limit=torch.from_numpy(LIMITS), logits=False,
        **_scales(again)) is None
    for a, b in zip(again, tpools):
        assert torch.equal(a, b)


def test_decode_step_limit_reroutes_only_capped_rows(params):
    """``limit`` sends the rows at or past it to the null block and leaves
    every other row's write and the logits as a step without it."""
    _, tp = params
    k, v = _pools(3, J_CFG, False)
    toks = torch.tensor([3, 77, 0, 9], dtype=torch.int32)
    lengths = torch.tensor([8, 10, 0, 13], dtype=torch.int32)
    outs = []
    for limit in (None, torch.tensor([8, 16, 0, 16], dtype=torch.int32)):
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        logits = tllama.decode_step_paged(
            T_CFG, tp, toks, tk, tv, torch.from_numpy(TABLES), lengths,
            limit=limit)
        outs.append((logits, tk, tv))
    (l0, k0, _), (l1, k1, _) = outs
    torch.testing.assert_close(l1[[1, 3]], l0[[1, 3]], rtol=0, atol=0)
    # Row 0 writes position 8: block 7 slot 0 without the cap, not with it.
    assert not torch.equal(k0[:, 7, 0], k1[:, 7, 0])
    assert torch.equal(k1[:, 7, 0], torch.from_numpy(k[:, 7, 0]))
    assert torch.equal(k0[:, 1:7], k1[:, 1:7])
    assert torch.equal(k0[:, 8:], k1[:, 8:])


SPEC_CASES = {          # draft, int8 target pool
    "self_f32": ("self", False),
    "self_int8": ("self", True),
    "tiny_f32": ("tiny", False),
    "tiny_int8_target": ("tiny", True),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_step_matches_jax(params, draft, case):
    """The fused step against JAX's: out_tokens, next_tokens and
    new_lengths exactly, the pools as in the verify test. The batch holds
    a row whose commit clamps at its limit (the bonus gathered at the
    clamp), a padded row with limit 0 and a row capped at its table's
    end."""
    jp, tp = params
    (jd, jdp), (td, tdp) = draft
    which, int8 = SPEC_CASES[case]
    k = 3
    pools = _pools(4, J_CFG, int8)
    dpools = [] if which == "self" else _pools(5, jd, False)
    toks = np.array([11, 22, 0, 33], np.int32)
    jpools = [jnp.asarray(x) for x in pools]
    jdpools = [jnp.asarray(x) for x in dpools] or [None, None]
    self_draft = which == "self"
    fn = jax.jit(functools.partial(
        jllama.spec_step_paged, J_CFG, J_CFG if self_draft else jd,
        spec_k=k, self_draft=self_draft))
    out = fn(jp, jp if self_draft else jdp, jnp.asarray(toks), jpools[0],
             jpools[1], jdpools[0], jdpools[1], jnp.asarray(TABLES),
             jnp.asarray(LENGTHS), jnp.asarray(LIMITS), **_scales(jpools))
    tpools = [torch.from_numpy(x.copy()) for x in pools]
    tdpools = [torch.from_numpy(x.copy()) for x in dpools] or [None, None]
    got = tllama.spec_step_paged(
        T_CFG, T_CFG if self_draft else td, tp, tp if self_draft else tdp,
        torch.from_numpy(toks), tpools[0], tpools[1], tdpools[0],
        tdpools[1], torch.from_numpy(TABLES), torch.from_numpy(LENGTHS),
        torch.from_numpy(LIMITS), k, self_draft=self_draft,
        **_scales(tpools))
    for g, w in zip(got, out[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out_tokens, _, new_lengths = (x.numpy() for x in got)
    # The padded row stays at length 0 with nothing past its bonus; the
    # capped rows stay inside their limits.
    assert new_lengths[2] == 0 and (out_tokens[2, 1:] == -1).all()
    assert new_lengths[0] <= 8 and new_lengths[3] <= 16
    if self_draft:
        # Full acceptance, clamped: row 0 commits m + 1 = 2 tokens
        # (m = limit - length - 1 = 1), row 3 three, row 1 k + 1.
        np.testing.assert_array_equal((out_tokens >= 0).sum(1),
                                      [2, 4, 1, 3])
        np.testing.assert_array_equal(new_lengths, [8, 14, 0, 16])
    # The rows written here come out of deeper f32 computations (each draft
    # step's tokens feed the next) than the verify test's: a row's absmax
    # may move by a few ulps more, and a code whose x / scale lies within
    # that of a .5 boundary by one.
    _check_pools(tpools, out[3:3 + len(pools)], codes_atol=1,
                 scales_rtol=1e-5)
    if not self_draft:
        _check_pools(tdpools, out[3 + len(pools):])


# ---- the engine against the JAX spec engine ----

def _prompts(seed: int, n: int = 5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(k)).astype(np.int32)
            for k in rng.integers(3, 20, size=n)]


def drive(eng, want: int, max_iters: int = 3000) -> None:
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        if eng._sched.live:
            eng.step()
    eng.sync()
    assert len(eng.completed) >= want, (len(eng.completed), want)


def _serve(eng, prompts, max_new=6):
    want = len(eng.completed) + len(prompts)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    drive(eng, want)
    eng._alloc.check()
    assert eng._alloc.used_blocks == 0
    return eng


def _tokens_by_rid(eng):
    return {r.rid: list(r.generated) for r in eng.completed}


ENGINE_CASES = {        # draft ("self" or JAX's tiny draft), kv_quant
    "self_f32": ("self", "off"),
    "self_int8": ("self", "int8"),
    "tiny_f32": ("tiny", "off"),
}


@pytest.fixture(scope="module")
def jax_spec_runs(params, draft):
    jp, _ = params
    out = {}
    for name, (which, kvq) in ENGINE_CASES.items():
        dp = "self" if which == "self" else draft[0]
        eng = jengine.PagedDecodeEngine(
            J_CFG, jp, xprof=False, reqtrace=False, spec_decode=True,
            spec_k=3, draft_params=dp, kv_quant=kvq, **GEOM)
        _serve(eng, _prompts(60))
        out[name] = (_tokens_by_rid(eng), eng.spec_stats(), eng.steps)
    return out


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_spec_engine_matches_jax(params, draft, jax_spec_runs, case):
    """Tokens keyed by request id, ``spec_stats()`` (per bucket too) and
    the dispatch count equal the JAX spec engine's."""
    _, tp = params
    which, kvq = ENGINE_CASES[case]
    dp = "self" if which == "self" else draft[1]
    eng = _serve(tengine.PagedDecodeEngine(
        T_CFG, tp, device="cpu", spec_decode=True, spec_k=3,
        draft_params=dp, kv_quant=kvq, **GEOM), _prompts(60))
    tokens, stats, steps = jax_spec_runs[case]
    assert _tokens_by_rid(eng) == tokens
    assert eng.spec_stats() == stats
    assert eng.steps == steps
    assert all(len(t) == 6 for t in tokens.values())


# ---- mirrors of tests/test_spec_decode.py ----

def _run(tp, prompts, max_new=6, **kw):
    return _serve(tengine.PagedDecodeEngine(
        T_CFG, tp, device="cpu", **{**GEOM, **kw}), prompts, max_new)


def test_spec_parity_tiny_draft(params):
    _, tp = params
    prompts = _prompts(50)
    base = _run(tp, prompts)
    spec = _run(tp, prompts, spec_decode=True, spec_k=3)
    assert _tokens_by_rid(spec) == _tokens_by_rid(base)
    st = spec.spec_stats()
    assert st["dispatches"] > 0
    assert st["acceptance_rate"] < 1.0
    assert spec.draft_kv is not None and not spec.draft_kv.quantized


def test_spec_parity_self_draft_full_acceptance(params):
    _, tp = params
    prompts = _prompts(51)
    base = _run(tp, prompts)
    spec = _run(tp, prompts, spec_decode=True, spec_k=3,
                draft_params="self")
    assert _tokens_by_rid(spec) == _tokens_by_rid(base)
    st = spec.spec_stats()
    assert st["acceptance_rate"] == 1.0, st
    assert st["accepted_per_dispatch"] == 4.0, st
    assert spec.draft_kv is None
    assert spec.steps < base.steps


def test_spec_parity_under_preemption(params):
    _, tp = params
    prompts = _prompts(52, n=8)
    geom = dict(batch=8, max_len=40, block_size=4, prefill_chunk=4,
                host_sync_interval=2)
    base = _run(tp, prompts, max_new=10, num_blocks=96, **geom)
    tight = _run(tp, prompts, max_new=10, num_blocks=11,
                 **{**geom, "batch": 6}, spec_decode=True, spec_k=3,
                 draft_params="self")
    assert tight._sched.preemptions_total > 0, "pool not tight enough"
    assert _tokens_by_rid(tight) == _tokens_by_rid(base)
    for r in tight.completed:
        assert len(r.generated) == 10


def test_spec_parity_with_prefix_cache(params):
    _, tp = params
    rng = np.random.default_rng(53)
    base_p = rng.integers(0, 256, size=19).astype(np.int32)
    wave = [base_p.copy(),
            np.concatenate([base_p[:12],
                            rng.integers(0, 256, size=7).astype(np.int32)]),
            rng.integers(0, 256, size=7).astype(np.int32),
            base_p.copy()]

    def run(**kw):
        eng = tengine.PagedDecodeEngine(T_CFG, tp, device="cpu",
                                        num_blocks=24, **GEOM, **kw)
        eng.submit(base_p, max_new_tokens=6)
        drive(eng, 1)
        _serve(eng, wave)
        return eng

    off = run(prefix_cache=False)
    on = run(prefix_cache=True, spec_decode=True, spec_k=3,
             draft_params="self")
    assert _tokens_by_rid(on) == _tokens_by_rid(off)
    assert on._sched.prefix_tokens_skipped_total > 0
    assert on.cow_copies >= 2


def test_spec_truncation_parity_at_max_len(params):
    _, tp = params
    prompt = np.random.default_rng(54).integers(0, 256, size=30).astype(
        np.int32)
    base = _run(tp, [prompt], max_new=64, batch=2, max_len=40)
    spec = _run(tp, [prompt], max_new=64, batch=2, max_len=40,
                spec_decode=True, spec_k=3, draft_params="self")
    b, s = base.completed[0], spec.completed[0]
    assert len(b.generated) == 40 - 30 + 1
    assert s.generated == b.generated


def test_spec_off_switch_and_env(params, monkeypatch):
    _, tp = params
    kw = dict(batch=2, max_len=48, block_size=8, device="cpu")
    monkeypatch.delenv("GROVE_SPEC_DECODE", raising=False)
    monkeypatch.delenv("GROVE_SPEC_K", raising=False)
    eng = tengine.PagedDecodeEngine(T_CFG, tp, **kw)
    assert not eng.spec_decode and eng.spec_stats() == {}
    assert eng._draft_params is None and eng.draft_kv is None
    monkeypatch.setenv("GROVE_SPEC_DECODE", "1")
    monkeypatch.setenv("GROVE_SPEC_K", "2")
    eng = tengine.PagedDecodeEngine(T_CFG, tp, **kw)
    assert eng.spec_decode and eng.spec_k == 2
    assert eng._out_buf.shape == (2, 3)
    monkeypatch.setenv("GROVE_SPEC_K", "0")
    assert tengine.PagedDecodeEngine(T_CFG, tp, **kw).spec_k == 1
    monkeypatch.setenv("GROVE_SPEC_DECODE", "0")
    eng = tengine.PagedDecodeEngine(T_CFG, tp, **kw)
    assert not eng.spec_decode
    # make_engine passes the knobs through to the paged engine.
    eng = tengine.make_engine(T_CFG, tp, batch=2, max_len=48, device="cpu",
                              spec_decode=True, spec_k=5,
                              draft_params="self")
    assert eng.spec_decode and eng.spec_k == 5 and eng._self_draft


def test_spec_sampling_rejected(params):
    _, tp = params
    with pytest.raises(ValueError, match="greedy-only"):
        tengine.PagedDecodeEngine(
            T_CFG, tp, batch=2, max_len=48, block_size=8, device="cpu",
            spec_decode=True,
            sampler=tengine.SamplerConfig(temperature=0.8))


def test_spec_int8_bitwise_vs_plain_int8(params):
    _, tp = params
    prompts = _prompts(57)
    q8 = _run(tp, prompts, kv_quant="int8")
    both = _run(tp, prompts, kv_quant="int8", spec_decode=True, spec_k=3,
                draft_params="self")
    assert _tokens_by_rid(both) == _tokens_by_rid(q8)
    assert both.spec_stats()["acceptance_rate"] == 1.0


def test_spec_int8_prefix_combined_90_10(params):
    _, tp = params
    rng = np.random.default_rng(58)
    shared = rng.integers(0, 256, size=16).astype(np.int32)
    prompts = []
    for i in range(10):
        if i % 10 == 9:
            prompts.append(rng.integers(0, 256, size=11).astype(np.int32))
        else:
            tail = rng.integers(0, 256, size=3 + (i % 4)).astype(np.int32)
            prompts.append(np.concatenate([shared, tail]))

    def run(**kw):
        eng = tengine.PagedDecodeEngine(T_CFG, tp, device="cpu",
                                        num_blocks=40, kv_quant="int8",
                                        **GEOM, **kw)
        eng.submit(prompts[0], max_new_tokens=6)
        drive(eng, 1)
        _serve(eng, prompts[1:])
        return eng

    plain = run()
    stack = run(prefix_cache=True, spec_decode=True, spec_k=3,
                draft_params="self")
    assert _tokens_by_rid(stack) == _tokens_by_rid(plain)
    assert stack._sched.prefix_tokens_skipped_total > 0
    assert stack.spec_stats()["committed_tokens"] > 0


# ---- inside torch: spec == greedy, windows, warmup, host fetches ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
@pytest.mark.parametrize("draft", ["self", "tiny"])
def test_spec_equals_greedy_bitwise(dtype, kv_quant, draft):
    """Spec output equals greedy output, token for token, over both pools,
    in f32 and in bf16, with either draft (random weights from torch's
    generator)."""
    cfg = dataclasses.replace(T_CFG, dtype=getattr(torch, dtype))
    tp = tllama.init_params(cfg, torch.Generator().manual_seed(7),
                            device="cpu")
    prompts = _prompts(61, n=6)

    def run(**kw):
        eng = tengine.PagedDecodeEngine(cfg, tp, device="cpu",
                                        kv_quant=kv_quant, **GEOM, **kw)
        return _serve(eng, prompts, max_new=9)

    base = run()
    spec = run(spec_decode=True, spec_k=3,
               draft_params="self" if draft == "self" else None)
    assert _tokens_by_rid(spec) == _tokens_by_rid(base)
    if draft == "self":
        assert spec.spec_stats()["acceptance_rate"] == 1.0


def test_pending_windows_keep_distinct_token_copies(params):
    """Two spec windows dispatched before one drain: each holds its own
    copy of the committed tokens (the static out-token buffer is rewritten
    in place by the next dispatch), and the drain folds both."""
    _, tp = params
    eng = tengine.PagedDecodeEngine(T_CFG, tp, device="cpu", spec_decode=True,
                                    spec_k=3, draft_params="self",
                                    **{**GEOM, "host_sync_interval": 8})
    for p in _prompts(62, n=2):
        eng.submit(p, max_new_tokens=12)
    eng.admit_from_queue()
    while eng._sched.has_prefill_work():
        eng._prefill_tick()
    eng.sync()
    assert len(eng._sched.running) == 2 and not eng._pending
    before = {r.rid: len(r.generated) for r in
              (s.req for s in eng._sched.running)}
    eng._spec_tick()
    first = eng._out_buf.clone()
    eng._spec_tick()
    assert len(eng._pending) == 2
    (a, _, _), (b, _, _) = eng._pending
    B = a.shape[0]
    assert len({a.data_ptr(), b.data_ptr(), eng._out_buf.data_ptr()}) == 3
    assert torch.equal(a, first[:B])
    assert torch.equal(b, eng._out_buf[:B])
    # The drain appends each window's tokens in order.
    want = {seq.req.rid: [int(x) for x in a[i]] + [int(x) for x in b[i]]
            for i, seq in enumerate(eng._run_order)}
    eng._drain()
    for seq in eng._sched.running:
        req = seq.req
        assert len(req.generated) == before[req.rid] + 8
        assert req.generated[before[req.rid]:] == want[req.rid]
        assert seq.inflight == 0


def test_spec_warmup_builds_spec_steps_only(params):
    """A spec engine's warmup builds one spec step per bucket and the
    prefill chunks, never a plain decode step; traffic then builds
    nothing, and the warmup leaves live state untouched."""
    _, tp = params
    prompts = _prompts(63)
    runs = []
    for warm in (False, True):
        eng = tengine.PagedDecodeEngine(T_CFG, tp, device="cpu",
                                        spec_decode=True, spec_k=3, **GEOM)
        if warm:
            ladder = eng._sched
            built = eng.warmup()
            assert built == (len(ladder.batch_buckets) + 1) * len(
                ladder.width_buckets)
            assert not eng._steps and eng.graphs_captured == 0
            keys = set(eng._specs)
            assert eng.warmup() == 0
        _serve(eng, prompts)
        if warm:
            assert set(eng._specs) == keys and not eng._steps
        runs.append((_tokens_by_rid(eng), eng.spec_stats()))
    assert runs[0] == runs[1]


class _CountFetches(torch.overrides.TorchFunctionMode):
    """Counts reads of a tensor's value into Python (a host fetch on the
    card)."""

    NAMES = {"item", "tolist", "numpy", "cpu", "__int__", "__float__",
             "__bool__", "__index__"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.NAMES:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
@pytest.mark.parametrize("draft", ["self", "tiny"])
def test_spec_tick_reads_nothing_back(params, kv_quant, draft):
    """A spec dispatch that does not drain reads no tensor value back to
    the host: acceptance, lengths and tokens stay on the device."""
    _, tp = params
    eng = tengine.PagedDecodeEngine(
        T_CFG, tp, device="cpu", spec_decode=True, spec_k=3,
        draft_params="self" if draft == "self" else None,
        kv_quant=kv_quant, **{**GEOM, "host_sync_interval": 8})
    for p in _prompts(64, n=2):
        eng.submit(p, max_new_tokens=20)
    eng.admit_from_queue()
    while eng._sched.has_prefill_work():
        eng._prefill_tick()
    eng._spec_tick()  # the first dispatch recomposes (a drain)
    with _CountFetches() as mode:
        for _ in range(3):
            eng._spec_tick()
    assert mode.n == 0 and len(eng._pending) == 4
