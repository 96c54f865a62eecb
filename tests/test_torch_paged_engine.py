"""The port's paged engine against the JAX package's PagedDecodeEngine on
tools/decode_smoke.py's geometry (batch 4, max_len 48, block 8, chunk 8),
over a model-dtype and an int8 KV pool, mirrors of
tests/test_paged_engine.py's behaviour tests and of tests/test_serving.py's
sampling test, the decode-step and prefill-chunk sets, the host-sync
discipline and the engine factory's default."""

import dataclasses

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
from grove_tpu_torch.serving.kvcache import pad_tables

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
GEOM = dict(batch=4, max_len=48, block_size=8, prefill_chunk=8,
            host_sync_interval=4)
PROMPT_LENS = (5, 19, 3, 11, 7)          # tools/decode_smoke.py's workload
MAX_NEW = 6
SCENARIOS = {                             # engine knobs beyond GEOM
    "prefix_on": dict(prefix_cache=True),
    # The cache off on a pool tight enough to preempt (one JAX run fewer
    # to compile than a separate scenario for each).
    "prefix_off_tight": dict(prefix_cache=False, num_blocks=7),
    # The same two over int8 KV (copy-on-write moves the scale rows too).
    "int8_prefix_on": dict(prefix_cache=True, kv_quant="int8"),
    "int8_prefix_off_tight": dict(prefix_cache=False, num_blocks=7,
                                  kv_quant="int8"),
}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, J_CFG.vocab_size, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def drive(eng, want: int, max_iters: int = 3000) -> None:
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        if eng._sched.live:
            eng.step()
    eng.sync()
    assert len(eng.completed) >= want, (len(eng.completed), want)


def _serve_twice(eng) -> dict:
    """decode_smoke's two passes: the workload, then the same prompts
    again (warm prefix hits with the cache on)."""
    prompts = _prompts()
    for rep in (1, 2):
        for p in prompts:
            eng.submit(p, max_new_tokens=MAX_NEW)
        drive(eng, rep * len(prompts))
    return {"tokens": {r.rid: list(r.generated) for r in eng.completed},
            "cow_copies": eng.cow_copies,
            "preemptions": eng._sched.preemptions_total,
            "prefix_skipped": eng._sched.prefix_tokens_skipped_total}


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(params):
    """The JAX engine over every scenario, once for the module."""
    jp, _ = params
    out = {}
    for name, kw in SCENARIOS.items():
        eng = jengine.PagedDecodeEngine(J_CFG, jp, xprof=False,
                                        reqtrace=False, **GEOM, **kw)
        res = _serve_twice(eng)
        res["step_keys"] = sorted((B, W) for B, W, _ in eng._step_jits)
        out[name] = res
    return out


def _port(tp, **kw):
    return tengine.PagedDecodeEngine(T_CFG, tp, device="cpu", **{**GEOM,
                                                                 **kw})


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tokens_and_decisions_match_jax(params, jax_runs, scenario):
    """Greedy tokens keyed by request id, copy-on-write copies, preemptions,
    prefix tokens skipped and the set of decode-step buckets built all equal
    the JAX engine's."""
    _, tp = params
    eng = _port(tp, **SCENARIOS[scenario])
    got = _serve_twice(eng)
    want = jax_runs[scenario]
    assert got["tokens"] == want["tokens"]
    for key in ("cow_copies", "preemptions", "prefix_skipped"):
        assert got[key] == want[key], key
    assert sorted(eng._steps) == want["step_keys"]
    assert all(len(t) == MAX_NEW for t in got["tokens"].values())
    eng._alloc.check()
    assert eng._alloc.used_blocks == 0


def test_scenarios_exercise_sharing_and_preemption(jax_runs):
    assert jax_runs["prefix_on"]["cow_copies"] > 0
    assert jax_runs["prefix_on"]["prefix_skipped"] > 0
    off = jax_runs["prefix_off_tight"]
    assert off["preemptions"] > 0 and off["cow_copies"] == 0
    assert jax_runs["prefix_on"]["tokens"] == off["tokens"]


def test_int8_scenarios_exercise_sharing_and_preemption(jax_runs):
    """The int8 scenarios copy on write and preempt too, and int8 tokens
    are the same with the prefix cache on and off."""
    on, off = jax_runs["int8_prefix_on"], jax_runs["int8_prefix_off_tight"]
    assert on["cow_copies"] > 0 and on["prefix_skipped"] > 0
    assert off["preemptions"] > 0 and off["cow_copies"] == 0
    assert on["tokens"] == off["tokens"]


# ---- mirrors of tests/test_paged_engine.py ----

def test_paged_engine_matches_lanes_tokens(params):
    _, tp = params
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, T_CFG.vocab_size, size=n).astype(np.int32)
               for n in (6, 13, 4, 9)]
    lanes = tengine.DecodeEngine(T_CFG, tp, batch=4, max_len=48,
                                 device="cpu")
    toks = np.zeros((4, 13), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lanes.admit_prompts(torch.from_numpy(toks), max_new_tokens=8,
                        lengths=torch.tensor([len(p) for p in prompts],
                                             dtype=torch.int32))
    for _ in range(16):
        lanes.step()
    lanes.sync()
    paged = _port(tp)
    for p in prompts:
        paged.submit(p, max_new_tokens=8)
    drive(paged, 4)
    lanes_by = {r.prompt_len: r.generated for r in lanes.completed}
    for r in paged.completed:
        assert r.generated == lanes_by[r.prompt_len], r.prompt_len


def test_prefix_cache_bitwise_parity_on_off(params):
    _, tp = params
    rng = np.random.default_rng(41)
    base = rng.integers(0, 256, size=19).astype(np.int32)
    later = [base.copy(),
             np.concatenate([base[:12],
                             rng.integers(0, 256, size=7).astype(np.int32)]),
             rng.integers(0, 256, size=7).astype(np.int32), base.copy()]

    def run(prefix_cache):
        eng = _port(tp, num_blocks=24, prefix_cache=prefix_cache)
        eng.submit(base, max_new_tokens=6)
        drive(eng, 1)
        for p in later:
            eng.submit(p, max_new_tokens=6)
        drive(eng, 1 + len(later))
        eng._alloc.check()
        assert eng._alloc.used_blocks == 0
        return eng

    on, off = run(True), run(False)
    by_rid = {r.rid: r.generated for r in off.completed}
    assert len(by_rid) == 5
    for r in on.completed:
        assert r.generated == by_rid[r.rid], r.rid
    assert on._sched.prefix_tokens_skipped_total > 0
    assert on.cow_copies >= 2 and on._alloc.cached_blocks > 0
    assert off.cow_copies == 0 and off._alloc.cached_blocks == 0
    assert on.prefix_stats()["cow_copies"] == on.cow_copies
    assert off.prefix_stats() == {}


def test_tight_pool_storm_preserves_tokens(params):
    _, tp = params
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(6, 20, size=8)]

    def run(num_blocks, slots):
        eng = tengine.PagedDecodeEngine(
            T_CFG, tp, batch=slots, max_len=40, block_size=4,
            num_blocks=num_blocks, prefill_chunk=4, host_sync_interval=2,
            device="cpu")
        for p in prompts:
            eng.submit(p, max_new_tokens=10)
        drive(eng, len(prompts), max_iters=6000)
        eng._alloc.check()
        assert eng._alloc.used_blocks == 0
        return eng

    roomy = run(num_blocks=96, slots=8)
    tight = run(num_blocks=12, slots=6)
    assert tight._sched.preemptions_total > 0, "pool not tight enough"
    by_rid = {r.rid: r.generated for r in roomy.completed}
    for r in tight.completed:
        assert r.generated == by_rid[r.rid], r.rid
        assert len(r.generated) == 10
        assert r.enqueue_ts <= r.admit_ts <= r.first_token_ts <= r.done_ts


def test_cache_full_truncates_instead_of_crashing(params):
    _, tp = params
    rng = np.random.default_rng(22)
    eng = _port(tp, max_len=40)
    eng.submit(rng.integers(0, 256, size=30).astype(np.int32),
               max_new_tokens=64)
    drive(eng, 1, max_iters=400)
    req = eng.completed[0]
    assert len(req.generated) == 40 - 30 + 1
    assert req.done_ts > 0
    eng._alloc.check()
    assert eng._alloc.used_blocks == 0


def test_prefill_head_of_line_oom_does_not_deadlock(params):
    _, tp = params
    rng = np.random.default_rng(23)
    eng = _port(tp, num_blocks=7)
    for _ in range(4):
        eng.submit(rng.integers(0, 256, size=17).astype(np.int32),
                   max_new_tokens=4)
    drive(eng, 4)
    assert [len(r.generated) for r in eng.completed] == [4] * 4
    eng._alloc.check()
    assert eng._alloc.used_blocks == 0


def test_chunk_padding_past_capacity_does_not_corrupt(params):
    """A 40-token prompt's last chunk pads to positions 32..63 while the
    table holds 48: the overflow rows land in the null block, and the
    tokens match the lanes engine exactly."""
    _, tp = params
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, T_CFG.vocab_size, size=40).astype(np.int32)
    lanes = tengine.DecodeEngine(T_CFG, tp, batch=1, max_len=48,
                                 device="cpu")
    lanes.admit_prompts(torch.from_numpy(prompt)[None], max_new_tokens=6)
    for _ in range(12):
        lanes.step()
    lanes.sync()
    paged = tengine.PagedDecodeEngine(T_CFG, tp, batch=1, max_len=48,
                                      block_size=16, prefill_chunk=32,
                                      host_sync_interval=4, device="cpu")
    paged.submit(prompt, max_new_tokens=6)
    drive(paged, 1)
    assert paged.completed[0].generated == lanes.completed[0].generated


def test_request_joins_mid_decode_and_stamps_in_order(params):
    _, tp = params
    eng = _port(tp, batch=2)
    rng = np.random.default_rng(5)
    eng.submit(rng.integers(0, 256, size=6).astype(np.int32),
               max_new_tokens=20)
    eng.admit_from_queue()
    for _ in range(8):
        eng.step()
    assert eng._sched.running and not eng.completed
    eng.submit(rng.integers(0, 256, size=5).astype(np.int32),
               max_new_tokens=4)
    drive(eng, 2)
    done = {r.prompt_len: r for r in eng.completed}
    assert done[5].done_ts <= done[6].done_ts
    for r in eng.completed:
        assert r.enqueue_ts <= r.admit_ts < r.first_token_ts <= r.done_ts


# ---- decode steps, host syncs, the factory ----

def test_step_set_after_warmup_does_not_grow(params):
    _, tp = params
    eng = _port(tp)
    built = eng.warmup()
    ladder = eng._sched
    assert built == (len(ladder.batch_buckets) + 1) * len(
        ladder.width_buckets)  # decode steps, then one chunk per width
    assert sorted(eng._prefills) == ladder.width_buckets
    keys = set(eng._steps)
    assert eng.warmup() == 0  # idempotent
    assert eng.graphs_captured == 0  # eager steps on the CPU
    assert eng._alloc.used_blocks == 0 and not eng._pending
    _serve_twice(eng)
    assert set(eng._steps) == keys
    assert sorted(eng._prefills) == ladder.width_buckets


def test_warmup_leaves_live_state_untouched(params):
    """A warmup in the middle of traffic writes only the null block and
    restores the static decode buffers: the tokens equal an unwarmed
    run's."""
    _, tp = params
    prompts = _prompts()
    runs = []
    for warm in (False, True):
        eng = _port(tp)
        for p in prompts:
            eng.submit(p, max_new_tokens=MAX_NEW)
        for _ in range(6):
            eng.admit_from_queue()
            eng.step()
        if warm:
            eng.warmup(batches=[4], widths=[1, 2, 4])
        drive(eng, len(prompts))
        runs.append({r.rid: r.generated for r in eng.completed})
    assert runs[0] == runs[1]


def test_decode_fetches_to_the_host_once_per_window(params, monkeypatch):
    _, tp = params
    eng = _port(tp, batch=2)
    for n in (6, 6):
        eng.submit(np.arange(n, dtype=np.int32), max_new_tokens=20)
    eng.admit_from_queue()
    for _ in range(4):  # both prompts prefilled and decoding
        eng.step()
    eng.sync()
    assert len(eng._sched.running) == 2 and not eng._pending
    fetches = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        fetches.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    def no_item(self):
        raise AssertionError("a host sync (.item()) in the step path")

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    for _ in range(3):
        eng.step()
    assert fetches == []
    eng.step()
    assert fetches == [(4, 2)]  # the whole [window, batch] block at once


class _CountFetches(torch.overrides.TorchFunctionMode):
    """Counts reads of a tensor's value into Python (what is a host fetch
    on the card): item, tolist, numpy, cpu and the int/float/bool/index
    conversions."""

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
def test_prefill_tick_fetches_only_when_it_completes_a_prompt(params,
                                                               kv_quant):
    """A 19-token prompt in chunks of 8: the first two chunks read nothing
    back (offset, valid count and logit row are device scalars), the third
    fetches its first token once."""
    _, tp = params
    eng = _port(tp, kv_quant=kv_quant)
    eng.submit(np.arange(19, dtype=np.int32), max_new_tokens=4)
    eng.admit_from_queue()
    fetches = []
    for _ in range(3):
        with _CountFetches() as mode:
            eng._prefill_tick()
        fetches.append(mode.n)
    assert fetches == [0, 0, 1]
    assert len(eng._sched.running) == 1
    assert sorted(eng._prefills) == [1, 2, 4]  # the widths the chunks took


def test_chunk_logits_equal_with_device_scalars(params):
    """One chunk through the engine's static buffer (device scalars)
    against the model function with Python ints: bitwise equal logits and
    pools."""
    _, tp = params
    outs = []
    for engine_path in (True, False):
        eng = _port(tp)
        eng.submit(np.arange(3, 14, dtype=np.int32), max_new_tokens=2)
        eng.admit_from_queue()
        seq = eng._sched.next_prefill()
        blocks = list(seq.blocks.blocks)
        if engine_path:
            c = eng.prefill_chunk
            W = 2
            host = np.zeros((c + 3 + W,), np.int32)
            host[:c] = seq.tokens[:c]
            host[c:c + 3] = (0, c - 1, c)
            host[c + 3:] = pad_tables([blocks], W)[0]
            eng._upload(eng._pf_buf[:c + 3 + W], host)
            logits = eng._get_prefill(W)()
        else:
            logits = tllama.prefill_chunk_paged(
                T_CFG, tp, torch.from_numpy(seq.tokens[None, :8].copy()),
                eng.kv.k, eng.kv.v, torch.from_numpy(pad_tables([blocks], 2)),
                0, 7, 8)
        outs.append((logits.clone(), eng.kv.k.clone(), eng.kv.v.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _sampled_run(tp, seed, temperature, top_k=8, steps=24):
    eng = _port(tp, sampler=tengine.SamplerConfig(
        temperature=temperature, top_k=top_k, seed=seed))
    for p in _prompts()[:3]:
        eng.submit(p, max_new_tokens=8)
    drive(eng, 3, max_iters=steps * 10)
    return {r.rid: r.generated for r in eng.completed}


def test_paged_sampling_seed_temperature_and_topk(params):
    """The paged engine's sampled path (tests/test_serving.py's sampling
    test on the paged engine): deterministic per seed, different across
    seeds, temperature 0 and top_k = 1 both equal greedy decoding, and
    top-k sampling picks only among the k best logits."""
    _, tp = params
    greedy = {r: g for r, g in _sampled_run(tp, 0, 0.0).items()}
    assert _sampled_run(tp, 0, 1.2) == _sampled_run(tp, 0, 1.2)
    assert _sampled_run(tp, 0, 1.2) != _sampled_run(tp, 1, 1.2)
    assert _sampled_run(tp, 5, 0.0) == greedy
    assert _sampled_run(tp, 3, 1.2, top_k=1) == greedy
    eng = _port(tp)
    for p in _prompts()[:3]:
        eng.submit(p, max_new_tokens=8)
    drive(eng, 3)
    assert {r.rid: r.generated for r in eng.completed} == greedy

    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0]])
    cfgk = tengine.SamplerConfig(temperature=0.5, top_k=2, seed=0)
    gen = torch.Generator().manual_seed(0)
    picks = {int(tengine.sample_tokens(logits, gen, cfgk)[0])
             for _ in range(30)}
    assert picks == {3, 4}, picks


def test_paged_sampling_over_int8_kv(params):
    """Sampling composes with int8 KV: deterministic per seed, and top_k =
    1 equals the int8 engine's greedy tokens."""
    _, tp = params

    def run(**kw):
        eng = _port(tp, kv_quant="int8", **kw)
        for p in _prompts()[:3]:
            eng.submit(p, max_new_tokens=8)
        drive(eng, 3)
        return {r.rid: r.generated for r in eng.completed}

    sampled = tengine.SamplerConfig(temperature=1.2, top_k=8, seed=4)
    assert run(sampler=sampled) == run(sampler=sampled)
    assert run(sampler=tengine.SamplerConfig(temperature=1.2, top_k=1,
                                             seed=4)) == run()


def test_make_engine_defaults_to_paged(params, monkeypatch):
    _, tp = params
    monkeypatch.delenv("GROVE_ENGINE", raising=False)
    eng = tengine.make_engine(T_CFG, tp, batch=2, max_len=48, block_size=8,
                              device="cpu")
    assert isinstance(eng, tengine.PagedDecodeEngine)
    assert eng.block_size == 8 and eng.prefill_chunk == 32
    assert eng.kv.num_blocks == 2 * 6 + 1 and eng._prefix is not None
    monkeypatch.setenv("GROVE_ENGINE", "paged")
    monkeypatch.setenv("GROVE_PREFIX_CACHE", "0")
    eng = tengine.make_engine(T_CFG, tp, batch=2, device="cpu")
    assert isinstance(eng, tengine.PagedDecodeEngine) and eng._prefix is None
    monkeypatch.setenv("GROVE_DISAGG", "1")
    eng = tengine.make_engine(T_CFG, tp, device="cpu")
    assert isinstance(eng, tengine.DisaggServing)
    assert isinstance(eng.prefill, tengine.PrefillEngine)
    assert eng.decode._prefix is None and eng.prefill._prefix is None


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_options_raise(params, kw):
    _, tp = params
    with pytest.raises(NotImplementedError):
        tengine.PagedDecodeEngine(T_CFG, tp, device="cpu", **kw)


def test_paged_engine_int8_weights_run(params):
    _, tp = params
    eng = tengine.make_engine(T_CFG, tp, batch=2, max_len=48, quant="int8",
                              device="cpu")
    assert hasattr(eng.params["layers"]["wq"], "materialize")
    for p in _prompts()[:3]:
        eng.submit(p, max_new_tokens=3)
    drive(eng, 3)
    assert [len(r.generated) for r in eng.completed] == [3, 3, 3]
