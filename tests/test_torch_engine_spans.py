"""The paged engine's phase stamps, step stamps, host refills and profiler
ranges (grove_tpu_torch/serving/engine.py, serving/xprof.py), on the CPU.

- ``Request.prefill_start_ts``: admission <= first chunk <= first token;
  FIFO head-of-line blocking in whole chunk ticks; a recompute replay
  leaves it alone.
- ``Request.token_ts``: one stamp per generated token, never decreasing,
  across drains, spec ticks and preemption; on the card a mark is placed
  against the fetch's anchor (rehearsed here with stand-in events).
- The refill counters: counted from a fetch to the next launch, dropped
  across a tick that dispatches nothing.
- The ``grove.*`` ranges: none without a profiler, all under one.
- ``GROVE_XPROF=0``: no stamps, counters, events or ranges, and the same
  tokens.
- The observatory's repairs: the card's total without a device call, a
  sample stamped at its dispatch, the roofline estimate from real rows.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving import xprof

torch.set_num_threads(1)

T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
GEOM = dict(batch=4, max_len=48, block_size=8, prefill_chunk=8,
            host_sync_interval=4)
SCENARIOS = {
    "mono": dict(GEOM),
    "spec": dict(GEOM, spec_decode=True, spec_k=3, draft_params="self"),
    "preempt": dict(GEOM, max_len=40, block_size=4, num_blocks=13,
                    prefill_chunk=4, host_sync_interval=2),
}
RANGES = {"grove.admit", "grove.prefill_tick", "grove.decode_tick",
          "grove.launch", "grove.drain", "grove.first_token",
          "grove.report"}


@pytest.fixture(scope="module")
def params():
    return tllama.init_params(T_CFG, torch.Generator().manual_seed(0), "cpu")


def prompts(seed: int = 3, n: int = 6, lo: int = 3, hi: int = 28):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, T_CFG.vocab_size, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def engine(params, scenario: str = "mono", **kw):
    return tengine.PagedDecodeEngine(T_CFG, params, device="cpu",
                                     **{**SCENARIOS[scenario], **kw})


def serve(eng, new: int = 8, seed: int = 3, every_tick=None) -> list:
    reqs = prompts(seed)
    for p in reqs:
        eng.submit(p, max_new_tokens=new)
    for _ in range(3000):
        eng.admit_from_queue()
        if len(eng.completed) >= len(reqs):
            break
        eng.step()
        if every_tick is not None:
            every_tick(eng)
    eng.sync()
    assert len(eng.completed) == len(reqs)
    return sorted(eng.completed, key=lambda r: r.rid)


# ---- the phase stamps ----

@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_phase_stamps_are_ordered(params, scenario):
    for r in serve(engine(params, scenario)):
        assert 0 < r.enqueue_ts <= r.admit_ts <= r.prefill_start_ts \
            <= r.first_token_ts <= r.done_ts, r


@pytest.mark.parametrize("first_len", [8, 17, 24])
def test_second_prompt_waits_the_first_prompts_chunk_ticks(params,
                                                           first_len):
    """Both admitted at once: the second prompt's first chunk dispatches
    in the tick after the first prompt's last, one chunk per tick."""
    eng = engine(params)
    a, b = prompts(5, n=2)
    eng.submit(np.resize(a, first_len), max_new_tokens=4)
    eng.submit(b, max_new_tokens=4)
    assert eng.admit_from_queue() == 2
    first, second = (s.req for s in eng._sched.prefilling)
    chunks = -(-first_len // eng.prefill_chunk)
    for tick in range(1, chunks + 1):
        eng.step()
        assert first.prefill_start_ts and not second.prefill_start_ts, tick
    assert first.first_token_ts and eng.chunks == chunks
    eng.step()
    assert first.first_token_ts <= second.prefill_start_ts
    assert second.admit_ts <= first.prefill_start_ts


def test_recompute_replay_keeps_the_prefill_stamp(params):
    first_seen: dict = {}

    def look(eng):
        for seq in list(eng._sched.prefilling) + list(eng._sched.running):
            r = seq.req
            if r.prefill_start_ts:
                first_seen.setdefault(r.rid, r.prefill_start_ts)

    eng = engine(params, "preempt")
    done = serve(eng, new=12, seed=31, every_tick=look)
    assert eng._sched.preemptions_total > 0
    assert {r.rid: r.prefill_start_ts for r in done} == first_seen


# ---- the step stamps ----

@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_every_token_has_a_stamp_that_never_decreases(params, scenario):
    eng = engine(params, scenario)
    done = serve(eng, new=12 if scenario == "preempt" else 8)
    assert eng.steps > 0 and not eng._stamps
    for r in done:
        assert len(r.token_ts) == len(r.generated), r.rid
        assert r.token_ts[0] == r.first_token_ts
        assert all(a <= b for a, b in zip(r.token_ts, r.token_ts[1:]))
        assert r.token_ts[-1] <= r.done_ts


class FakeEvent:
    """A CUDA event's stand-in: ``record`` takes the next device time."""

    clock = [0.0]

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = FakeEvent.clock[0]

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_marks_are_placed_against_the_fetch_anchor(monkeypatch):
    """On the card a mark is the host time the fetch's copy returned less
    the device time from the mark to the anchor, which the fetch records
    without waiting (the stand-in has no ``synchronize``); events come back
    to the one pool."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    timer = xprof.DeviceTimer(torch.device("cuda"))
    timer.cuda = True
    stamps = []
    for t in (1.0, 1.5, 2.5):           # three steps end on the device
        FakeEvent.clock[0] = t
        stamps.append(timer.mark())
    FakeEvent.clock[0] = 3.0
    anchor = timer.anchor()
    timer.resolve()                     # no anchor: nothing placed
    assert [s.ts for s in stamps] == [0.0, 0.0, 0.0]
    timer.resolve(anchor, 100.0)        # the copy returned at 100 s
    assert [s.ts for s in stamps] == pytest.approx([98.0, 98.5, 99.5])
    assert len(timer._free) == 4 and not timer._marks
    assert xprof.DeviceTimer(torch.device("cuda")).anchor() is None


# ---- the refills ----

def test_refills_count_after_a_fetch_and_drop_across_an_empty_tick(
        params):
    eng = engine(params)
    x = eng.xprof
    eng.submit(prompts(7, n=1, lo=5, hi=8)[0], max_new_tokens=12)
    eng.admit_from_queue()
    eng.step()          # the one chunk, its first token's fetch, a step
    assert (x.refills, eng._refill_from) == (1, 0.0) and x.refill_s > 0
    for _ in range(eng.host_sync_interval - 2):
        eng.step()
    assert x.refills == 1 and not eng._refill_from
    eng.step()          # the window's last step, then its drain's fetch
    assert x.refills == 1 and eng._refill_from
    eng.step()          # the next launch closes the refill
    assert x.refills == 2 and not eng._refill_from
    while not eng.completed:
        eng.step()
    eng.sync()          # a fetch between ticks
    n, s = x.refills, x.refill_s
    eng.step()          # idle: nothing dispatched
    assert not eng._refill_from
    eng.submit(prompts(8, n=1)[0], max_new_tokens=4)
    eng.admit_from_queue()
    eng.step()
    assert (x.refills, x.refill_s) == (n, s)
    assert eng.payload()["host"] == x.payload()["host"] == x.host()
    # A bulk admission ends in a fetch; the wait for the caller's first
    # tick after it is the caller's.
    eng.admit_prompts(np.stack(prompts(9, n=2, lo=6, hi=7)),
                      max_new_tokens=4)
    assert not eng._refill_from


# ---- the ranges ----

def _range_names(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("grove.")}


def test_no_range_opens_without_a_profiler(params, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    serve(engine(params))
    assert not [n for n in opened if n.startswith("grove.")]


@pytest.mark.parametrize("scenario", ["mono", "spec"])
def test_ranges_appear_under_a_profiler(params, scenario):
    from torch.profiler import ProfilerActivity, profile
    eng = engine(params, scenario)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(eng)
    assert _range_names(prof) == RANGES


# ---- the observatory off ----

@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_observatory_off_stamps_and_counts_nothing(params, monkeypatch,
                                                   scenario):
    from torch.profiler import ProfilerActivity, profile
    new = 12 if scenario == "preempt" else 8
    on = serve(engine(params, scenario), new=new)
    monkeypatch.setenv("GROVE_XPROF", "0")
    eng = engine(params, scenario)
    assert eng.xprof is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = serve(eng, new=new)
    assert [r.generated for r in off] == [r.generated for r in on]
    assert all(r.token_ts == [] for r in off)
    assert all(r.prefill_start_ts for r in off)
    assert not _range_names(prof)
    assert eng.payload()["host"] is None and eng._refill_from == 0.0
    assert not eng._stamps and not eng._timer._marks


# ---- the observatory's repairs ----

def test_memory_total_is_read_without_a_device_call(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("mem_get_info on the tick path")
    monkeypatch.setattr(torch.cuda, "mem_get_info", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 300})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=1200))
    cache = types.SimpleNamespace(pool_bytes=100, k=types.SimpleNamespace(
        device=torch.device("cuda")))
    eng = types.SimpleNamespace(cache=cache, params={},
                                kv_lane_utilization=0.0)
    mem = xprof.memory_snapshot(eng)
    assert (mem["limit_bytes"], mem["total_bytes"], mem["source"]) == \
        (1200, 300, "device")
    assert mem["kv_headroom"] == 0.75


def test_a_sample_is_stamped_at_its_dispatch(params):
    obs = xprof.Observatory(sample_every=1, name="dispatch-ts-test")
    eng = engine(params, xprof=obs)
    eng._timer.defer = True
    eng.warmup()
    eng.submit(prompts(9, n=1, lo=12, hi=13)[0], max_new_tokens=4)
    eng.admit_from_queue()
    before = time.time()
    eng.step()                          # the first of two chunks, unread
    time.sleep(0.05)
    read = time.time()
    eng.step()                          # the second: the fetch reads both
    pre = [s for s in obs.recorder.snapshot() if s.phase == "prefill"]
    assert len(pre) == 2
    assert before <= pre[0].ts < read - 0.04 < pre[1].ts


def test_throughput_estimate_takes_the_real_rows(params):
    obs = xprof.Observatory(cfg=T_CFG, batch=8, max_len=64,
                            sample_every=1, name="rows-test")
    obs.record("step", 0.002, tokens=2, rows=2, ctx=30)
    thr = obs.throughput_estimate()
    want = 2 * xprof.decode_flops_per_token(T_CFG, 15) / 0.002 / 989e12
    hbm = 2 * xprof.decode_hbm_bytes_per_token(T_CFG, 15, 2) / 0.002 / 3.35e12
    assert (thr["mfu_est"], thr["hbm_util_est"]) == (round(want, 6),
                                                     round(hbm, 6))
    sampled = xprof.Observatory(sample_every=1, name="rows-engine-test")
    eng = engine(params, xprof=sampled)
    serve(eng)
    steps = [s for s in sampled.recorder.snapshot() if s.phase == "step"]
    assert steps and all(1 <= s.rows == s.tokens <= 4 and s.ctx > s.rows
                         for s in steps)
