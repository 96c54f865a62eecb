"""The metric arithmetic on numbers worked out by hand."""

import types
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.observe import Account, Observer, Track

BASE = Path(__file__).resolve().parents[1]


def metric(name):
    return harness.load_module(BASE / "metrics" / f"{name}.py")


def req(first=0.0, admit=0.0, generated=(), done=True):
    return types.SimpleNamespace(first_token_ts=first, admit_ts=admit,
                                 generated=list(generated), done=done,
                                 prompt_len=10, rid=0)


def track(due, stamps, first=0.0, admit=0.0, in_window=True):
    t = Track(rid=0, req=req(first, admit, range(len(stamps))), due=due,
              prompt_len=10, in_window=in_window)
    t.stamps = list(stamps)
    return t


def readings(tracks, t0=100.0, t1=110.0, end=120.0, **kw):
    obs = Observer(FakeEngine(), 4)
    obs.tracks = tracks
    fields = dict(cfg=None, cell={}, mix={}, seconds=t1 - t0, obs=obs,
                  win={"t0": t0, "t1": t1, "end": end, "setup_s": 7.5},
                  slice=None, trace=None, flight=[],
                  peaks=None, base=BASE)
    fields.update(kw)
    return harness.Readings(**fields)


def test_ttft_tail_is_taken_from_the_due_time():
    # 20 requests due at 100 + i, first tokens 10 * (i + 1) ms after.
    ts = [track(100.0 + i, [100.0 + i + 0.01 * (i + 1)],
                first=100.0 + i + 0.01 * (i + 1)) for i in range(20)]
    # numpy's linear p95 of 10..200 ms: 10 + 0.95 * 19 * 10 = 190.5
    assert metric("ttft_p95_ms").read(readings(ts)) == pytest.approx(190.5)
    # A request never served counts at the drain's end (120 s): 20 s late.
    ts.append(track(100.0, [], first=0.0))
    # Sorted: 10..200 ms, 20,000 ms; the linear p95 sits at index 19.
    assert metric("ttft_p95_ms").read(readings(ts)) == pytest.approx(200.0)
    # Requests outside the window do not count.
    only_out = [track(100.0, [105.0], first=105.0, in_window=False)]
    assert metric("ttft_p95_ms").read(readings(only_out)) is None


def test_tpot_counts_tokens_after_the_first_stamp():
    # First token at 1.0, then drains of 8 tokens at 1.2 and 1.4 (16
    # tokens after the first): (1.4 - 1.0) / 16 = 25 ms.
    t = track(0.5, [1.0] + [1.2] * 8 + [1.4] * 8)
    assert metric("tpot_p95_ms").read(
        readings([t], t0=0.0)) == pytest.approx(25.0)
    # A session's set-up token (before t0) is left out: the first stamp in
    # the window is a drain of 8, and 8 tokens follow it in 0.2 s.
    assert metric("tpot_p95_ms").read(
        readings([t], t0=1.1)) == pytest.approx(25.0)
    # One token only: no TPOT.
    assert metric("tpot_p95_ms").read(readings([track(0, [1.0])],
                                               t0=0.0)) is None


def test_rate_is_over_the_whole_window():
    ts = [track(100.0, [100.5, 101.0, 109.0, 111.0]),
          track(105.0, [105.5, 110.0])]
    # 5 tokens stamped in [100, 110], over 10 s.
    assert metric("output_tokens_per_s").read(
        readings(ts)) == pytest.approx(0.5)
    assert metric("setup_s").read(readings(ts)) == 7.5


def test_step_means():
    s = types.SimpleNamespace
    flight = [s(phase="step", seconds=0.030, steps=1),
              s(phase="step", seconds=0.010, steps=1),
              s(phase="prefill", seconds=0.020, steps=1)]
    r = readings([], flight=flight)
    assert metric("decode_step_ms").read(r) == pytest.approx(20.0)
    assert metric("prefill_chunk_ms").read(r) == pytest.approx(20.0)


CFG = types.SimpleNamespace(d_model=4, n_heads=2, n_kv_heads=1, head_dim=2,
                            d_ff=8, n_layers=1, vocab_size=10)
PEAKS = {"hbm_bytes_per_s": 1.0, "bf16_flops": 1e30}


def test_gemm_bytes_by_hand():
    g = harness.load_module(BASE / "roofline" / "gemm.py")
    # Projections: wq 4*2*2=16, wk 4*1*2=8, wv 8, wo 2*2*4=16, mlp 3*4*8=96
    # -> 144 weights; head 4*10 = 40. One row's activations: in 4+4+4+8=20,
    # out (2+2)*2 + 4 + 16 + 4 = 32; the head's row reads 4 bf16 and
    # writes 10 f32.
    sh = g.shapes(CFG)
    assert sh == {"proj_params": 144, "head_params": 40, "act_elems": 52,
                  "head_in": 4, "head_out": 10}
    acc = Account(decode_dispatches=2, chunk_dispatches=1, decode_rows=3,
                  decode_ctx_sum=0, chunks=[(0, 4)], prompts_done=1,
                  chunk_width=4)
    w = (144 + 40) * 2
    row = 52 * 2 + 4 * 2 + 10 * 4
    # Two decode steps read the weights twice and 3 rows; the chunk reads
    # them once, 4 rows through the projections and 1 through the head.
    want = 2 * w + 3 * row + (w + 4 * 52 * 2 + 4 * 2 + 10 * 4)
    assert g.least_seconds(CFG, acc, PEAKS) == pytest.approx(want)


def test_paged_decode_bytes_by_hand():
    a = harness.load_module(BASE / "roofline" / "paged_attn.py")
    # Decode: 3 rows over contexts 5 + 6 + 7 = 18; each position's K and V
    # are 2 * 1 * 2 bf16 = 8 bytes; each row reads q and writes its output,
    # 2 * 2 bf16 = 8 bytes each, 16 in all.
    acc = Account(decode_dispatches=1, chunk_dispatches=0, decode_rows=3,
                  decode_ctx_sum=18, chunks=[], prompts_done=0,
                  chunk_width=4)
    assert a.least_seconds(CFG, acc, PEAKS) == pytest.approx(18 * 8 + 3 * 16)
    # A chunk of 3 valid rows at offset 5 reads 8 positions.
    acc.chunks = [(5, 3)]
    assert a.least_seconds(CFG, acc, PEAKS) == pytest.approx(
        18 * 8 + 3 * 16 + 8 * 8 + 3 * 16)
    acc.chunks = None
    assert a.least_seconds(CFG, acc, PEAKS) is None


def test_step_mfu_counts_attention_over_real_contexts():
    m = harness.load_module(BASE / "roofline" / "model.py")
    acc = Account(decode_dispatches=1, chunk_dispatches=1, decode_rows=2,
                  decode_ctx_sum=11, chunks=[(0, 3)], prompts_done=1,
                  chunk_width=4)
    # decode: 2 * 2 * (144 + 40) + 4 * 2 * 2 * 1 * 11; chunk of 3 at 0:
    # 2 * 3 * 144 + 4 * 2 * 2 * (1 + 2 + 3); the prompt's head once.
    want = 2 * 2 * 184 + 16 * 11 + 2 * 3 * 144 + 16 * 6 + 2 * 40
    assert m.flops(CFG, acc) == want


class FakeEngine:
    """The counters the observer reads: chunk dispatches and the pool."""

    def __init__(self):
        self.chunks = 0
        self.used = 0

    def payload(self):
        return {"schedule": {"allocator": {"used": self.used, "cached": 2,
                                           "capacity": 100}}}


def test_observer_works_out_chunks_first_in_first_out():
    eng = FakeEngine()
    obs = Observer(eng, 4)
    a = obs.add(0, req(generated=[], done=False), 0.0, True)
    a.req.prompt_len = a.prompt_len = 6
    b = obs.add(1, req(generated=[], done=False), 0.0, True)
    b.req.prompt_len = b.prompt_len = 3
    eng.chunks = 3
    a.req.generated = [7]
    b.req.generated = [8]
    obs.poll(1.0)
    assert [(o, v) for _, o, v in obs.chunk_log] == [(0, 4), (4, 2), (0, 3)]
    assert obs.sound and obs.prompt_done == [1.0, 1.0]
    acc = obs.account(0.0, 2.0, steps=0, chunks=3)
    assert acc.chunks == [(0, 4), (4, 2), (0, 3)] and acc.prompts_done == 2


def test_pool_occupancy_is_sampled_over_the_window():
    eng = FakeEngine()
    obs = Observer(eng, 4)
    # Samples at most every 0.25 s: 0.0, 0.3, 0.6 and 0.9 are taken, 0.1
    # is not; only those in [0.2, 0.9] count.
    for now, used in ((0.0, 50), (0.1, 99), (0.3, 10), (0.6, 30),
                      (0.9, 20)):
        eng.used = used
        obs.poll(now)
    got = obs.pool(0.2, 0.9)
    assert got == {"used_peak": 30, "used_mean": 20.0, "cached_peak": 2,
                   "capacity": 100, "samples": 3}
    assert obs.pool(5.0, 6.0) is None


def test_step_mfu_is_taken_over_the_busy_device_time():
    acc = Account(decode_dispatches=1, chunk_dispatches=0, decode_rows=2,
                  decode_ctx_sum=11, chunks=[], prompts_done=0,
                  chunk_width=4)
    ops = 2 * 2 * 184 + 16 * 11
    trace = types.SimpleNamespace(busy_s=0.5, window_s=2.0)
    r = readings([], cfg=CFG, slice=acc, trace=trace,
                 peaks={"bf16_flops": 1000.0, "hbm_bytes_per_s": 1.0})
    # The slice's operations over half a second of busy device at 1,000
    # operations per second.
    assert metric("step_mfu").read(r) == pytest.approx(100.0 * ops / 500.0)
    acc.chunk_dispatches, acc.chunks = 1, None
    assert metric("step_mfu").read(r) is None
