"""The readers of the engine's phase stamps, step stamps and refill counters
(``prefill_wait_p95_ms``, ``prefill_span_p95_ms``, ``device_tpot_p95_ms``,
``host_refill_share``) on numbers worked out by hand, the rules for requests
unfinished at the drain's end, silence where the program keeps no such
stamp or counter, and all four read from a traced run of the tiny cells."""

import types
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.observe import Observer, Track

BASE = Path(__file__).resolve().parents[1]
NEW = ("prefill_wait_p95_ms", "prefill_span_p95_ms", "device_tpot_p95_ms",
       "host_refill_share")


def metric(name):
    return harness.load_module(BASE / "metrics" / f"{name}.py")


class Engine:
    chunks = 0


def track(due, admit=0.0, start=0.0, first=0.0, token_ts=None):
    """A window request; ``token_ts`` None is a program without the
    stamps."""
    req = types.SimpleNamespace(admit_ts=admit, first_token_ts=first,
                                generated=[], done=True, prompt_len=10)
    if token_ts is not None:
        req.prefill_start_ts = start
        req.token_ts = list(token_ts)
    return Track(rid=0, req=req, due=due, prompt_len=10, in_window=True)


def readings(tracks, t0=100.0, t1=110.0, end=120.0, **kw):
    obs = Observer(Engine(), 4)
    obs.tracks = tracks
    fields = dict(cfg=None, cell={}, mix={}, seconds=t1 - t0, obs=obs,
                  win={"t0": t0, "t1": t1, "end": end, "setup_s": 1.0},
                  slice=None, trace=None, flight=[], peaks=None, base=BASE)
    fields.update(kw)
    return harness.Readings(**fields)


def test_prefill_wait_runs_from_admission_to_the_first_chunk():
    # Admitted 1 ms after due, first chunks 10 * (i + 1) ms after that.
    ts = [track(100.0 + i, admit=100.001 + i,
                start=100.001 + i + 0.01 * (i + 1), token_ts=[])
          for i in range(20)]
    # numpy's linear p95 of 10..200 ms: 10 + 0.95 * 19 * 10.
    assert metric("prefill_wait_p95_ms").read(readings(ts)) == \
        pytest.approx(190.5)


@pytest.mark.parametrize("admit,want", [
    (111.0, 9000.0),     # admitted, never started: from admission to 120
    (0.0, 15000.0),      # never admitted: from its due time, 105
])
def test_prefill_wait_counts_an_unstarted_request_at_the_drains_end(
        admit, want):
    t = track(105.0, admit=admit, token_ts=[])
    assert metric("prefill_wait_p95_ms").read(readings([t])) == \
        pytest.approx(want)


def test_prefill_span_runs_from_the_first_chunk_to_the_first_token():
    ts = [track(100.0 + i, admit=100.0 + i, start=100.0 + i,
                first=100.0 + i + 0.02 * (i + 1), token_ts=[])
          for i in range(20)]
    # 20..400 ms: 20 + 0.95 * 19 * 20.
    assert metric("prefill_span_p95_ms").read(readings(ts)) == \
        pytest.approx(381.0)


@pytest.mark.parametrize("admit,start,want", [
    (100.0, 110.0, 10000.0),    # started, no first token: from its start
    (112.0, 0.0, 8000.0),       # never started: from its admission
    (0.0, 0.0, 5000.0),         # never admitted: from its due time, 115
])
def test_prefill_span_counts_an_unfinished_request_at_the_drains_end(
        admit, start, want):
    t = track(115.0, admit=admit, start=start, token_ts=[])
    assert metric("prefill_span_p95_ms").read(readings([t])) == \
        pytest.approx(want)


def test_device_tpot_takes_tpots_rule_over_the_step_stamps():
    # The first token at 1.0, then one step every 24 ms: 16 tokens.
    stamps = [1.0] + [1.0 + 0.024 * k for k in range(1, 17)]
    t = track(0.5, first=1.0, token_ts=stamps)
    t.stamps = [1.0] + [1.2] * 8 + [1.4] * 8    # the host's drains
    r = readings([t], t0=0.0)
    assert metric("device_tpot_p95_ms").read(r) == pytest.approx(24.0)
    assert metric("tpot_p95_ms").read(r) == pytest.approx(25.0)
    # From t0 = 1.1 on: the stamps 1.12 .. 1.384, 11 tokens after the
    # first of them.
    assert metric("device_tpot_p95_ms").read(
        readings([t], t0=1.1)) == pytest.approx(24.0)
    # One token: no TPOT.
    assert metric("device_tpot_p95_ms").read(
        readings([track(0.5, first=1.0, token_ts=[1.0])], t0=0.0)) is None


def test_refill_share_is_the_counters_delta_over_the_window():
    c0 = {"host": {"refills": 3, "refill_s": 0.5}}
    c1 = {"host": {"refills": 40, "refill_s": 0.9}}
    # 0.4 s of refills over a 10 s window.
    assert metric("host_refill_share").read(
        readings([], counters0=c0, counters1=c1)) == pytest.approx(4.0)


@pytest.mark.parametrize("name", NEW)
def test_silent_where_the_program_keeps_no_stamp_or_counter(name):
    """A program without the stamps (the parent commit's) or with its
    observatory off: every reader gives None and raises nothing."""
    old = track(100.0, admit=100.1, first=100.5)
    old.stamps = [100.5, 100.6, 100.7]
    for r in (readings([old], counters0={"host": None},
                       counters1={"host": None}),
              readings([old], counters0={"engine": "paged"},
                       counters1={"engine": "paged"}),
              readings([])):
        assert metric(name).read(r) is None


def test_a_traced_run_reads_all_four(tiny_root):
    res = harness.run(tiny_root, "tiny.chat", 2 ** 31 + 9, 1.0, True,
                      device="cpu")
    got = res["metrics"]
    assert set(NEW) <= set(got)
    assert got["prefill_wait_p95_ms"]["value"] >= 0
    assert got["prefill_span_p95_ms"]["value"] > 0
    assert got["device_tpot_p95_ms"]["value"] > 0
    assert 0 < got["host_refill_share"]["value"] < 100
    sessions = harness.run(tiny_root, "tiny.sessions", 13, 1.0, True,
                           device="cpu")["metrics"]
    assert {"device_tpot_p95_ms", "host_refill_share"} <= set(sessions)
    assert not {"prefill_wait_p95_ms", "prefill_span_p95_ms"} & \
        set(sessions)
