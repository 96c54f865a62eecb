"""The port's device observatory (grove_tpu_torch/serving/xprof.py) held
against the JAX package's.

Twins of tests/test_xprof.py's cases: ring bounds, sampling cadence, every
Nth step sampled, build reasons, a forced shape change detected, the storm
warning, the CPU memory fallback, memory riding the telemetry digest, and
GROVE_XPROF=0 giving no observatory (tokens unchanged). Then the port's own
parts: the device timer's deferred reading (the card's order of events,
rehearsed on the CPU), the H100 roofline, and the boundary: a port
observatory registered through the JAX package's registry is served by
the JAX store client, and both renderers render its payload line for line;
a JAX ``MetricsHub`` passed as ``metrics=`` receives the JAX engine's
series. No wall-time pin: the overhead is measured on the card
(``chip_smoke.py`` phase 12).

The compile tables of the paged engines against the JAX engines on the same
traffic are in tests/test_torch_reqtrace.py (the engine matrix).
"""

from __future__ import annotations

import dataclasses
import gc
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.runtime import metrics as jmetrics
from grove_tpu.serving import engine as jengine
from grove_tpu.serving import xprof as jxprof
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving import metrics as tmetrics
from grove_tpu_torch.serving import xprof

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(b=2, s=8, seed=1):
    return np.random.default_rng(seed).integers(
        0, T_CFG.vocab_size, (b, s)).astype(np.int32)


def _lanes(tp, **kw):
    return tengine.DecodeEngine(T_CFG, tp, batch=2, device="cpu", **kw)


# ---- flight recorder ----

def test_ring_bounded():
    recs = (xprof.FlightRecorder(capacity=8, sample_every=1),
            jxprof.FlightRecorder(capacity=8, sample_every=1))
    for rec in recs:
        for i in range(50):
            rec.record("step", 0.001 * (i + 1), tokens=2)
    rec = recs[0]
    assert len(rec) == 8
    assert rec.samples_total == 50
    assert rec.phase_stats()["step"]["count"] == 8
    assert rec.phase_stats() == recs[1].phase_stats()


def test_phase_stats_do_not_depend_on_order():
    """Resolved timings arrive after their dispatch, in any order."""
    a, b = xprof.FlightRecorder(), xprof.FlightRecorder()
    vals = [0.003, 0.001, 0.002, 0.005, 0.004]
    for v in vals:
        a.record("step", v, tokens=1)
    for v in reversed(vals):
        b.record("step", v, tokens=1)
    assert a.phase_stats() == b.phase_stats()


def test_sampling_cadence_counts_dispatches():
    rec, jrec = xprof.FlightRecorder(sample_every=4), \
        jxprof.FlightRecorder(sample_every=4)
    fired = [rec.should_sample() for _ in range(12)]
    assert fired == [True, False, False, False] * 3
    assert fired == [jrec.should_sample() for _ in range(12)]


def test_engine_samples_every_nth_step(params):
    _, tp = params
    obs = xprof.Observatory(sample_every=4, name="cadence-test")
    eng = _lanes(tp, xprof=obs)
    eng.admit_prompts(_prompts())
    for _ in range(16):
        eng.step()
    eng.sync()
    stats = obs.recorder.phase_stats()
    # Dispatches 0, 4, 8, 12 sampled; dispatch 0 was the step's build and
    # is dropped (its time is the build's).
    assert stats["step"]["count"] == 3, stats
    assert stats["step"]["p95_ms"] < 200.0, stats
    assert "prefill" not in stats  # the first admission built prefill


# ---- builds ----

def test_compile_tracker_classifies_reasons():
    tracker = xprof.CompileTracker()
    tracker.note_build("f", 0.01, ((2,), "float32"))
    tracker.note_build("f", 0.01, ((3,), "float32"))  # new signature
    assert tracker.counts() == {"f": 2}
    assert tracker.recompile_count() == 1
    assert [e.reason for e in tracker.events] == ["first", "shape-change"]
    assert tracker.payload()["fns"][0]["last_reason"] == "shape-change"
    # The JAX tracker on the same two builds.
    jt = jxprof.CompileTracker()
    f = jt.wrap("f", jax.jit(lambda x: x * 2))
    f(jnp.ones((2,)))
    f(jnp.ones((2,)))
    f(jnp.ones((3,)))
    assert [e.reason for e in jt.events] == [e.reason
                                             for e in tracker.events]
    assert jt.counts() == tracker.counts()


def test_engine_recompile_detected_on_forced_shape_change(params):
    """A prompt width the engine has not prefilled is a new executable in
    both packages: the second admission of another width is a
    shape-change rebuild of ``prefill``."""
    jp, tp = params
    eng = _lanes(tp)
    jeng = jengine.DecodeEngine(J_CFG, jp, batch=2)
    if eng.xprof is None or jeng.xprof is None:
        pytest.skip("GROVE_XPROF=0 in this environment")
    for s in (8, 12):
        eng.admit_prompts(_prompts(s=s))
        jeng.admit_prompts(jnp.asarray(_prompts(s=s)))
    for e in (eng, jeng):
        assert e.xprof.compile.counts()["prefill"] == 2
        assert e.xprof.compile.recompile_count() == 1
        fns = {f["fn"]: f for f in e.xprof.compile.payload()["fns"]}
        assert fns["prefill"]["last_reason"] == "shape-change"


def test_lanes_compile_table_matches_jax(params):
    """The lanes engine's executables by name and count: prefill, the
    single step, the K-step block and a worker's prefill."""
    jp, tp = params
    tables = []
    for pkg, eng, pw in (
            ("port", _lanes(tp, host_sync_interval=4),
             tengine.PrefillWorker(T_CFG, tp, batch=2, max_prompt=16,
                                   device="cpu")),
            ("jax", jengine.DecodeEngine(J_CFG, jp, batch=2,
                                         host_sync_interval=4),
             jengine.PrefillWorker(J_CFG, jp, batch=2, max_prompt=16))):
        prompts = _prompts()
        eng.admit_prompts(prompts if pkg == "port" else jnp.asarray(prompts),
                          max_new_tokens=12)
        eng.run(10)  # two 4-step blocks, then two single steps
        eng.release_lane(0)
        eng.release_lane(1)
        for p in _prompts(b=3, s=5, seed=4):
            eng.submit(p, max_new_tokens=3)
        for _ in range(40):
            eng.admit_from_queue(pw)
            if len(eng.completed) >= 5:
                break
            eng.step()
        tables.append({f["fn"]: (f["compiles"], f["last_reason"])
                       for f in eng.xprof.compile.payload()["fns"]})
    assert tables[0] == tables[1]
    assert set(tables[0]) == {"prefill", "step", "step_block",
                              "worker_prefill"}


def test_recompile_storm_warning():
    tracker = xprof.CompileTracker()
    for n in range(2, 2 + xprof.STORM_THRESHOLD + 3):
        tracker.note_build("f", 0.01, ((n,), "float32"))  # fresh shapes
    assert tracker.recompile_count() >= xprof.STORM_THRESHOLD + 1
    assert tracker.storms == 1            # warned once per window
    assert (xprof.STORM_WINDOW_S, xprof.STORM_THRESHOLD) == \
        (jxprof.STORM_WINDOW_S, jxprof.STORM_THRESHOLD)


# ---- memory accounting ----

def test_cpu_backend_memory_estimate_fallback(params):
    """Off the card the accounting is model-derived and says so; the bytes
    equal the JAX engine's for the same geometry."""
    jp, tp = params
    eng = _lanes(tp)
    jeng = jengine.DecodeEngine(J_CFG, jp, batch=2)
    if eng.xprof is None:
        pytest.skip("GROVE_XPROF=0 in this environment")
    eng.admit_prompts(_prompts(), max_new_tokens=4)  # _report_metric fires
    jeng.admit_prompts(jnp.asarray(_prompts()), max_new_tokens=4)
    mem = eng.xprof._last_memory
    assert mem is not None
    assert mem["source"] == "model-estimate"
    assert mem["kv_cache_bytes"] == int(eng.cache.k.nbytes
                                        + eng.cache.v.nbytes)
    assert mem["weight_bytes"] > 0
    assert 0.0 <= mem["kv_headroom"] <= 1.0
    assert mem == jeng.xprof._last_memory
    hbm = jmetrics.parse_counters(tmetrics.GLOBAL_METRICS.render(),
                                  "grove_hbm_bytes")
    scope = f"default/{eng.xprof.name}"
    assert any(dict(lbl) == {"kind": "kv_cache", "scope": scope}
               for lbl in hbm)


@pytest.mark.parametrize("kw", [dict(), dict(kv_quant="int8"),
                                dict(spec_decode=True)])
def test_paged_memory_counts_every_pool(params, kw):
    """The paged engine's KV bytes: the pool with its int8 scale pools, and
    a tiny draft's pool; equal to the JAX engine's accounting."""
    jp, tp = params
    geom = dict(batch=2, block_size=8, prefill_chunk=8)
    eng = tengine.PagedDecodeEngine(T_CFG, tp, device="cpu", **geom, **kw)
    jeng = jengine.PagedDecodeEngine(J_CFG, jp, **geom, **kw)
    mem = xprof.memory_snapshot(eng)
    want = eng.kv.pool_bytes + (eng.draft_kv.pool_bytes
                                if eng.draft_kv is not None else 0)
    assert mem["kv_cache_bytes"] == want
    assert mem["source"] == "model-estimate" and "basis" not in mem
    jmem = jxprof.memory_snapshot(jeng)
    assert mem["kv_cache_bytes"] == jmem["kv_cache_bytes"]
    if "spec_decode" not in kw:  # JAX's tiny draft has other weights
        assert mem == jmem


def test_memory_rides_the_telemetry_digest(params):
    from grove_tpu_torch.serving.slo import EngineTelemetry, samples_for_push
    _, tp = params
    tel = EngineTelemetry()
    eng = _lanes(tp, telemetry=tel)
    if eng.xprof is None:
        pytest.skip("GROVE_XPROF=0 in this environment")
    eng.admit_prompts(_prompts(), max_new_tokens=4)
    assert tel.snapshot()["memory"] is not None
    names = {s["metric"] for s in samples_for_push(tel)}
    assert {"kv_headroom_frac", "kv_cache_bytes",
            "hbm_total_bytes"} <= names


# ---- the escape hatch ----

@pytest.mark.parametrize("mode", ["lanes", "paged"])
def test_xprof_disabled_gives_no_observatory(params, monkeypatch, mode):
    """GROVE_XPROF=0 (or xprof=False): no observatory and no build noted;
    token for token the same decode as an instrumented twin."""
    _, tp = params
    prompts = _prompts()
    engines = []
    for env in ("0", "1"):
        monkeypatch.setenv("GROVE_XPROF", env)
        eng = tengine.make_engine(T_CFG, tp, mode=mode, batch=2,
                                  host_sync_interval=4, device="cpu")
        assert (eng.xprof is None) == (env == "0")
        engines.append(eng)
    assert tengine.make_engine(T_CFG, tp, mode=mode, batch=2, device="cpu",
                               xprof=False).xprof is None
    for eng in engines:
        eng.admit_prompts(prompts, max_new_tokens=12)
        eng.run(14)
    off, on = engines
    assert len(off.completed) == len(on.completed) == 2
    for a, b in zip(sorted(off.completed, key=lambda r: r.rid),
                    sorted(on.completed, key=lambda r: r.rid)):
        assert a.generated == b.generated
    assert on.xprof.compile.counts()


# ---- the device timer ----

def test_device_timer_defers_reads_and_bounds_its_queue():
    """The card's order on the CPU: nothing is read at the dispatch, every
    pair at ``resolve`` in dispatch order, and the queue never holds more
    than its capacity (the oldest pair dropped and counted)."""
    timer = xprof.DeviceTimer(torch.device("cpu"), capacity=3, defer=True)
    seen = []
    for i in range(5):
        mark = timer.start()
        timer.stop(mark, lambda s, i=i: seen.append((i, s)))
    assert seen == [] and len(timer) == 3 and timer.dropped == 2
    timer.resolve()
    assert [i for i, _ in seen] == [2, 3, 4]
    assert all(s >= 0 for _, s in seen)
    assert len(timer) == 0 and timer.resolved == 3
    eager = xprof.DeviceTimer(torch.device("cpu"))
    eager.stop(eager.start(), seen.append)
    assert len(seen) == 4 and len(eager) == 0


def test_deferred_timings_resolve_at_the_engines_fetches(params):
    """With the reading deferred, a paged engine's sampled dispatches reach
    the flight recorder only at a drain, a first-token fetch or ``sync``,
    and every one of them does."""
    _, tp = params
    obs = xprof.Observatory(sample_every=1, name="defer-test")
    eng = tengine.PagedDecodeEngine(T_CFG, tp, batch=2, block_size=8,
                                    prefill_chunk=8, host_sync_interval=4,
                                    xprof=obs, device="cpu")
    eng._timer.defer = True
    eng.warmup()                   # no build during traffic
    eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=8)
    eng.admit_from_queue()
    eng.step()                     # the first of two chunks: not read yet
    assert len(eng._timer) == 1 and obs.recorder.samples_total == 0
    eng.step()                     # the second: its token is fetched
    assert len(eng._timer) == 1    # the decode step dispatched after it
    assert obs.recorder.phase_stats()["prefill"]["count"] == 2
    eng.run(10)
    assert len(eng._timer) == 0 and eng._timer.dropped == 0
    stats = obs.recorder.phase_stats()
    assert stats["step"]["count"] == eng.steps
    assert stats["host_transfer"]["count"] >= 2


# ---- the roofline ----

def test_roofline_is_the_h100_datasheet():
    assert (xprof.PEAK_FLOPS, xprof.PEAK_HBM_BW) == (989e12, 3.35e12)
    obs = xprof.Observatory(cfg=T_CFG, batch=2, max_len=64, sample_every=1,
                            name="roofline-test")
    assert obs.backend() == {"platform": "cpu", "device_kind": "cpu",
                             "estimated": True}
    obs.record("step", 0.002, tokens=2)
    thr = obs.throughput_estimate()
    assert thr["estimated"] and "H100" in thr["basis"]
    assert thr["tokens_per_sec_est"] == 1000.0
    want = 1000.0 * xprof.decode_flops_per_token(T_CFG, 32) / 989e12
    assert thr["mfu_est"] == round(want, 6)
    assert xprof.decode_flops_per_token(T_CFG, 32) == \
        jxprof.decode_flops_per_token(J_CFG, 32)
    assert xprof.prefill_flops_per_token(T_CFG, 32) == \
        jxprof.prefill_flops_per_token(J_CFG, 32)
    assert xprof.decode_hbm_bytes_per_token(T_CFG, 64, 2, kv_quant="int8") \
        == jxprof.decode_hbm_bytes_per_token(J_CFG, 64, 2, kv_quant="int8")


def test_port_holds_no_tpu_roofline():
    text = "".join(p.read_text()
                   for p in (ROOT / "grove_tpu_torch").rglob("*.py"))
    for word in ("197e12", "819e9", "v5e"):
        assert word not in text, word


# ---- surfaces across the boundary ----

def test_port_observatory_served_by_the_jax_client(params):
    """A port observatory registered through the JAX package's registry is
    served by the JAX store client; both renderers give the same lines;
    the registry holds it weakly and zeroes its gauges when it dies."""
    from grove_tpu.runtime.errors import NotFoundError
    from grove_tpu.store.client import Client
    from grove_tpu.store.store import Store

    _, tp = params
    eng = _lanes(tp)
    if eng.xprof is None:
        pytest.skip("GROVE_XPROF=0 in this environment")
    jxprof.register(eng.xprof, "torch-twin-test")
    eng.admit_prompts(_prompts(), max_new_tokens=4)
    eng.run(8)
    client = Client(Store())
    payload = client.debug_xprof("torch-twin-test")
    assert payload["scope"] == {"namespace": "default",
                                "name": "torch-twin-test"}
    assert payload["compile"]["fns"]
    assert payload["backend"]["platform"] == "cpu"
    with pytest.raises(NotFoundError):
        client.debug_xprof("no-such-engine")
    lines = xprof.render_engine_profile(payload)
    assert lines == jxprof.render_engine_profile(payload)
    assert any(ln.strip().endswith("*") for ln in lines), lines
    assert any("compiled fn" in ln for ln in lines)
    del eng, payload
    gc.collect()
    assert jxprof.observatory_for("torch-twin-test") is None
    hbm = jmetrics.parse_counters(tmetrics.GLOBAL_METRICS.render(),
                                  "grove_hbm_bytes")
    dead = {lbl: v for lbl, v in hbm.items()
            if dict(lbl).get("scope") == "default/torch-twin-test"}
    assert dead and all(v == 0.0 for v in dead.values()), dead


def test_render_spec_and_memory_rows_match_jax(params):
    """The renderers agree on a payload with every rider (spec, memory,
    throughput, storms)."""
    _, tp = params
    eng = tengine.PagedDecodeEngine(T_CFG, tp, batch=2, block_size=8,
                                    prefill_chunk=8, spec_decode=True,
                                    device="cpu")
    for p in _prompts(b=3, s=9):
        eng.submit(p, max_new_tokens=6)
    for _ in range(200):
        eng.admit_from_queue()
        if len(eng.completed) >= 3:
            break
        eng.step()
    eng.sync()
    eng.xprof._last_memory_ts = 0.0
    eng._report_metric()
    payload = eng.xprof.payload()
    payload["compile"]["storms"] = 1
    assert payload["spec"] and payload["memory"]
    assert xprof.render_engine_profile(payload) == \
        jxprof.render_engine_profile(payload)


def test_jax_hub_receives_the_jax_engines_series(params):
    """A JAX ``MetricsHub`` given as ``metrics=`` to the port's observatory
    receives the series names and labels the JAX engine writes into one on
    the same traffic."""
    jp, tp = params
    keys = []
    for pkg in ("port", "jax"):
        hub = jmetrics.MetricsHub()
        mod = xprof if pkg == "port" else jxprof
        obs = mod.Observatory(sample_every=1, metrics=hub, name="hub-test")
        if pkg == "port":
            eng = tengine.PagedDecodeEngine(T_CFG, tp, batch=2, block_size=8,
                                            prefill_chunk=8, xprof=obs,
                                            device="cpu")
        else:
            eng = jengine.PagedDecodeEngine(J_CFG, jp, batch=2, block_size=8,
                                            prefill_chunk=8, xprof=obs)
        for p in _prompts(b=3, s=9):
            eng.submit(p, max_new_tokens=6)
        for _ in range(200):
            eng.admit_from_queue()
            if len(eng.completed) >= 3:
                break
            eng.step()
        eng.sync()
        keys.append({k for table in (hub._counters, hub._gauges,
                                     hub._hists) for k in table})
    assert keys[0] == keys[1]
    assert {k[0] for k in keys[0]} >= {"grove_compile_seconds",
                                       "grove_recompiles_total",
                                       "grove_device_step_seconds",
                                       "grove_hbm_bytes"}
