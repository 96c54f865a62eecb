"""The port's request observatory (grove_tpu_torch/serving/reqtrace.py), and
every observatory of the port's engines held against the JAX package's on
the same traffic.

- Twins of tests/test_reqtrace.py's cases (all but its overhead pin: the
  overhead is measured on the card, ``chip_smoke.py`` phase 12): the ring's
  bounds and odometer, slowest-K retention, the live cap, the span cap,
  the sampling cadence, preempt/resume attribution, the mono engine's full
  lifecycle, one trace across the disaggregated seam and across
  ``replace_prefill``, a preemption storm rendered, exemplar linkage,
  GROVE_REQTRACE=0, and the debug surface;
- the recorders themselves: the same seam calls give equal payloads, and
  both renderers render them line for line;
- **the engine matrix**: the same requests through the JAX engine and the
  port engine (mono, disaggregated, speculative, under preemption, across
  ``replace_prefill``, and the lanes engine), with every observatory on in
  both: per request id the (phase, label) span sequences are equal, the
  TTFT/TPOT/queue-wait/e2e histogram counts are equal, the deltas of the
  spec and handoff counters on each package's ``GLOBAL_METRICS`` are equal,
  the compile tables (names and counts, every tier) are equal, and the
  port's tokens with its observatories on equal JAX's and its own with
  them off. The port runs with its device timer deferred, which rehearses
  the card's order (spans read at the next fetch) on the CPU.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.runtime.metrics import GLOBAL_METRICS as J_METRICS
from grove_tpu.serving import engine as jengine
from grove_tpu.serving import reqtrace as jreqtrace
from grove_tpu.serving import slo as jslo
from grove_tpu.serving import xprof as jxprof
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving import reqtrace, slo, xprof
from grove_tpu_torch.serving.metrics import GLOBAL_METRICS as T_METRICS

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
GEOM = dict(batch=4, block_size=8, prefill_chunk=8, host_sync_interval=4)
COUNTERS = ("grove_spec_accepted_tokens", "grove_spec_draft_tokens",
            "grove_handoff_blocks_total", "grove_handoff_bytes_total")


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def drive(eng, want: int, max_iters: int = 3000) -> None:
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        eng.step()
    eng.sync()
    assert len(eng.completed) >= want, (len(eng.completed), want)


def mixed_prompts(seed: int, n: int = 5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 28, size=n)
    return [rng.integers(1, T_CFG.vocab_size, size=int(k)).astype(np.int32)
            for k in lens]


def synth_request(rec, rid, e2e=0.01):
    """One request through the seam hooks with synthetic stamps."""
    t0 = 1000.0 + rid
    rec.note_enqueue(rid, ts=t0, prompt_len=8, max_new_tokens=4)
    rec.note_admit(rid, ts=t0 + 0.001)
    rec.note_prefill_done(rid, ts=t0 + 0.004)
    rec.note_decode_start(rid, ts=t0 + 0.004)
    rec.note_done(rid, ts=t0 + e2e)


# ---- recorder unit behavior ----

def test_ring_bounded_and_odometer_counts():
    rec = reqtrace.RequestObservatory(capacity=8, slowest_k=4,
                                      name="ring-test")
    for rid in range(50):
        synth_request(rec, rid)
    p = rec.payload()
    assert p["ring"]["len"] == 8
    assert p["ring"]["finished_total"] == 50
    assert p["dropped"] == 42
    assert [t["rid"] for t in p["traces"]] == list(range(42, 50))


def test_slowest_k_survives_ring_churn():
    rec = reqtrace.RequestObservatory(capacity=4, slowest_k=2,
                                      name="slowest-test")
    synth_request(rec, 0, e2e=9.0)
    synth_request(rec, 1, e2e=5.0)
    for rid in range(2, 40):
        synth_request(rec, rid, e2e=0.01)
    assert [t.rid for t in rec._slowest] == [0, 1]
    got = rec.find(0)
    assert got is not None and got["e2e_s"] == pytest.approx(9.0)
    assert got["dominant"] == "decode"


def test_live_cap_drops_submit_storms():
    rec = reqtrace.RequestObservatory(live_cap=4, name="livecap-test")
    for rid in range(10):
        rec.note_enqueue(rid, ts=1000.0)
    assert len(rec._live) == 4
    assert rec.dropped == 6


def test_span_cap_keeps_accumulating_phases():
    t = reqtrace.RequestTrace(1, 0.0)
    for i in range(reqtrace.SPAN_CAP + 100):
        t.add_span("decode", "segment", float(i), 0.001)
    assert len(t.spans) == reqtrace.SPAN_CAP
    assert t.dropped_spans == 100
    assert t.phase_seconds["decode"] == pytest.approx(
        (reqtrace.SPAN_CAP + 100) * 0.001)


def test_sampling_cadence_matches_xprof_shape():
    rec = reqtrace.RequestObservatory(sample_every=4, name="cadence")
    fired = [rec.should_sample() for _ in range(12)]
    assert fired == [True, False, False, False] * 3


def test_preempt_resume_attributes_recovery_time():
    rec = reqtrace.RequestObservatory(name="preempt-unit")
    t0 = 1000.0
    rec.note_enqueue(7, ts=t0)
    rec.note_admit(7, ts=t0 + 0.001)
    rec.note_prefill_done(7, ts=t0 + 0.002)
    rec.note_decode_start(7, ts=t0 + 0.002)
    rec.note_preempt(7, ts=t0 + 0.003)
    rec.note_resume(7, ts=t0 + 0.503)
    rec.note_done(7, ts=t0 + 0.504)
    got = rec.find(7)
    assert got["dominant"] == "preempt_recompute"
    assert got["phases"]["preempt_recompute"] == pytest.approx(0.5)
    names = [s["label"] for s in got["spans"]]
    assert names.index("preempted (capacity)") < names.index("resumed")


def _seam_calls(rec):
    """Every seam hook, with fixed stamps: queue, prefix, chunk, prefill,
    handoff, decode, spec window, preemption, recompute, completion."""
    rec.note_enqueue(1, ts=10.0, prompt_len=20, max_new_tokens=5)
    rec.note_admit(1, ts=10.5)
    with mock.patch("time.time", return_value=10.55):
        rec.note_prefix(1, 1, 3, 8)
    with mock.patch("time.time", return_value=10.85):
        rec.note_chunk(1, 4, 0.25, 8)  # spans 10.6 .. 10.85
    rec.note_prefill_done(1, ts=11.0)
    rec.note_handoff(1, 11.0, ts=11.2, blocks=3, nbytes=96, shared=1)
    rec.note_decode_start(1, ts=11.2)
    with mock.patch("time.time", return_value=11.3):
        rec.note_spec_window(1, 5, 2, 3)
    rec.note_preempt(1, ts=11.5)
    rec.note_resume(1, ts=12.5)
    rec.note_done(1, ts=13.0)
    rec.note_enqueue(2, ts=10.2)
    rec.note_admit(2, ts=10.3)
    rec.note_done(2, ts=10.4)


def test_recorders_agree_on_the_same_seam_calls():
    """The same seam calls give equal payloads in both packages, and both
    renderers render them line for line."""
    recs = (reqtrace.RequestObservatory(name="seam-test"),
            jreqtrace.RequestObservatory(name="seam-test"))
    for rec in recs:
        _seam_calls(rec)
    payloads = [r.payload() for r in recs]
    assert payloads[0] == payloads[1]
    for rid in (1, 2, 404):
        assert reqtrace.render_request_trace(payloads[0], rid) == \
            jreqtrace.render_request_trace(payloads[0], rid)
    assert payloads[0]["phases"]["preempt_recompute"]["count"] == 1


# ---- engine integration ----

def test_mono_engine_traces_full_lifecycle(params):
    _, tp = params
    rec = reqtrace.RequestObservatory(sample_every=1, name="mono-test")
    eng = tengine.PagedDecodeEngine(T_CFG, tp, reqtrace=rec, device="cpu",
                                    **GEOM)
    prompts = mixed_prompts(21, n=3)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    drive(eng, len(prompts))
    p = rec.payload()
    assert p["ring"]["finished_total"] == len(prompts)
    for t in p["traces"]:
        assert t["done"] and t["e2e_s"] > 0
        assert {"queue_wait", "prefill", "decode"} <= set(t["phases"])
        kinds = [s["label"] for s in t["spans"]]
        assert any(k.startswith("chunk[") for k in kinds)
        assert t["dominant"] in reqtrace.PHASES
    stats = rec.phase_stats()
    assert stats["decode"]["count"] == len(prompts)
    assert sum(d["dominant"] for d in stats.values()) == len(prompts)


def test_disagg_one_trace_spans_the_seam(params):
    _, tp = params
    dis = tengine.make_disagg(T_CFG, tp, device="cpu",
                              reqtrace=reqtrace.RequestObservatory(
                                  sample_every=1, name="disagg-test"),
                              **GEOM)
    assert dis.reqtrace is dis.prefill.reqtrace is dis.decode.reqtrace
    prompts = mixed_prompts(22, n=3)
    for p in prompts:
        dis.submit(p, max_new_tokens=6)
    drive(dis, len(prompts))
    for t in dis.reqtrace.payload()["traces"]:
        phases = [s["phase"] for s in t["spans"]]
        assert phases.index("prefill") < phases.index("handoff") \
            < phases.index("decode"), phases
        assert "handoff" in t["phases"]


def test_trace_continuity_across_replace_prefill(params):
    _, tp = params
    rec = reqtrace.RequestObservatory(sample_every=1, name="chaos-test")
    dis = tengine.make_disagg(T_CFG, tp, reqtrace=rec, device="cpu", **GEOM)
    prompts = mixed_prompts(23, n=6)
    for p in prompts:
        dis.submit(p, max_new_tokens=6)
    for _ in range(2):
        dis.admit_from_queue()
        dis.step()
    replacement = tengine.PrefillEngine(T_CFG, tp, device="cpu", **GEOM)
    rescued = dis.replace_prefill(replacement)
    assert rescued > 0, "kill landed after all work shipped"
    assert dis.prefill is replacement
    assert dis.prefill.reqtrace is rec
    assert dis.prefill._sched.reqtrace is rec
    drive(dis, len(prompts))
    p = rec.payload()
    assert p["ring"]["finished_total"] == len(prompts)
    assert {t["rid"] for t in p["traces"]} == \
        {r.rid for r in dis.completed}
    for t in p["traces"]:
        phases = [s["phase"] for s in t["spans"]]
        assert phases.index("prefill") < phases.index("handoff") \
            < phases.index("decode"), (t["rid"], phases)


def test_preemption_storm_attributes_recompute_with_renderable_trace(
        params):
    _, tp = params
    rec = reqtrace.RequestObservatory(name="storm-test")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=6).astype(np.int32)
               for _ in range(4)]
    eng = tengine.PagedDecodeEngine(T_CFG, tp, batch=4, max_len=40,
                                    block_size=4, num_blocks=13,
                                    prefill_chunk=4, host_sync_interval=2,
                                    reqtrace=rec, device="cpu")
    eng.submit(prompts[0].copy(), max_new_tokens=12)
    drive(eng, 1)
    for p in prompts:
        eng.submit(p, max_new_tokens=12)
    drive(eng, len(prompts) + 1)
    assert eng._sched.preemptions_total > 0, "pool not tight enough"
    payload = rec.payload()
    victims = [t for t in payload["traces"]
               if "preempt_recompute" in t["phases"]]
    assert victims, "preemptions left no trace"
    storm = max(victims, key=lambda t: t["phases"]["preempt_recompute"])
    assert storm["phases"]["preempt_recompute"] > 0, storm["phases"]
    assert storm["dominant"] in reqtrace.PHASES
    text = "\n".join(reqtrace.render_request_trace(payload, storm["rid"]))
    assert f"rid {storm['rid']}" in text
    assert "preempt_recompute" in text and " *" in text
    starred = [ln for ln in text.splitlines() if ln.endswith(" *")]
    assert any(storm["dominant"] in ln for ln in starred)
    assert text.splitlines() == jreqtrace.render_request_trace(
        payload, storm["rid"])


def test_slo_exemplar_resolves_to_trace(params):
    _, tp = params
    tel = slo.EngineTelemetry()
    rec = reqtrace.RequestObservatory(name="exemplar-test")
    eng = tengine.PagedDecodeEngine(T_CFG, tp, telemetry=tel, reqtrace=rec,
                                    device="cpu", **GEOM)
    prompts = mixed_prompts(24, n=4)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    drive(eng, len(prompts))
    snap = tel.snapshot()
    assert snap["exemplars"], "no exemplars tracked"
    for name, ex in snap["exemplars"].items():
        assert rec.find(ex["rid"]) is not None, (name, ex)
    assert snap["phases"] and "decode" in snap["phases"]


def test_reqtrace_off_is_token_identical(params, monkeypatch):
    _, tp = params
    prompts = mixed_prompts(25, n=4)

    def run(env):
        monkeypatch.setenv("GROVE_REQTRACE", env)
        eng = tengine.PagedDecodeEngine(T_CFG, tp, device="cpu", **GEOM)
        if env == "0":
            assert eng.reqtrace is None
            assert eng._sched.reqtrace is None
        else:
            assert eng.reqtrace is not None
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        drive(eng, len(prompts))
        return {r.rid: list(r.generated) for r in eng.completed}

    assert run("0") == run("1")


def test_disagg_reqtrace_off_all_tiers_dark(params, monkeypatch):
    _, tp = params
    monkeypatch.setenv("GROVE_REQTRACE", "0")
    dis = tengine.make_disagg(T_CFG, tp, device="cpu", **GEOM)
    assert dis.reqtrace is None
    assert dis.prefill.reqtrace is None
    assert dis.decode.reqtrace is None
    prompts = mixed_prompts(26, n=2)
    for p in prompts:
        dis.submit(p, max_new_tokens=4)
    drive(dis, len(prompts))


def test_make_disagg_gives_xprof_to_the_decode_tier(params):
    """JAX's rule: ``xprof`` goes to the decode tier, the prefill tier makes
    its own; one request recorder and one telemetry span both tiers."""
    _, tp = params
    obs = xprof.Observatory(name="tier-test")
    tel = slo.EngineTelemetry()
    dis = tengine.make_disagg(T_CFG, tp, xprof=obs, telemetry=tel,
                              device="cpu", **GEOM)
    assert dis.xprof is obs is dis.decode.xprof
    assert dis.prefill.xprof is not None and dis.prefill.xprof is not obs
    assert dis.telemetry is tel is dis.prefill.telemetry
    assert dis.prefill.reqtrace is dis.decode.reqtrace is not None


# ---- surfaces across the boundary ----

def test_port_recorder_served_by_the_jax_client():
    from grove_tpu.runtime.errors import NotFoundError
    from grove_tpu.store.client import Client
    from grove_tpu.store.store import Store
    rec = reqtrace.RequestObservatory(name="torch-twin-test",
                                      namespace="default")
    jreqtrace.register(rec)
    synth_request(rec, 3)
    client = Client(Store())
    payload = client.debug_requests("torch-twin-test")
    assert payload["scope"] == {"namespace": "default",
                                "name": "torch-twin-test"}
    assert payload["ring"]["finished_total"] == 1
    assert jreqtrace.render_request_trace(payload, 3) == \
        reqtrace.render_request_trace(payload, 3)
    with pytest.raises(NotFoundError):
        client.debug_requests("no-such-recorder")


def test_render_missing_rid_reports_retention():
    rec = reqtrace.RequestObservatory(name="render-miss")
    lines = reqtrace.render_request_trace(rec.payload(), 404)
    assert any("no trace retained" in ln for ln in lines)


def test_jax_hub_receives_the_recorders_series():
    """A JAX ``MetricsHub`` as the recorder's ``metrics=`` gets the series
    the JAX recorder writes on the same seam calls."""
    from grove_tpu.runtime.metrics import MetricsHub
    keys = []
    for mod in (reqtrace, jreqtrace):
        hub = MetricsHub()
        rec = mod.RequestObservatory(capacity=1, metrics=hub,
                                     name="hub-test")
        _seam_calls(rec)
        keys.append((dict(hub._counters),
                     {k: (h.count, h.sum) for k, h in hub._hists.items()}))
    assert keys[0] == keys[1]
    assert keys[0][0]  # the ring's eviction was counted


# ---- the engine matrix ----

def _draft(jp):
    """A tiny draft of the same weights in both packages (acceptance
    counters then agree)."""
    dcfg = jllama.draft_config(J_CFG)
    dp = jllama.init_params(dcfg, jax.random.PRNGKey(5))
    return ((dcfg, dp),
            (tllama.draft_config(T_CFG),
             params_from_numpy(jax.tree.map(np.asarray, dp), device="cpu")))


SCENARIOS = ("mono", "disagg", "spec", "spec_self", "preempt", "replace",
             "lanes")
# The JAX pair's handoff copy jits the module-level paged_block_copy, whose
# executable cache every engine of the process shares: each handoff
# scenario takes a table width (max_len) of its own, so that JAX builds
# its copy there as a fresh process would.
HANDOFF_MAX_LEN = {"disagg": 56, "replace": 48}


def _build(pkg: str, scenario: str, params, draft, obs=True):
    """(engine, the observatories) of one scenario in one package; the
    port's with its device timer deferred."""
    jp, tp = params
    port = pkg == "port"
    eng_mod = tengine if port else jengine
    cfg, p = (T_CFG, tp) if port else (J_CFG, jp)
    dev = {"device": "cpu"} if port else {}
    if obs:
        rt_mod, xp_mod, slo_mod = (reqtrace, xprof, slo) if port else \
            (jreqtrace, jxprof, jslo)
        o = dict(reqtrace=rt_mod.RequestObservatory(sample_every=1),
                 xprof=xp_mod.Observatory(sample_every=2),
                 telemetry=slo_mod.EngineTelemetry())
    else:
        o = dict(reqtrace=False, xprof=False, telemetry=None)
    geom = dict(GEOM)
    if scenario == "lanes":
        eng = eng_mod.DecodeEngine(cfg, p, batch=2, host_sync_interval=4,
                                   **o, **dev)
        eng._worker = eng_mod.PrefillWorker(cfg, p, batch=2, max_prompt=32,
                                            **dev)
    elif scenario in HANDOFF_MAX_LEN:
        eng = eng_mod.make_disagg(cfg, p, **o, **geom, **dev,
                                  max_len=HANDOFF_MAX_LEN[scenario])
    else:
        if scenario == "spec":
            geom.update(spec_decode=True, spec_k=3,
                        draft_params=draft[1] if port else draft[0])
        if scenario == "spec_self":
            geom.update(spec_decode=True, spec_k=3, draft_params="self")
        if scenario == "preempt":
            geom.update(batch=4, max_len=40, block_size=4, num_blocks=13,
                        prefill_chunk=4, host_sync_interval=2)
        eng = eng_mod.PagedDecodeEngine(cfg, p, **o, **geom, **dev)
    if port and obs:
        for e in _tiers(eng):
            e._timer.defer = True
    return eng, o


def _tiers(eng):
    return (eng.prefill, eng.decode) if hasattr(eng, "prefill") else (eng,)


def _serve(pkg: str, scenario: str, params, draft, obs=True) -> dict:
    eng, o = _build(pkg, scenario, params, draft, obs)
    metrics = T_METRICS if pkg == "port" else J_METRICS
    before = {c: metrics.counter_total(c) for c in COUNTERS}
    prompts = mixed_prompts(31, n=6)
    new = 12 if scenario == "preempt" else 6
    if scenario == "lanes":
        for q in prompts:
            eng.submit(q, max_new_tokens=new)
        for _ in range(400):
            eng.admit_from_queue(eng._worker)
            if len(eng.completed) >= len(prompts):
                break
            eng.step()
        eng.sync()
    else:
        for q in prompts:
            eng.submit(q, max_new_tokens=new)
        if scenario == "replace":
            for _ in range(2):
                eng.admit_from_queue()
                eng.step()
            ml = HANDOFF_MAX_LEN[scenario]
            fresh = (tengine.PrefillEngine(T_CFG, params[1], device="cpu",
                                           max_len=ml, **GEOM)
                     if pkg == "port" else
                     jengine.PrefillEngine(J_CFG, params[0], max_len=ml,
                                           **GEOM))
            assert eng.replace_prefill(fresh) > 0
        drive(eng, len(prompts))
    out = {"tokens": {r.rid: list(r.generated) for r in eng.completed}}
    if not obs:
        return out
    if scenario == "preempt":
        assert eng._sched.preemptions_total > 0
    out["spans"] = {t["rid"]: [(s["phase"], s["label"]) for s in t["spans"]]
                    for t in o["reqtrace"].payload()["traces"]}
    snap = o["telemetry"].snapshot()
    out["hists"] = (snap["counts"], snap["requests_completed"],
                    snap["tokens_total"])
    out["counters"] = {c: metrics.counter_total(c) - before[c]
                       for c in COUNTERS}
    out["compile"] = [{f["fn"]: f["compiles"]
                       for f in t.xprof.compile.payload()["fns"]}
                      for t in _tiers(eng)]
    return out


@pytest.fixture(scope="module")
def matrix(params):
    draft = _draft(params[0])
    return {s: {"jax": _serve("jax", s, params, draft),
                "port": _serve("port", s, params, draft),
                "off": _serve("port", s, params, draft, obs=False)}
            for s in SCENARIOS}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_tokens_match_jax_and_observatories_off(matrix, scenario):
    m = matrix[scenario]
    assert m["port"]["tokens"] == m["jax"]["tokens"] == m["off"]["tokens"]
    assert len(m["port"]["tokens"]) == 6


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_span_sequences_match_jax(matrix, scenario):
    m = matrix[scenario]
    assert m["port"]["spans"] == m["jax"]["spans"]
    assert sorted(m["port"]["spans"]) == sorted(m["port"]["tokens"])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_histogram_counts_match_jax(matrix, scenario):
    m = matrix[scenario]
    assert m["port"]["hists"] == m["jax"]["hists"]
    assert m["port"]["hists"][1] == 6


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_counter_deltas_match_jax(matrix, scenario):
    m = matrix[scenario]
    assert m["port"]["counters"] == m["jax"]["counters"]
    moved = {c for c, v in m["port"]["counters"].items() if v}
    # A random tiny draft is accepted by no one; the target drafting for
    # itself by everyone.
    want = {"spec": {"grove_spec_draft_tokens"},
            "spec_self": {"grove_spec_accepted_tokens",
                          "grove_spec_draft_tokens"},
            "disagg": {"grove_handoff_blocks_total",
                       "grove_handoff_bytes_total"},
            "replace": {"grove_handoff_blocks_total",
                        "grove_handoff_bytes_total"}}.get(scenario, set())
    assert want <= moved


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_compile_tables_match_jax(matrix, scenario):
    m = matrix[scenario]
    assert m["port"]["compile"] == m["jax"]["compile"]
    assert all(m["port"]["compile"])
