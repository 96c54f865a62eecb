"""The port's serving SLO telemetry (grove_tpu_torch/serving/slo.py and
metrics_push.py) held against the JAX package's on the same inputs.

- twins of tests/test_serving_slo.py's engine-side cases: ``observe_request``
  in full, with one token and with stamps missing; ``samples_for_push``'s
  aggregation modes; the lanes engine's lifecycle stamps end to end; the
  TTFT split and its compatibility mode;
- the port's digest equals JAX's sample for sample on the same requests,
  and the batched push posts it (to a local stand-in for the control
  plane).

Engine histograms against the JAX engines on the same traffic are in
tests/test_torch_reqtrace.py (the engine matrix).
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.serving import slo as jslo
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving import metrics_push
from grove_tpu_torch.serving.slo import (HISTOGRAMS, EngineTelemetry,
                                         samples_for_push)

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)


class _Req:
    """Stamp-bearing stand-in for serving.engine.Request."""

    def __init__(self, enqueue=0.0, admit=0.0, first=0.0, done=0.0,
                 n_gen=1, rid=-1):
        self.enqueue_ts = enqueue
        self.admit_ts = admit
        self.first_token_ts = first
        self.done_ts = done
        self.generated = list(range(n_gen))
        self.rid = rid


def _both(*reqs):
    """The port's and JAX's telemetry fed the same requests."""
    tels = (EngineTelemetry(), jslo.EngineTelemetry())
    for tel in tels:
        for r in reqs:
            tel.observe_request(r)
    return tels


@pytest.fixture(scope="module")
def tp():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ---- engine-side telemetry ----

def test_observe_request_derives_all_latencies():
    tel, jtel = _both(_Req(enqueue=100.0, admit=102.0, first=102.0,
                           done=105.0, n_gen=10, rid=3))
    assert tel.requests_completed == 1
    for name in HISTOGRAMS:
        assert tel.hist_count(name) == 1, name
    assert tel.quantile("queue_wait_seconds", 0.5) == pytest.approx(
        2.0, rel=0.5)
    assert tel.quantile("ttft_seconds", 0.5) == pytest.approx(2.0, rel=0.5)
    s = tel.snapshot()
    assert s["e2e_p99_s"] >= s["ttft_p99_s"] > 0
    assert 0.25 <= s["tpot_p99_s"] <= 0.5
    assert s == jtel.snapshot()
    assert s["exemplars"]["ttft_seconds"] == {"rid": 3, "value_s": 2.0}


def test_observe_request_single_token_skips_tpot():
    tel, jtel = _both(_Req(enqueue=1.0, admit=1.1, first=1.1, done=1.2,
                           n_gen=1))
    assert tel.hist_count("tpot_seconds") == 0
    assert tel.hist_count("ttft_seconds") == 1
    assert tel.snapshot() == jtel.snapshot()


def test_observe_request_missing_stamps_degrade_to_zero_not_negative():
    tel, jtel = _both(_Req(enqueue=0.0, admit=50.0, first=50.0, done=51.0,
                           n_gen=4))
    assert tel.hist_count("queue_wait_seconds") == 1
    assert tel.quantile("queue_wait_seconds", 0.99) <= \
        HISTOGRAMS["queue_wait_seconds"][0]
    assert tel.snapshot() == jtel.snapshot()


def test_histogram_catalog_equals_jax():
    assert HISTOGRAMS == jslo.HISTOGRAMS


def _riders(tel):
    tel.sample_gauges(queue_depth=7, kv_utilization=0.5)
    tel.sample_memory({"kv_headroom": 0.25, "kv_cache_bytes": 1024,
                       "total_bytes": 4096})
    tel.sample_prefix({"hit_rate": 0.5, "cached_blocks": 3,
                       "reclaimed_bytes": 64})
    tel.sample_spec({"acceptance_rate": 0.75, "accepted_per_dispatch": 2.5,
                     "accepted_tokens": 30})
    tel.sample_handoff({"blocks": 5, "bytes": 640, "ms_per_request": 0.4})
    tel.sample_phases({"decode": {"p99_ms": 3.0},
                       "prefill": {"p99_ms": 1.5}})
    tel.add_tokens(8)


@pytest.mark.parametrize("riders", [False, True])
def test_samples_for_push_carries_aggregation_modes(riders):
    tel, jtel = _both(_Req(enqueue=1.0, admit=1.2, first=1.2, done=2.0,
                           n_gen=8))
    for t in (tel, jtel):
        if riders:
            _riders(t)
        else:
            t.sample_gauges(queue_depth=7, kv_utilization=0.5)
    samples = samples_for_push(tel)
    by_name = {s["metric"]: s for s in samples}
    assert by_name["queue_depth"]["agg"] == "sum"
    assert by_name["queue_depth"]["value"] == 7.0
    assert by_name["kv_utilization"]["agg"] == "avg"
    assert by_name["ttft_p99_ms"]["agg"] == "max"
    assert by_name["ttft_p50_ms"]["agg"] == "avg"
    assert by_name["tokens_total"]["agg"] == "sum"
    assert by_name["ttft_p99_ms"]["value"] > 0
    if riders:
        assert by_name["request_phase_p99_ms:decode"]["agg"] == "max"
        assert by_name["handoff_bytes"]["value"] == 640.0
    assert samples == jslo.samples_for_push(jtel)


def _drive_lanes(eng, pw, want: int) -> None:
    for _ in range(100):
        eng.admit_from_queue(pw)
        if len(eng.completed) >= want:
            break
        if np.count_nonzero(eng._active):
            eng.step()
    assert len(eng.completed) == want


def test_engine_stamps_lifecycle_end_to_end(tp):
    """The lanes engine fed by a PrefillWorker: submit -> queue -> admit ->
    decode -> complete, every stamp in order and every histogram
    populated."""
    tel = EngineTelemetry()
    eng = tengine.DecodeEngine(T_CFG, tp, batch=2, telemetry=tel,
                               device="cpu")
    pw = tengine.PrefillWorker(T_CFG, tp, batch=2, max_prompt=16,
                               device="cpu")
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, 256, size=5), max_new_tokens=6)
            for _ in range(4)]
    assert tel.queue_depth == 4  # gauges sampled on submit
    _drive_lanes(eng, pw, len(rids))
    for req in eng.completed:
        assert req.enqueue_ts <= req.admit_ts <= req.first_token_ts \
            <= req.done_ts
    for name in HISTOGRAMS:
        assert tel.hist_count(name) == len(rids), name
    s = tel.snapshot()
    assert s["tokens_total"] == sum(len(r.generated) for r in eng.completed)
    assert s["requests_completed"] == len(rids)
    assert eng.kv_lane_utilization == 0.0


def test_ttft_stamp_split_and_compat(tp, monkeypatch):
    """By default admit_ts is queue exit and first_token_ts prefill
    completion; GROVE_TTFT_COMPAT=1 fuses them."""

    def drive(compat: bool):
        monkeypatch.setenv("GROVE_TTFT_COMPAT", "1" if compat else "0")
        eng = tengine.DecodeEngine(T_CFG, tp, batch=2, device="cpu")
        pw = tengine.PrefillWorker(T_CFG, tp, batch=2, max_prompt=16,
                                   device="cpu")
        rng = np.random.default_rng(3)
        eng.submit(rng.integers(0, 256, size=8), max_new_tokens=4)
        _drive_lanes(eng, pw, 1)
        return eng.completed[0]

    req = drive(compat=False)
    assert req.enqueue_ts <= req.admit_ts < req.first_token_ts
    old = drive(compat=True)
    assert old.admit_ts == old.first_token_ts
    # The split lands in the histograms: queue wait (enqueue -> admit)
    # excludes the prefill, TTFT (enqueue -> first token) includes it.
    tel = EngineTelemetry()
    tel.observe_request(req)
    means = tel.snapshot()["means"]
    assert means["ttft_seconds"] > means["queue_wait_seconds"]


def test_paged_engine_ttft_split_and_compat(tp, monkeypatch):
    """The paged engine's first token is stamped by the chunk that samples
    it, after queue exit; the compatibility mode fuses the two."""
    for compat in (False, True):
        monkeypatch.setenv("GROVE_TTFT_COMPAT", "1" if compat else "0")
        eng = tengine.PagedDecodeEngine(T_CFG, tp, batch=2, block_size=8,
                                        prefill_chunk=8, device="cpu")
        eng.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=3)
        for _ in range(50):
            eng.admit_from_queue()
            if eng.completed:
                break
            eng.step()
        eng.sync()
        req = eng.completed[0]
        if compat:
            assert req.admit_ts == req.first_token_ts
        else:
            assert req.enqueue_ts <= req.admit_ts < req.first_token_ts


# ---- the batched push ----

class _Sink(http.server.BaseHTTPRequestHandler):
    bodies: list = []

    def do_POST(self):  # noqa: N802 - the handler's API
        n = int(self.headers["Content-Length"])
        _Sink.bodies.append((self.path, json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


def test_push_samples_posts_the_digest(monkeypatch):
    """One POST per push, carrying every sample with its aggregation mode,
    to the control plane named by the environment (a local stand-in)."""
    server = http.server.HTTPServer(("127.0.0.1", 0), _Sink)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        _Sink.bodies.clear()
        monkeypatch.setenv("GROVE_CONTROL_PLANE",
                           f"http://127.0.0.1:{server.server_port}")
        monkeypatch.setenv("GROVE_PCSG_NAME", "llama")
        monkeypatch.setenv("GROVE_POD_NAME", "pod-0")
        tel, _ = _both(_Req(enqueue=1.0, admit=1.2, first=1.3, done=2.0,
                            n_gen=4))
        assert metrics_push.push_samples(samples_for_push(tel))
        assert metrics_push.push_metric("queue_depth", 3.0)
        (path, body), (_, single) = _Sink.bodies
        assert path == "/metrics/push"
        assert body["kind"] == "PodCliqueScalingGroup"
        assert body["name"] == "llama" and body["reporter"] == "pod-0"
        assert [s["metric"] for s in body["samples"]] == \
            [s["metric"] for s in samples_for_push(tel)]
        assert single["metric"] == "queue_depth" and single["value"] == 3.0
    finally:
        server.shutdown()
        server.server_close()


def test_push_without_scope_or_server_is_a_no_op(monkeypatch):
    for var in ("GROVE_CONTROL_PLANE", "GROVE_PCSG_NAME", "GROVE_PCLQ_NAME"):
        monkeypatch.delenv(var, raising=False)
    assert not metrics_push.push_samples([{"metric": "x", "value": 1.0}])
    monkeypatch.setenv("GROVE_PCLQ_NAME", "clq")
    assert not metrics_push.push_metric("x", 1.0)  # no control plane


def test_telemetry_pump_stops():
    stop = threading.Event()
    t = metrics_push.start_telemetry_pump(EngineTelemetry(), interval=0.01,
                                          stop=stop)
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
