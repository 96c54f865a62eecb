"""Serving-SLO smoke over the PyTorch port: a port engine -> one batched
push -> /debug/serving. The twin of tools/serving_smoke.py, with every one
of its assertions, over ``grove_tpu_torch``'s engine, telemetry
(``serving/slo.py``) and push client (``serving/metrics_push.py``); the
control plane that receives the push is the JAX package's, which imports
no JAX.

Drives a handful of requests through the lanes engine (test-tiny by
default) with ``EngineTelemetry`` attached, then walks the signal path a
deployed engine's pod walks, asserting at each hop:

- the request-lifecycle histograms (queue-wait, TTFT, TPOT, e2e)
  populated from real completions,
- ONE batched ``POST /metrics/push`` carried the whole SLO digest and
  the server accepted every sample,
- the ServingObserver aggregated the scope and ``GET /debug/serving``
  serves it (SLO judged against the scope's autoscaling target, KV
  headroom derived, reporter liveness counted),
- ``grove_serving_*`` gauges rendered in the control plane's /metrics
  text, and
- ``grovectl serving-status`` renders the payload.

    python tools/serving_smoke_torch.py [--device cpu] [--model llama-1b]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import (ArrivalSchedule, LoadProfile,  # noqa: E402
                           add_engine_args, build_tiny_engine, run_load)


def wait_for(predicate, timeout: float, desc: str) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {desc}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="serving-smoke-torch")
    parser.add_argument("--timeout", type=float, default=30.0)
    add_engine_args(parser)
    args = parser.parse_args(argv)

    from grove_tpu.api import PodCliqueScalingGroup, new_meta
    from grove_tpu.api.podcliqueset import AutoScalingConfig
    from grove_tpu.api.scalinggroup import PodCliqueScalingGroupSpec
    from grove_tpu.cli import _http
    from grove_tpu.cluster import new_cluster
    from grove_tpu.runtime import metrics as m
    from grove_tpu.runtime.servingwatch import (render_serving_status,
                                                serving_observer_for)
    from grove_tpu.server import ApiServer
    from grove_tpu.topology.fleet import FleetSpec, SliceSpec
    from grove_tpu_torch.serving.metrics_push import push_samples
    from grove_tpu_torch.serving.slo import (HISTOGRAMS, EngineTelemetry,
                                             samples_for_push)

    # ---- engine side: a handful of real requests, stamped ----
    tel = EngineTelemetry()
    eng, pw = build_tiny_engine(batch=2, telemetry=tel, device=args.device,
                                model=args.model)
    profile = LoadProfile(duration_s=2.0, base_rate=4.0, ramp_factor=1.0,
                          max_new_tokens=8)
    schedule = ArrivalSchedule.build(profile, seed=7)
    stats = run_load(eng, pw, schedule, telemetry=tel)
    assert stats.completed == stats.offered > 0, \
        f"engine wedged: {stats.completed}/{stats.offered} completed"
    for name in HISTOGRAMS:
        assert tel.hist_count(name) > 0, \
            f"{name} histogram empty after {stats.completed} completions"
    digest = tel.snapshot()
    assert digest["ttft_p99_s"] > 0 and digest["tokens_total"] > 0, digest

    # ---- control plane: batched push -> observer -> debug surface ----
    cluster = new_cluster(fleet=FleetSpec(slices=[
        SliceSpec(generation="v5e", topology="4x4", count=1)]))
    with cluster:
        # The scope the engine reports for, with a generous TTFT target so
        # the SLO judgment reads "ok" (the breach path is the benchmark's).
        cluster.client.create(PodCliqueScalingGroup(
            meta=new_meta("smoke-sg"),
            spec=PodCliqueScalingGroupSpec(
                clique_names=["decode"], replicas=1, min_available=1,
                auto_scaling=AutoScalingConfig(
                    min_replicas=1, max_replicas=3,
                    metric="ttft_p99_ms", target_value=60_000.0))))
        server = ApiServer(cluster, port=0)
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            samples = samples_for_push(tel)
            assert push_samples(samples, kind="PodCliqueScalingGroup",
                                name="smoke-sg", server=base), \
                "batched /metrics/push rejected"
            wait_for(lambda: cluster.metrics.get(
                "PodCliqueScalingGroup", "smoke-sg", "ttft_p99_ms")
                is not None, args.timeout, "registry recorded the batch")

            obs = serving_observer_for(cluster.manager.store)
            assert obs is not None, "serving observer not registered"
            obs.sweep()

            status, payload = _http(base, "/debug/serving/default/smoke-sg")
            assert status == 200, (status, payload)
            scope = payload["scopes"][0]
            assert scope["kind"] == "PodCliqueScalingGroup"
            got = set(scope["metrics"])
            want = {s["metric"] for s in samples}
            assert want <= got, f"missing signals: {want - got}"
            assert scope["metrics"]["ttft_p99_ms"]["agg"] == "max"
            assert scope["metrics"]["queue_depth"]["agg"] == "sum"
            assert scope["kv_headroom"] is not None
            slo = scope["slo"]
            assert slo and slo["metric"] == "ttft_p99_ms" \
                and not slo["breached"], slo

            text = cluster.manager.metrics_text()
            sig = m.parse_counters(text, "grove_serving_signal")
            assert any(dict(lbl).get("metric") == "ttft_p99_ms"
                       for lbl in sig), "grove_serving_signal missing"
            assert m.parse_counters(text, "grove_serving_reporters"), text

            lines = render_serving_status(payload)
            assert any("ttft_p99_ms" in ln for ln in lines), lines
            assert any("[ok]" in ln for ln in lines), lines
        finally:
            server.stop()

    print("\n".join(lines))
    print(f"serving smoke (torch, {args.model} on {args.device}) numbers: "
          f"TTFT p50 {digest['ttft_p50_s'] * 1e3:.3f} ms, TTFT p99 "
          f"{digest['ttft_p99_s'] * 1e3:.3f} ms, TPOT p99 "
          f"{digest['tpot_p99_s'] * 1e3:.3f} ms, lanes graphs captured "
          f"{getattr(eng, 'graphs_captured', 0)}")
    print(f"serving smoke OK: {stats.completed} requests, "
          f"{digest['tokens_total']} tokens, TTFT p99 "
          f"{digest['ttft_p99_s'] * 1e3:.1f} ms, "
          f"{len(samples)} samples in one push")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
