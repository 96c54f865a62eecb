"""Request-trace smoke over the PyTorch port: a mixed workload through the
port's disaggregated pair with client-side tagging -> every serving phase
stamped -> client and engine clocks agree -> /debug/requests serves over
HTTP -> ``grovectl request-trace`` resolves a rid and exits 0. The twin of
tools/reqtrace_smoke.py, with every one of its assertions, over
``grove_tpu_torch``'s pair and its request recorder
(``serving/reqtrace.py``), registered in the JAX package's registry that
the control plane reads.

Drives the pair (one recorder shared across the seam) under an open-loop
schedule with ``--tag-requests`` semantics, then asserts at each hop:

- every completed request retired a trace whose spans tell the full story
  in causal order (queue_wait -> prefill -> handoff -> decode) and
  classified a dominant phase,
- the client-side latency rows bound the engine-side trace e2e from above,
- ``grove_request_phase_seconds{phase}`` and
  ``grove_reqtrace_dropped_total`` rendered in the port's metrics text,
- ``GET /debug/requests/<ns>/<name>`` serves the payload over the wire
  (and 404s an unknown scope),
- ``grovectl request-trace`` renders the listing AND one rid's timeline
  with the dominant phase starred, exit 0.

    python tools/reqtrace_smoke_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import (ArrivalSchedule, LoadProfile,  # noqa: E402
                           add_engine_args, build_tiny_engine, run_load,
                           serving_registries, write_request_csv)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="reqtrace-smoke-torch")
    add_engine_args(parser)
    args = parser.parse_args(argv)

    os.environ["GROVE_REQTRACE"] = "1"        # the subject of this smoke
    os.environ["GROVE_REQTRACE_SAMPLE"] = "1"  # short run: decorate all

    from grove_tpu.cli import _http
    from grove_tpu.cli import main as cli_main
    from grove_tpu.cluster import new_cluster
    from grove_tpu.runtime import metrics as m
    from grove_tpu.server import ApiServer
    from grove_tpu.topology.fleet import FleetSpec, SliceSpec
    from grove_tpu_torch.serving import reqtrace
    from grove_tpu_torch.serving.metrics import GLOBAL_METRICS
    _, registry = serving_registries()

    # ---- engine side: mixed open-loop workload over the seam ----
    eng, pw = build_tiny_engine(batch=2, engine="disagg", device=args.device,
                                model=args.model)
    rt = eng.reqtrace
    assert rt is not None, "GROVE_REQTRACE=1 but no recorder"
    assert eng.prefill.reqtrace is rt and eng.decode.reqtrace is rt, \
        "disagg tiers must share ONE recorder"
    registry.register(rt, "smoke-requests")
    eng.warmup()    # build every bucket before attributing anything

    profile = LoadProfile(duration_s=4.0, base_rate=2.0, ramp_factor=3.0)
    schedule = ArrivalSchedule.build(profile, seed=0)
    stats = run_load(eng, pw, schedule, tag_requests=True)
    assert stats.completed == stats.offered > 0, \
        (stats.completed, stats.offered)
    assert len(stats.requests) == stats.completed

    # Every trace: full story, causal order, a dominant phase.
    payload = rt.payload()
    assert payload["ring"]["finished_total"] == stats.completed
    for t in payload["traces"]:
        assert t["done"], t
        phases = [s["phase"] for s in t["spans"]]
        assert phases.index("prefill") < phases.index("handoff") \
            < phases.index("decode"), (t["rid"], phases)
        assert t["dominant"] in reqtrace.PHASES, t
    for want in ("queue_wait", "prefill", "handoff", "decode"):
        assert want in payload["phases"], \
            (want, sorted(payload["phases"]))

    # Client clock vs engine clock: same requests, opposite sides of
    # submit(); the outside view bounds the trace e2e from above.
    resolved = 0
    for row in stats.requests:
        t = rt.find(row["rid"])
        assert t is not None and t["done"], row["rid"]
        assert row["latency_s"] >= t["e2e_s"] - 1e-3, \
            (row["rid"], row["latency_s"], t["e2e_s"])
        resolved += 1
    assert resolved == stats.completed
    csv_path = os.path.join(tempfile.gettempdir(),
                            "reqtrace_smoke_torch_requests.csv")
    write_request_csv(csv_path, stats.requests)

    # ---- metrics text: the families rendered and populated ----
    # Drops are counted, never silent: overflow a 1-slot ring so the
    # counter family provably renders.
    bound = reqtrace.RequestObservatory(capacity=1, name="smoke-bound")
    for rid in (0, 1):
        bound.note_enqueue(rid, ts=1000.0)
        bound.note_done(rid, ts=1000.5)
    assert bound.dropped == 1, bound.dropped
    text = GLOBAL_METRICS.render()
    phased = m.parse_histograms(text, "grove_request_phase_seconds")
    seen = {dict(lbl).get("phase") for lbl in phased}
    assert {"queue_wait", "prefill", "handoff", "decode"} <= seen, seen
    assert "grove_reqtrace_dropped_total" in text, \
        "drop counter family missing from the metrics text"

    # ---- wire surface + CLI ----
    cluster = new_cluster(fleet=FleetSpec(slices=[
        SliceSpec(generation="v5e", topology="4x4", count=1)]))
    with cluster:
        server = ApiServer(cluster, port=0)
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, data = _http(base,
                                 "/debug/requests/default/smoke-requests")
            assert status == 200, (status, data)
            assert data["ring"]["finished_total"] == stats.completed
            status, data = _http(base, "/debug/requests/default/nosuch")
            assert status == 404, (status, data)

            rc = cli_main(["request-trace", "smoke-requests",
                           "--server", base])
            assert rc == 0, f"request-trace listing exited {rc}"
            rid = payload["slowest"][0]["rid"]
            rc = cli_main(["request-trace", "smoke-requests", str(rid),
                           "--server", base])
            assert rc == 0, f"request-trace rid {rid} exited {rc}"
        finally:
            server.stop()

    lines = reqtrace.render_request_trace(payload,
                                          payload["slowest"][0]["rid"])
    assert any(ln.endswith(" *") for ln in lines), \
        "dominant phase not starred"
    print("\n".join(lines))
    lat = sorted(r["latency_s"] for r in stats.requests)
    print(f"reqtrace smoke (torch, {args.model} on {args.device}) numbers: "
          f"client latency p50 {lat[len(lat) // 2] * 1e3:.3f} ms, p99 "
          f"{lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3:.3f} ms, "
          f"graphs captured {eng.prefill.graphs_captured}+"
          f"{eng.decode.graphs_captured}, handoffs "
          f"{eng.handoff_view()['requests']}")
    print(f"reqtrace smoke OK: {stats.completed} requests traced, "
          f"{len(payload['phases'])} phases attributed, "
          f"{resolved} client rows cross-checked ({csv_path}), "
          f"{payload['dropped']} dropped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
