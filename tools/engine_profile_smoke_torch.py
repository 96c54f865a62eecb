"""Engine-profile smoke over the PyTorch port: a port engine -> flight
recorder populated -> compile tracker shows exactly the expected builds ->
/debug/xprof renders over HTTP -> ``grovectl engine-profile`` exits 0. The
twin of tools/engine_profile_smoke.py, with every one of its assertions,
over ``grove_tpu_torch``'s lanes engine and its observatory
(``serving/xprof.py``), registered in the JAX package's registry that the
control plane reads.

Drives the lanes engine through every dispatch shape (prefill, single
steps, the fused block), then asserts at each hop:

- the decode-step flight recorder sampled real device timings (CUDA events
  on the card, the host clock on the CPU) into its bounded ring, with the
  prefill/step/host_transfer phase split,
- the compile tracker saw EXACTLY the expected builds, one prefill, one
  step, one step_block, and zero rebuilds; on the card the step and the
  block are CUDA graphs, captured once each,
- memory accounting comes from the CUDA allocator on the card (``source:
  device``) and from the model on the CPU (``source: model-estimate``),
  and the throughput block says which,
- ``grove_compile_seconds`` / ``grove_device_step_seconds`` /
  ``grove_hbm_bytes`` rendered in the port's metrics text,
- ``GET /debug/xprof/<ns>/<name>`` serves the payload over the wire,
- ``grovectl engine-profile`` renders it and exits 0.

    python tools/engine_profile_smoke_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import (add_engine_args, build_tiny_engine,  # noqa: E402
                           serving_registries)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="engine-profile-smoke-torch")
    add_engine_args(parser)
    args = parser.parse_args(argv)

    os.environ["GROVE_XPROF"] = "1"          # the subject of this smoke
    os.environ["GROVE_XPROF_SAMPLE"] = "2"   # short run: sample densely

    import numpy as np
    import torch

    from grove_tpu.cli import _http
    from grove_tpu.cli import main as cli_main
    from grove_tpu.cluster import new_cluster
    from grove_tpu.runtime import metrics as m
    from grove_tpu.server import ApiServer
    from grove_tpu.topology.fleet import FleetSpec, SliceSpec
    from grove_tpu_torch.serving import xprof
    from grove_tpu_torch.serving.metrics import GLOBAL_METRICS
    registry, _ = serving_registries()

    # ---- engine side: every dispatch shape, instrumented ----
    eng, pw = build_tiny_engine(batch=2, device=args.device,
                                model=args.model)
    on_card = eng.device.type == "cuda"
    assert eng.xprof is not None, "GROVE_XPROF=1 but no observatory"
    registry.register(eng.xprof, "smoke-engine")

    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(2, 8)).astype(np.int32)).to(eng.device)
    eng.admit_prompts(prompts, max_new_tokens=24)   # prefill build
    for _ in range(8):
        eng.step()                                  # step build
    eng.run(16)                                     # step_block build
    eng.sync()
    # Second admission cycle: the first prefill dispatch was the build
    # itself (the recorder drops build-bearing dispatches), so the warm
    # prefill is what lands in the ring.
    eng.admit_prompts(prompts, max_new_tokens=24)
    eng.run(24)
    eng.sync()

    obs = eng.xprof
    assert len(obs.recorder) > 0, "flight recorder ring is empty"
    phases = obs.recorder.phase_stats()
    for want in ("prefill", "step", "host_transfer"):
        assert want in phases and phases[want]["count"] > 0, \
            (want, phases)

    # Exactly the expected builds, nothing twice: a rebuild in this
    # fixed-shape run would be a shape leaking past the engine's buckets.
    counts = obs.compile.counts()
    assert counts == {"prefill": 1, "step": 1, "step_block": 1}, counts
    assert obs.compile.recompile_count() == 0, obs.compile.payload()
    assert obs.compile.storms == 0
    assert eng.graphs_captured == (2 if on_card else 0), \
        eng.graphs_captured

    payload = obs.payload()
    assert payload["scope"]["name"] == "smoke-engine"
    mem = payload["memory"]
    source = "device" if on_card else "model-estimate"
    assert mem is not None and mem["source"] == source, mem
    assert mem["kv_cache_bytes"] > 0 and mem["weight_bytes"] > 0
    assert payload["throughput"] is not None \
        and payload["throughput"]["estimated"] == (not on_card), \
        payload["throughput"]

    # ---- metrics text: the families rendered and populated ----
    text = GLOBAL_METRICS.render()
    comp = m.parse_histograms(text, "grove_compile_seconds")
    assert comp, "grove_compile_seconds missing from the metrics text"
    dev = m.parse_histograms(text, "grove_device_step_seconds")
    assert any(dict(lbl).get("phase") == "step" for lbl in dev), dev
    hbm = m.parse_counters(text, "grove_hbm_bytes")
    assert any(dict(lbl).get("kind") == "kv_cache" and v > 0
               for lbl, v in hbm.items()), hbm

    # ---- wire surface + CLI ----
    cluster = new_cluster(fleet=FleetSpec(slices=[
        SliceSpec(generation="v5e", topology="4x4", count=1)]))
    with cluster:
        server = ApiServer(cluster, port=0)
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, data = _http(base, "/debug/xprof/default/smoke-engine")
            assert status == 200, (status, data)
            assert data["scope"]["name"] == "smoke-engine"
            assert data["compile"]["fns"], data["compile"]
            status, data = _http(base, "/debug/xprof/default/nosuch")
            assert status == 404, (status, data)

            rc = cli_main(["engine-profile", "smoke-engine",
                           "--server", base])
            assert rc == 0, f"grovectl engine-profile exited {rc}"
        finally:
            server.stop()

    lines = xprof.render_engine_profile(payload)
    assert any("*" in ln for ln in lines), "hottest phase not starred"
    print("\n".join(lines))
    step = phases["step"]
    print(f"engine-profile smoke (torch, {args.model} on {args.device}) "
          f"numbers: builds {counts}, graphs captured "
          f"{eng.graphs_captured}, build seconds "
          f"{payload['compile']['total_seconds']:.4f}, step p50 "
          f"{step['p50_ms']} ms over {step['count']} samples, "
          f"memory source {mem['source']}")
    print(f"engine-profile smoke OK: {len(obs.recorder)} ring samples, "
          f"{sum(counts.values())} builds "
          f"({payload['compile']['total_seconds']:.2f}s), 0 rebuilds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
