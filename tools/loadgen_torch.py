"""The open-loop load generator over the PyTorch port's engines: the twin of
tools/loadgen.py's ``build_tiny_engine`` and its command line.

The arrival model (``LoadProfile``, ``ArrivalSchedule``), the wall-clock
replay (``run_load``) and the per-request CSV (``write_request_csv``) are
tools/loadgen.py's own: they touch the engine only through its serving
interface and import no JAX, so this module reuses them. What differs is
the engine behind them: ``build_tiny_engine`` builds the
``grove_tpu_torch`` lanes engine, paged engine or disaggregated pair, with
tools/loadgen.py's geometry, on the card unless ``device`` says otherwise.

``serving_registries`` gives the twins the JAX package's xprof and
reqtrace registries, which the control plane's debug surfaces read,
without importing JAX.

    python tools/loadgen_torch.py --device cpu --duration 10 --engine paged
    python tools/loadgen_torch.py --model llama-1b --engine disagg
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from loadgen import (ArrivalSchedule, LoadProfile, LoadStats,  # noqa: E402
                     run_load, write_request_csv)

__all__ = ["ArrivalSchedule", "LoadProfile", "LoadStats", "run_load",
           "write_request_csv", "build_tiny_engine", "model_config",
           "serving_registries"]


def serving_registries():
    """``grove_tpu.serving.xprof`` and ``grove_tpu.serving.reqtrace``: the
    registries behind the control plane's ``/debug/xprof`` and
    ``/debug/requests`` (and grovectl's renderers), which import them from
    ``grove_tpu.serving``. Neither module imports JAX, but their package's
    ``__init__`` imports the JAX engines. Where the package is not imported
    yet, it is entered as itself with its ``__init__`` deferred: a
    submodule imports alone, and the first other name asked of the package
    runs its ``__init__`` then, as a plain import would have."""
    name = "grove_tpu.serving"
    if name not in sys.modules:
        spec = importlib.util.find_spec(name)
        pkg = importlib.util.module_from_spec(spec)

        def deferred(attr: str):
            if attr.startswith("__"):
                raise AttributeError(attr)
            if importlib.util.find_spec(f"{name}.{attr}") is not None:
                return importlib.import_module(f"{name}.{attr}")
            del pkg.__getattr__
            spec.loader.exec_module(pkg)
            return getattr(pkg, attr)

        pkg.__getattr__ = deferred
        sys.modules[name] = pkg
        sys.modules["grove_tpu"].serving = pkg
    return (importlib.import_module(name + ".xprof"),
            importlib.import_module(name + ".reqtrace"))


def model_config(model: str = "test-tiny"):
    """The served model at tools/loadgen.py's 64-token context: test-tiny in
    f32, as the JAX tools serve it; another model in its own dtype."""
    import torch

    from grove_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS[model], max_seq_len=64)
    if model == "test-tiny":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg


def build_tiny_engine(batch: int = 2, telemetry=None, engine: str = "lanes",
                      device=None, model: str = "test-tiny"):
    """tools/loadgen.py's engine + prefiller pair over the port: a
    ``PrefillWorker`` (max prompt 32) beside the lanes engine (``"lanes"``),
    the paged engine (``"paged"``: block 8, chunk 8; the prefiller is then
    a call-site convenience, as chunked prefill runs in the engine) or the
    disaggregated pair (``"disagg"``, the same geometry on both tiers).
    Random weights from seed 0, made on ``device`` (None: the card)."""
    import torch

    from grove_tpu_torch.device import resolve_device
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.serving.engine import (DecodeEngine,
                                                PagedDecodeEngine,
                                                PrefillWorker, make_disagg)

    dev = resolve_device(device)
    cfg = model_config(model)
    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    pw = PrefillWorker(cfg, params, batch=batch, max_prompt=32, device=dev)
    if engine == "paged":
        eng = PagedDecodeEngine(cfg, params, batch=batch, block_size=8,
                                prefill_chunk=8, host_sync_interval=4,
                                telemetry=telemetry, device=dev)
    elif engine == "disagg":
        eng = make_disagg(cfg, params, batch=batch, block_size=8,
                          prefill_chunk=8, host_sync_interval=4,
                          telemetry=telemetry, device=dev)
    elif engine == "lanes":
        eng = DecodeEngine(cfg, params, batch=batch, host_sync_interval=4,
                           telemetry=telemetry, device=dev)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return eng, pw


def add_engine_args(parser: argparse.ArgumentParser) -> None:
    """The twins' shared flags: ``--device`` and ``--model``."""
    from grove_tpu_torch.models import llama
    parser.add_argument("--device", default="cuda",
                        help="torch device the engines run on (default "
                             "cuda; cpu runs the plain versions)")
    parser.add_argument("--model", default="test-tiny",
                        choices=sorted(llama.CONFIGS),
                        help="served model, random weights (default "
                             "test-tiny, in f32)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="loadgen-torch")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--base-rate", type=float, default=2.0)
    parser.add_argument("--ramp", type=float, default=4.0,
                        help="peak rate as a multiple of --base-rate")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--engine", choices=("lanes", "paged", "disagg"),
                        default="lanes")
    parser.add_argument("--disagg", action="store_true",
                        help="shorthand for --engine disagg")
    parser.add_argument("--shared-prefix", action="store_true",
                        help="90/10 shared/cold prompts over a fixed "
                        "system-prompt pool (implies --engine paged)")
    parser.add_argument("--shared-frac", type=float, default=0.9)
    parser.add_argument("--tag-requests", action="store_true",
                        help="stamp client-side send/done times per "
                        "request and report the outside view of latency")
    parser.add_argument("--tag-csv", default=None, metavar="PATH",
                        help="with --tag-requests: write the per-request "
                        "latency rows as CSV")
    add_engine_args(parser)
    args = parser.parse_args(argv)
    if args.disagg:
        args.engine = "disagg"
    if args.shared_prefix and args.engine == "lanes":
        args.engine = "paged"   # only the paged engines have the cache

    from grove_tpu_torch.serving.slo import EngineTelemetry

    tel = EngineTelemetry()
    eng, pw = build_tiny_engine(batch=args.batch, telemetry=tel,
                                engine=args.engine, device=args.device,
                                model=args.model)
    if args.engine in ("paged", "disagg"):
        # Build every bucket (a CUDA graph on the card) before offering
        # load, as a deployment would.
        eng.warmup()
    profile = LoadProfile(duration_s=args.duration,
                          base_rate=args.base_rate,
                          ramp_factor=args.ramp,
                          shared_prefix=args.shared_prefix,
                          shared_frac=args.shared_frac)
    if args.shared_prefix:
        # Prefix + suffix + new tokens inside the 64-token context.
        profile = dataclasses.replace(profile, max_prompt=12)
    schedule = ArrivalSchedule.build(profile, seed=args.seed)
    print(f"offering {len(schedule.offsets)} requests over "
          f"{args.duration:.0f}s ({args.base_rate:.1f} -> "
          f"{args.base_rate * args.ramp:.1f} req/s) to the {args.engine} "
          f"engine, {args.model} on {args.device}")
    stats = run_load(eng, pw, schedule, telemetry=tel,
                     tag_requests=args.tag_requests)
    s = tel.snapshot()
    print(f"completed {stats.completed}/{stats.offered} "
          f"({stats.tokens} tokens, {stats.tokens_per_sec:.1f} tok/s)")
    print(f"TTFT p50/p99: {s['ttft_p50_s'] * 1e3:.1f}/"
          f"{s['ttft_p99_s'] * 1e3:.1f} ms   "
          f"TPOT p50/p99: {s['tpot_p50_s'] * 1e3:.2f}/"
          f"{s['tpot_p99_s'] * 1e3:.2f} ms   "
          f"queue-wait p99: {s['queue_wait_p99_s'] * 1e3:.1f} ms")
    if getattr(eng, "_prefix", None) is not None:
        p = eng.prefix_stats()
        print(f"prefix cache: hit-rate {p['hit_rate']:.2f}, "
              f"{p['cached_blocks']} cached blocks, "
              f"{p['tokens_matched_total']} tokens matched, "
              f"{p['cow_copies']} CoW copies")
    if args.tag_requests and stats.requests:
        lat = sorted(r["latency_s"] for r in stats.requests)
        print(f"client-side latency ({len(lat)} tagged): "
              f"p50 {lat[len(lat) // 2] * 1e3:.1f} ms, p99 "
              f"{lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3:.1f} ms")
        if args.tag_csv:
            write_request_csv(args.tag_csv, stats.requests)
            print(f"wrote {len(stats.requests)} rows to {args.tag_csv}")
    if args.engine == "disagg":
        h = eng.handoff_view()
        print(f"handoff: {h['requests']} requests, {h['blocks']} cold + "
              f"{h['shared_blocks']} shared blocks, {h['bytes']} bytes "
              f"moved, {h['ms_per_request']:.2f} ms/request, "
              f"{h['deferred']} deferred")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
