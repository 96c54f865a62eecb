"""The runner of a cell whose configuration is a Mixtral-shaped MoE (the
cell file's ``"runner": "moe"``): one run as ``harness.run`` makes it, with
the MoE's build and reference in place of the Llama ones.

- ``build``: the port's ``MoeConfig`` from the configuration file
  (``num_local_experts``, ``num_experts_per_tok``), the weights of
  ``weights_moe.py`` from the seed, and the port's default paged engine at
  the cell's deployment settings (``make_engine(mode="paged")``: the same
  engine, scheduler, paged cache, chunked prefill and CUDA graphs as the
  Llama cells; the decoder runs each layer's routed experts in the MLP's
  place). ``sweep.py``'s knee search takes it in place of
  ``harness.build``.
- The control (``--control 1``): int8 KV, int8 weights on the projections
  the W8A16 kernel reads, and the experts rounded through int8 in place
  (``weights_moe.round_experts_int8_``), served in bf16 since no kernel reads
  int8 experts. Its reference then reads weights made anew from the seed.
- The reference: ``reference/mixtral.py``, float32, after the program's
  state is freed.

Everything else is the harness's: the specification, the program's
environment, the traffic loop of the mix's kind, the observer, the traced
slice, the metrics the cell lists, the sample compared and the result
line. Without a card the command stops before this runner is loaded.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, weights_moe
from benchmark.observe import Observer
from benchmark.reference import mixtral as ref_mixtral
from benchmark.roofline import peaks as peak_table
from benchmark.trace import Tracer

log = harness.log


def moe_config(conf: dict):
    """The port's ``MoeConfig`` for a configuration file."""
    import dataclasses

    from grove_tpu_torch.models.moe import MoeConfig
    base = harness.llama_config(conf)
    return MoeConfig(**{f.name: getattr(base, f.name)
                        for f in dataclasses.fields(base)},
                     n_experts=conf["num_local_experts"],
                     experts_per_token=conf["num_experts_per_tok"])


def build(spec: dict, seed: int, dev: torch.device, control: bool = False):
    """The cell's weights from the seed and the port's default paged engine
    at the cell's deployment settings: (cfg, params, engine). ``control``
    serves the int8 control instead (see the module's docstring)."""
    from grove_tpu_torch.serving.engine import make_engine
    cfg = moe_config(spec["config"])
    e = dict(spec["cell"]["engine"])
    params = weights_moe.make(cfg, seed, dev)
    if control:
        e["quant"], e["kv_quant"] = "int8", "int8"
        weights_moe.round_experts_int8_(params)
    engine = make_engine(
        cfg, params, batch=e["batch"], max_len=e["max_len"], mode="paged",
        device=dev, quant=e["quant"], block_size=e["block_size"],
        num_blocks=e["num_blocks"], prefill_chunk=e["prefill_chunk"],
        kv_quant=e["kv_quant"])
    return cfg, params, engine


def run(root: Path, args, process_start: float | None = None,
        device: str = "cuda") -> dict:
    """One run of ``args.workload`` (``run.py``'s arguments); returns the
    result line."""
    t_start = process_start or time.time()
    root = Path(root)
    harness.program_env(root)
    workload, seed, seconds = args.workload, args.seed, args.seconds
    trace, control = bool(args.trace), bool(args.control)
    spec = harness.load_spec(root, workload)
    cell, mix = spec["cell"], spec["mix"]
    dev = torch.device(device)
    cfg, params, engine = build(spec, seed, dev, control)
    driver = harness.load_module(spec["base"] / "drivers" /
                                 f"{mix['kind']}.py")
    plan = driver.plan(mix, cell, cfg, seconds, seed)
    shapes = driver.shapes(plan, cell, engine)
    built = engine.warmup(**shapes)
    obs = Observer(engine, engine.prefill_chunk)
    if hasattr(driver, "prepare"):
        driver.prepare(engine, plan, obs)
    tracer = Tracer(trace)
    tracer.prime()
    slicer = harness.Slicer(engine, obs, tracer, seconds)
    captured0 = engine.graphs_captured
    win = driver.drive(engine, plan, seconds, obs, tracer, slicer)
    stop_s = tracer.finish()
    if tracer.done:
        log(f"bench: profiler stopped after the loop in {stop_s:.3f} s")
    win["setup_s"] = win["ta"] - t_start
    log(f"bench: setup {win['setup_s']:.3f} s (warm-up built {built} "
        f"graphs: {shapes}); pre-roll {win['t0'] - win['ta']:.3f} s, window "
        f"{win['t1'] - win['t0']:.3f} s, drain to "
        f"{win['end'] - win['t0']:.3f} s")
    pool = obs.pool(win["t0"], win["t1"])
    if pool:
        cap = pool["capacity"]
        log(f"bench: KV pool in the window: blocks in use peak "
            f"{pool['used_peak']} ({100 * pool['used_peak'] / cap:.1f}%), "
            f"mean {pool['used_mean']:.0f} "
            f"({100 * pool['used_mean'] / cap:.1f}%), prefix cache peak "
            f"{pool['cached_peak']}, of {cap} over {pool['samples']} "
            "samples")
    if win["lateness_s"]:
        lat = np.array(win["lateness_s"]) * 1e3
        log(f"bench: generator lateness ms p50 {np.percentile(lat, 50):.3f} "
            f"p99 {np.percentile(lat, 99):.3f} max {lat.max():.3f} over "
            f"{len(lat)} submits")
    if engine.graphs_captured != captured0:
        log(f"bench: WARNING {engine.graphs_captured - captured0} graphs "
            "captured after warm-up")
    moe0, moe1 = (c.get("moe") for c in win["counters"])
    if moe0 and moe1:
        n = moe1["dispatches"] - moe0["dispatches"]
        touched = moe1["experts_touched"] - moe0["experts_touched"]
        by_expert = [b - a for a, b in zip(moe0["assignments"],
                                           moe1["assignments"])]
        log(f"bench: expert layer in the window: {n} dispatches, experts "
            f"touched {touched / max(1, n):.3f} a dispatch, assignments by "
            f"expert {by_expert}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    flight = []
    if engine.xprof is not None:
        flight = [s for s in engine.xprof.recorder.snapshot()
                  if win["t0"] <= s.ts <= win["t1"]]
    info = harness.device_info(dev, peak)
    td = tracer.read() if tracer.done else None
    r = harness.Readings(
        cfg=cfg, cell=cell, mix=mix, seconds=seconds, obs=obs, win=win,
        slice=slicer.account, trace=td, flight=flight,
        peaks=peak_table.for_device(info["kind"]), base=spec["base"],
        counters0=win["counters"][0], counters1=win["counters"][1])
    values = {}
    for m in harness.metrics_for(spec["bench"], workload, trace):
        v = harness.load_module(spec["base"] / "metrics" /
                                f"{m['name']}.py").read(r)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    tracks = r.window_tracks()
    failed = getattr(driver, "failed", lambda ts: sum(
        1 for t in ts if not t.done))(tracks)
    pool = getattr(driver, "sample_pool", lambda ts: [
        t for t in ts if t.done])(tracks)
    sample = harness._sample(pool, cell["check"], seed)
    attempted = len(tracks)
    # The program's state goes before the reference runs: the peak is read.
    del engine, obs, slicer, r, plan, tracks, pool
    if control:  # the served experts were rounded in place
        del params
        gc.collect()
        params = weights_moe.make(cfg, seed, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    got = ref_mixtral.compare(ref_mixtral.Config.from_file(spec["config"]),
                              params, sample, dev) if sample else None
    limit = float(cell["check"]["mean_gap"])
    correct = got is not None and got["mean_gap"] <= limit
    if got is not None:
        log(f"bench: reference over {len(sample)} requests, "
            f"{got['tokens']} served tokens ({got['off_best']} not its best, "
            f"widest gap {got['widest_gap']}; router near-ties, the k-th and "
            f"next logit within {ref_mixtral.NEAR_TIE}, in "
            f"{100 * got['near_ties']:.3f}% of (layer, position) rows) in "
            f"{time.time() - t_ref:.3f} s")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(failed), "metrics": values, "device": info}
    if td is not None:
        result["device"]["busy_s"] = td.busy_s
        result["device"]["window_s"] = td.window_s
        result["breakdown"] = {"device_ops": td.device_ops(),
                               "idle_gaps": td.idle_gaps[:10]}
    result["checks"] = {"mean_gap": {
        "value": None if got is None else got["mean_gap"], "limit": limit}}
    return result
