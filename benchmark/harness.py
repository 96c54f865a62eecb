"""One run of one cell: weights from the seed, the port's default paged engine
at the cell's deployment settings, warm-up of the shapes the cell's traffic
reaches, the measured window through ``submit``/``step``, the metrics, and
the comparison with the plain reference that decides ``correct``.

Everything that belongs to one configuration, mix, cell or metric is found
by name under the benchmark's root: ``configs/<file>``,
``traffic/<mix>.json`` (whose ``kind`` names ``drivers/<kind>.py``),
``cells/<cell>.json``, ``metrics/<metric>.py`` and ``roofline/<name>.py``.
Which metrics a cell reports comes from ``BENCHMARK.json``: with
``trace`` off its end-to-end metrics, with ``trace`` on its per-layer ones.
A metric reader is ``read(r: Readings) -> float | None``; None leaves the
metric out of the line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import weights
from benchmark.observe import Account, Observer
from benchmark.reference import check as ref_check
from benchmark.reference import llama as ref_llama
from benchmark.roofline import peaks as peak_table
from benchmark.trace import Tracer, TraceData

FORBIDDEN = ("jax", "jaxlib", "flax", "grove_tpu")
# The traced slice: the window's last SLICE_SHARE, at most SLICE_MAX_S.
SLICE_SHARE = 0.1
SLICE_MAX_S = 2.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---- the specification ----

def load_spec(root: Path, workload: str) -> dict:
    """The cell's entries: its ``BENCHMARK.json`` rows, its cell file, its
    configuration and its mix."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    base = root / "benchmark"
    cell = json.loads((base / "cells" / f"{workload}.json").read_text())
    if (cell["config"], cell["traffic"]) != (w["config"], w["traffic"]):
        raise SystemExit(f"cells/{workload}.json names {cell['config']} / "
                         f"{cell['traffic']}, BENCHMARK.json "
                         f"{w['config']} / {w['traffic']}")
    return {"bench": bench, "cell": cell,
            "config": json.loads((root / conf["file"]).read_text()),
            "mix": json.loads(
                (base / "traffic" / f"{w['traffic']}.json").read_text()),
            "base": base}


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports in this kind of run."""
    e2e = bench["end_to_end"]

    def in_cell(m):
        return "workloads" not in m or workload in m["workloads"]

    if not trace:
        return [m for m in e2e if in_cell(m)]
    mine = {m["name"] for m in e2e if in_cell(m)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def load_module(path: Path):
    """The module in ``path`` (a driver, a metric reader, a roofline),
    loaded once per path."""
    name = "bench_" + re.sub(r"\W", "_", str(path.resolve()))
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def llama_config(conf: dict):
    """The port's model config for a configuration file."""
    from grove_tpu_torch.models.llama import LlamaConfig
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[conf["torch_dtype"]]
    return LlamaConfig(
        vocab_size=conf["vocab_size"], d_model=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"],
        head_dim=conf.get("head_dim", conf["hidden_size"]
                          // conf["num_attention_heads"]),
        max_seq_len=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]), dtype=dtype)


# ---- what the metrics read ----

@dataclasses.dataclass
class Readings:
    cfg: object                 # the port's LlamaConfig
    cell: dict
    mix: dict
    seconds: float
    obs: Observer
    win: dict                   # ta, t0, t1, end, setup_s, lateness_s
    slice: Account | None       # the work of the traced slice
    trace: TraceData | None
    flight: list                # the flight recorder's samples in [t0, t1]
    peaks: dict | None
    base: Path
    # The engine's own counters (``engine.payload()``: scheduler, allocator,
    # prefix cache, spec, handoff) when the window opened and closed.
    counters0: dict = dataclasses.field(default_factory=dict)
    counters1: dict = dataclasses.field(default_factory=dict)

    def roofline(self, name: str):
        return load_module(self.base / "roofline" / f"{name}.py")

    def window_tracks(self) -> list:
        return [t for t in self.obs.tracks if t.in_window]


class Slicer:
    """Starts and stops the traced slice, the window's last seconds, each
    after a sync of the engine (so that the slice holds exactly the
    dispatches made in it) and a look at the tokens."""

    def __init__(self, engine, obs: Observer, tracer: Tracer,
                 seconds: float):
        self.engine, self.obs, self.tracer = engine, obs, tracer
        self.stop = float(seconds)
        self.start = self.stop - min(SLICE_MAX_S, SLICE_SHARE * seconds)
        self.account = None
        self._m0 = None

    def tick(self, elapsed: float) -> None:
        tr = self.tracer
        if not tr.enabled or tr.done:
            return
        if not tr.active and elapsed >= self.start:
            self.engine.sync()
            self.obs.poll(time.time())
            self._m0 = (time.time(), self.engine.steps, self.engine.chunks)
            tr.start()
            log(f"bench: profiler started in {time.time() - self._m0[0]:.3f} s")
        elif tr.active and elapsed >= self.stop:
            with tr.range("bench.sync"):
                self.engine.sync()
            te = time.time()
            self.obs.poll(te)
            tr.end_slice()
            log(f"bench: slice closed in {time.time() - te:.3f} s")
            ts, s0, c0 = self._m0
            self.account = self.obs.account(ts, te, self.engine.steps - s0,
                                            self.engine.chunks - c0)


# ---- the run ----

def program_env(root: Path) -> None:
    """The program runs as the cell states it: no GROVE_* switch from the
    caller's environment, and any kernel cache inside the checkout at a
    fixed path."""
    for k in [k for k in os.environ if k.startswith("GROVE_")]:
        del os.environ[k]
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def device_info(device: torch.device, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak_bytes}


def _sample(pool: list, check: dict, seed: int) -> list:
    """The requests compared: drawn from the seed among ``pool``, the one
    with the most served tokens always among them, until ``requests`` of
    them or ``served_tokens`` tokens."""
    done = [t for t in pool if t.req.generated]
    if not done:
        return []
    done.sort(key=lambda t: (-len(t.req.generated), -t.prompt_len, t.rid))
    rng = np.random.default_rng(int(seed) % (1 << 64))
    rest = [done[i] for i in rng.permutation(np.arange(1, len(done)))]
    picked, tokens = [done[0]], len(done[0].req.generated)
    for t in rest:
        if len(picked) >= check["requests"] or \
                tokens >= check["served_tokens"]:
            break
        picked.append(t)
        tokens += len(t.req.generated)
    return [(t.req.prompt[:t.prompt_len].tolist(), list(t.req.generated))
            for t in picked]


def require_cards(n: int) -> str | None:
    """Why this machine cannot run a cell on ``n`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device; this benchmark runs only on the card"
    if torch.cuda.device_count() < n:
        return (f"the cell needs {n} cards, the machine has "
                f"{torch.cuda.device_count()}")
    return None


def build(spec: dict, seed: int, dev: torch.device, control: bool = False):
    """The cell's weights from the seed and the port's default paged engine
    at the cell's deployment settings: (cfg, params, engine). ``control``
    serves the program's int8 weights and int8 KV instead of the cell's
    bf16."""
    from grove_tpu_torch.serving.engine import make_engine
    cfg = llama_config(spec["config"])
    e = dict(spec["cell"]["engine"])
    if control:
        e["quant"], e["kv_quant"] = "int8", "int8"
    params = weights.make(cfg, seed, dev)
    engine = make_engine(
        cfg, params, batch=e["batch"], max_len=e["max_len"], mode="paged",
        device=dev, quant=e["quant"], block_size=e["block_size"],
        num_blocks=e["num_blocks"], prefill_chunk=e["prefill_chunk"],
        kv_quant=e["kv_quant"])
    return cfg, params, engine


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        process_start: float | None = None) -> dict:
    """One run; returns the result line (a dict). ``control`` runs the
    program's int8 weights and int8 KV instead of the cell's bf16: the
    precision below the configuration's, which has to come out not
    correct."""
    t_start = process_start or time.time()
    root = Path(root)
    program_env(root)
    spec = load_spec(root, workload)
    cell, mix, conf = spec["cell"], spec["mix"], spec["config"]
    dev = torch.device(device)
    cfg, params, engine = build(spec, seed, dev, control)
    driver = load_module(spec["base"] / "drivers" / f"{mix['kind']}.py")
    plan = driver.plan(mix, cell, cfg, seconds, seed)
    shapes = driver.shapes(plan, cell, engine)
    built = engine.warmup(**shapes)
    obs = Observer(engine, engine.prefill_chunk)
    if hasattr(driver, "prepare"):
        driver.prepare(engine, plan, obs)
    tracer = Tracer(trace)
    tracer.prime()
    slicer = Slicer(engine, obs, tracer, seconds)
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
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    flight = []
    if engine.xprof is not None:
        flight = [s for s in engine.xprof.recorder.snapshot()
                  if win["t0"] <= s.ts <= win["t1"]]
    kind = device_info(dev, peak)["kind"]
    td = tracer.read() if tracer.done else None
    r = Readings(cfg=cfg, cell=cell, mix=mix, seconds=seconds, obs=obs,
                 win=win, slice=slicer.account, trace=td, flight=flight,
                 peaks=peak_table.for_device(kind), base=spec["base"],
                 counters0=win["counters"][0], counters1=win["counters"][1])
    values = {}
    for m in metrics_for(spec["bench"], workload, trace):
        v = load_module(spec["base"] / "metrics" / f"{m['name']}.py").read(r)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    tracks = r.window_tracks()
    # A traffic loop may say what failed means and which requests are
    # compared; by default a window request not finished by the drain's end
    # failed, and the finished ones are compared.
    failed = getattr(driver, "failed", lambda ts: sum(
        1 for t in ts if not t.done))(tracks)
    pool = getattr(driver, "sample_pool", lambda ts: [
        t for t in ts if t.done])(tracks)
    sample = _sample(pool, cell["check"], seed)
    attempted = len(tracks)
    # The program's state goes before the reference runs: the peak is read.
    del engine, obs, slicer, r, plan, tracks, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    got = ref_check.compare(ref_llama.Config.from_file(conf), params,
                            sample, dev) if sample else None
    limit = float(cell["check"]["mean_gap"])
    correct = got is not None and got["mean_gap"] <= limit
    if got is not None:
        log(f"bench: reference over {len(sample)} requests, "
            f"{got['tokens']} served tokens ({got['off_best']} not its best, "
            f"widest gap {got['widest_gap']}) in {time.time() - t_ref:.3f} s")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(failed), "metrics": values,
              "device": device_info(dev, peak)}
    if td is not None:
        result["device"]["busy_s"] = td.busy_s
        result["device"]["window_s"] = td.window_s
        result["breakdown"] = {"device_ops": td.device_ops(),
                               "idle_gaps": td.idle_gaps[:10]}
    result["checks"] = {"mean_gap": {
        "value": None if got is None else got["mean_gap"], "limit": limit}}
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
