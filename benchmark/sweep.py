"""Find the knee of an open-loop cell: the highest arrival rate whose backlog
does not grow over a window. Builds the cell's engine once, then for each
rate serves the cell's mix at that rate (the same schedule scaled, the
cell's pre-roll before each window), drains the engine, and prints one JSON
line per rate:

    python3 benchmark/sweep.py --workload yi-1.5-9b.chat --seed 7 \\
        --seconds 40 --rates 5,6,7,8

Per rate: the requests due, those without a first token when the window
closed (the backlog), the TTFT p50/p95 of the window's first and second
halves (a backlog that grows shows as a second half far slower than the
first) and the output tokens per second. The rate a cell runs at is set
from this once, when the cell is defined; the benchmark's runs never
search for one. Like ``run.py`` it runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.observe import Observer
    from benchmark.trace import Tracer

    harness.program_env(ROOT)
    spec = harness.load_spec(ROOT, args.workload)
    why = harness.require_cards(1)
    if why:
        print(f"sweep: {why}", file=sys.stderr)
        return 3
    cell, mix = spec["cell"], dict(spec["mix"])
    if mix["kind"] != "open_loop":
        raise SystemExit("the sweep drives open-loop mixes only")
    dev = torch.device("cuda")
    cfg, _, engine = harness.build(spec, args.seed, dev)
    driver = harness.load_module(spec["base"] / "drivers" / "open_loop.py")
    off = Tracer(False)
    warmed = False
    for rate in (float(x) for x in args.rates.split(",")):
        mix.update(rate_per_s=rate, after_window_s=0.0)
        plan = driver.plan(mix, cell, cfg, args.seconds, args.seed)
        if not warmed:
            engine.warmup(**driver.shapes(plan, cell, engine))
            warmed = True
        obs = Observer(engine, engine.prefill_chunk)
        win = driver.drive(engine, plan, args.seconds, obs, off,
                           harness.Slicer(engine, obs, off, args.seconds))
        t0, t1 = win["t0"], win["t1"]
        tracks = [t for t in obs.tracks if t.in_window]
        backlog = sum(1 for t in tracks if not t.req.first_token_ts)
        tokens = obs.tokens_between(t0, t1)
        deadline = time.time() + 180
        while not all(t.done for t in obs.tracks) and time.time() < deadline:
            driver.tick(engine, obs, off)
        engine.sync()
        halves = {}
        mid = t0 + args.seconds / 2
        for name, part in (("first", [t for t in tracks if t.due < mid]),
                           ("second", [t for t in tracks if t.due >= mid])):
            ttft = [((t.req.first_token_ts or deadline) - t.due) * 1e3
                    for t in part]
            halves[name] = {"n": len(part),
                            "ttft_p50_ms": float(np.percentile(ttft, 50)),
                            "ttft_p95_ms": float(np.percentile(ttft, 95))}
        print(json.dumps({
            "rate_per_s": rate, "due": len(tracks),
            "backlog_at_close": backlog,
            "output_tokens_per_s": tokens / (t1 - t0), "halves": halves,
            "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
