"""Run one cell of the port's benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, the last
line of standard output; logs, and the numbers the output check compared
beside their limits, go to standard error. Exits non-zero with no result
when the machine has no CUDA card, fewer cards than the cell asks for, or
when JAX or the JAX package was loaded by the time the window closed.
``--control 1`` serves the program's int8 weights and int8 KV in place of
the cell's bf16 (the output check's control; never a benchmark run).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the wall clock (from /proc), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        boot = next(float(line.split()[1]) for line in
                    Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("unknown" without)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    why = harness.require_cards(cell["chips"])
    if why:
        print(f"bench: {args.workload}: {why}", file=sys.stderr)
        return 3
    harness.log(f"bench: {torch.cuda.get_device_name(0)}, power limit "
                f"{_power_limit()}, torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}")
    spec = json.loads((ROOT / "benchmark" / "cells" /
                       f"{args.workload}.json").read_text())
    if "runner" in spec:
        runner = harness.load_module(ROOT / "benchmark" / "runners" /
                                     f"{spec['runner']}.py")
        result = runner.run(ROOT, args, process_start=T_START)
    else:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda",
                             control=bool(args.control),
                             process_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"bench: check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
