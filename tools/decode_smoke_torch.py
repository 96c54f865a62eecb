"""Decode-engine smoke over the PyTorch port: the paged continuous-batching
engine's gate. The twin of tools/decode_smoke.py, with every one of its
assertions and its pinned build sets, over ``grove_tpu_torch``'s paged
engine: the contracts run in ``grove_tpu_torch/serving/decode_gate.py``,
whose copies of the workload and the pins this script first checks
against tools/decode_smoke.py's, so the two cannot drift.

Drives the paged engine through tools/decode_smoke.py's seeded
mixed-length workload and holds it to the same three contracts: the
pinned build set with zero rebuilds (a build is a CUDA graph capture on
the card, the first call of an eager bucket on the CPU), greedy tokens
equal to the lanes engine's, and every request completed with ordered
stamps over a clean allocator. Four engines run it: prefix cache off and
on, self-draft speculative decoding and int8 KV. With ``--disagg`` the
prefill -> decode pair runs instead: each tier pins its half of the
builds, nothing is built in the steady state, and the tokens are bitwise
the mono engine's.

The model runs in f32, the JAX gate's precision: the lanes and paged
engines take different attention paths, and greedy tokens are compared
exactly.

    python tools/decode_smoke_torch.py [--device cpu] [--disagg]
    python tools/decode_smoke_torch.py --model llama-1b
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import decode_smoke  # noqa: E402
from loadgen_torch import add_engine_args, model_config  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="decode-smoke-torch")
    parser.add_argument("--disagg", action="store_true",
                        help="smoke the prefill→decode pair instead of the "
                             "mono engine")
    add_engine_args(parser)
    args = parser.parse_args(argv)
    os.environ["GROVE_XPROF"] = "1"   # the compile tracker is the witness

    import torch

    from grove_tpu_torch.device import resolve_device
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.serving import decode_gate

    for name, pin in decode_gate.PINS.items():
        assert getattr(decode_smoke, name) == pin, \
            f"{name} differs from tools/decode_smoke.py's"
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(model_config(args.model), dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    label = f"{args.model} in f32 on {args.device}"
    if args.disagg:
        n = decode_gate.run_disagg(cfg, params, dev)
        pre, dec = n["builds"]
        print(f"decode smoke (torch, disagg, {label}) numbers: builds "
              f"{pre}+{dec}, graphs captured {n['graphs_captured'][0]}+"
              f"{n['graphs_captured'][1]}, handoff {n['handoff_blocks']} "
              f"blocks, {n['handoff_bytes']} B, "
              f"{n['handoff_ms_per_request']:.4f} ms/request")
        print(f"decode smoke OK (disagg): {n['completed']} requests "
              f"through the prefill→decode pair, {pre}+{dec} pinned builds "
              "(prefill tier: prefill-only; decode tier: steps + one "
              "handoff copy), 0 steady-state rebuilds on both tiers, "
              f"bitwise token parity vs mono, {n['handoff_blocks']} blocks "
              f"handed off ({n['handoff_bytes']} B, 0 deferred), "
              "allocators clean")
        return 0

    n = decode_gate.run_mono(cfg, params, dev)
    print(f"decode smoke (torch, {label}) numbers: builds {n['builds']}, "
          f"graphs captured {n['graphs_captured']}, build seconds "
          f"{n['build_seconds']:.4f}")
    print(f"decode smoke OK: {n['completed']} mixed-length requests "
          f"({sorted(decode_gate.PROMPT_LENS)} prompt lens) through the "
          "paged engine four ways (prefix cache off+on, speculative "
          "self-draft, int8 KV); "
          f"{len(decode_gate.EXPECTED_LOWERINGS)}+1+"
          f"{len(decode_gate.EXPECTED_SPEC)}+"
          f"{len(decode_gate.EXPECTED_QUANT)} pinned builds, 0 "
          "steady-state rebuilds, token parity vs lanes / cache-off "
          f"/ spec, {n['prefix_tokens_skipped']} prefix tokens skipped, "
          f"spec acceptance {n['spec_acceptance']:.2f} "
          f"({n['spec_accepted_per_dispatch']:.1f} tok/dispatch), "
          f"allocator clean ({n['allocs']} allocs, {n['preemptions']} "
          "preemptions)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
