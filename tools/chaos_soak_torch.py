"""Chaos front door for the PyTorch port's data plane: the twin of
tools/chaos_soak.py for the one scenario that drives serving engines,
``prefill-replica-kill`` (grove_tpu_torch/chaos/scenario.py). The
control-plane scenarios (the fault mix, leader-kill, roll-wedge) drive no
engine: tools/chaos_soak.py runs them. The run's report is printed as
JSON, then tools/chaos_soak.py's OK line; a broken invariant raises.

    python tools/chaos_soak_torch.py --scenario prefill-replica-kill
    python tools/chaos_soak_torch.py --scenario prefill-replica-kill \\
        --device cpu --seed 3
    python tools/chaos_soak_torch.py --list
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import add_engine_args  # noqa: E402

SCENARIOS = {
    "prefill-replica-kill": "kill the disaggregated prefill tier "
                            "mid-handoff; decode allocator stays clean, "
                            "requests re-prefill bitwise-identical",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="chaos-soak-torch",
        description="data-plane fault injection over the port's engines")
    parser.add_argument("--scenario", default=None,
                        help="named scenario (see --list)")
    parser.add_argument("--seed", type=int, default=0,
                        help="RNG seed: the repro handle")
    parser.add_argument("--list", action="store_true",
                        help="list scenarios")
    add_engine_args(parser)
    args = parser.parse_args(argv)

    if args.list:
        print("scenarios:")
        for name, what in SCENARIOS.items():
            print(f"  {name:22s} {what}")
        return 0
    if args.scenario not in SCENARIOS:
        parser.error("pick --scenario NAME (see --list)")

    from grove_tpu_torch.chaos import run_prefill_replica_kill

    # The invariants (allocator check() on both sides, rid-keyed bitwise
    # token parity vs a mono run) are asserted inside the scenario:
    # reaching the print means green.
    report = run_prefill_replica_kill(seed=args.seed, model=args.model,
                                      device=args.device)
    print(json.dumps(report, indent=2))
    print(f"prefill-replica-kill OK: {report['rescued']} rescued "
          f"({report['outbox_at_kill']} mid-handoff, "
          f"{report['blocks_in_flight']} blocks in flight), "
          f"{report['completed']}/{report['prompts']} requests "
          f"bitwise-identical to mono, allocators clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
