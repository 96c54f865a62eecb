"""Multi-host torch.distributed worker: bootstraps a process group purely
from the grove env contract and runs a global all-reduce. The twin of
allreduce_worker.py for the PyTorch port.

This is the template for what a port workload does on a gang of hosts:
worker identity from TPU_WORKER_ID, world membership from
TPU_WORKER_HOSTNAMES, the rendezvous at worker 0 (GROVE_COORD_HOST and
GROVE_COORD_PORT override it; single-machine deployments and tests use
loopback). The group is NCCL over the card by default; ``--device cpu``
asks for the CPU and gloo. The mesh is the port's own
(grove_tpu_torch/parallel/mesh.py), one dp axis over the workers.

    TPU_WORKER_ID=0 TPU_WORKER_HOSTNAMES=localhost GROVE_HOLD_SECONDS=0 \
        python samples/workloads/allreduce_worker_torch.py
"""

import argparse
import os
import sys
import time

# The script runs from the repo root or anywhere else; the port is
# imported from the checkout that holds this file.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL over the card (default); cpu: gloo")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from grove_tpu_torch.device import resolve_device
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh

    wid = int(os.environ["TPU_WORKER_ID"])
    hosts = os.environ["TPU_WORKER_HOSTNAMES"].split(",")
    n = len(hosts)
    coord_host = os.environ.get("GROVE_COORD_HOST", hosts[0])
    coord_port = os.environ.get("GROVE_COORD_PORT", "12355")
    dev = resolve_device(args.device)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coord_host}:{coord_port}",
        world_size=n, rank=wid)
    try:
        mesh = build_mesh(MeshPlan(dp=n))
        # Each worker contributes (wid + 1); the group must agree on the sum.
        x = torch.full((1, 4), float(wid + 1), device=dev)
        result = float(mesh.comm("dp").all_reduce(x)[0, 0])

        out_dir = os.environ.get("GROVE_OUT_DIR")
        if out_dir:
            # Atomic publish: readers poll for this file, so it must never
            # be observable in a created-but-empty state.
            final = os.path.join(out_dir, f"result-{wid}.txt")
            tmp = final + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{result}\n")
            os.replace(tmp, final)
        print(f"worker {wid}/{n} ({dist.get_backend()}): all_reduce = "
              f"{result}", flush=True)

        time.sleep(float(os.environ.get("GROVE_HOLD_SECONDS", "120")))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
