"""In-pod serving worker for the PyTorch port: the payload a PodCliqueSet
decode clique runs. The twin of serving_worker.py.

The integration contract, end to end:
- model and engine from the port: the lanes ``DecodeEngine`` (batch 2,
  max_len 64) of ``GROVE_SERVE_MODEL`` (default test-tiny), random weights
  from seed 0;
- readiness through the probe file (``GROVE_READY_FILE``) only after the
  engine is warm: on the card its decode graphs are captured (``warmup``:
  the single step and the block of ``host_sync_interval`` steps) and a
  batch is admitted and decoded (``admit_prompts`` + ``run(8)``), so the
  pod goes Ready when it can serve and no request pays a build;
- identity and config from the injected env (``GROVE_*``): it serves for
  ``GROVE_SERVE_SECONDS`` (default 120), readmitting whenever the lanes
  are idle, then prints how many decode steps it served.

It runs on the card unless asked for the CPU (``--device cpu``), and it
never falls back from one to the other. On the card it also prints the
graphs captured before ready and after serving, which are equal: nothing
is captured in traffic.

    GROVE_SERVE_MODEL=llama-1b GROVE_SERVE_SECONDS=5 \\
        python samples/workloads/serving_worker_torch.py
    GROVE_SERVE_SECONDS=2 python samples/workloads/serving_worker_torch.py \\
        --device cpu
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
                    help="cuda: the card (default); cpu: the host")
    args = ap.parse_args(argv)

    import torch

    from grove_tpu_torch.device import resolve_device
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.serving.engine import DecodeEngine

    dev = resolve_device(args.device)
    pod = os.environ.get("GROVE_POD_NAME", "?")
    model = os.environ.get("GROVE_SERVE_MODEL", "test-tiny")
    cfg = llama.CONFIGS[model]
    gen = torch.Generator(device=dev)
    params = llama.init_params(cfg, gen.manual_seed(0), dev)
    engine = DecodeEngine(cfg, params, batch=2, max_len=64, device=dev)
    # Warm the decode path BEFORE signalling ready: a pod that goes Ready
    # and then stalls its first request on a capture would defeat the
    # probe's purpose. ``warmup`` builds the single step too, which run(8)
    # does not dispatch.
    engine.warmup()
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=gen.manual_seed(1), device=dev,
                           dtype=torch.int32)
    engine.admit_prompts(prompt, max_new_tokens=16)
    engine.run(8)
    warm = engine.graphs_captured
    print(f"worker {pod}: engine warm ({model}), signalling ready",
          flush=True)
    if dev.type == "cuda":
        print(f"worker {pod}: {warm} graphs captured before ready",
              flush=True)

    ready_file = os.environ.get("GROVE_READY_FILE", "ready")
    with open(ready_file, "w") as f:
        f.write("ok")

    t0 = time.time()
    steps = 0
    while time.time() - t0 < float(os.environ.get("GROVE_SERVE_SECONDS",
                                                  120)):
        engine.run(8)
        steps += 8
        if engine.idle():
            engine.admit_prompts(prompt, max_new_tokens=16)
    engine.sync()
    print(f"served {steps} decode steps", flush=True)
    if dev.type == "cuda":
        print(f"worker {pod}: {engine.graphs_captured} graphs captured "
              f"after serving ({warm} before ready)", flush=True)


if __name__ == "__main__":
    main()
