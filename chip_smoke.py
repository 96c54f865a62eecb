#!/usr/bin/env python3
"""Drive the PyTorch port (grove_tpu_torch) once on one CUDA card.

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile every kernel from grove_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the parity shapes (f32 and bf16, strided views among them), the
     serving shape and a long prompt, with times, bounds and the library
     call's time at the last two, and each build's registers, spills and
     shared memory;
  4. serve: llama-1b at full width and depth (random weights from --seed)
     through make_engine(mode="lanes") with int8 weights: queued requests
     admitted through a PrefillWorker, then the bench posture
     (admit_prompts + run(64)); the kernel launch counts are read from
     this phase alone; then a torch.profiler pass over one in-engine
     prefill and one run(8) window gives the kernels by device time and
     the device's busy share;
  5. model: llama-1b prefill logits through the kernel vs the plain
     attention formulation.
The last two lines are the kernel table as JSON and the result object.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# Data-sheet peaks of one H100 SXM (dense): device memory rate, and the
# tensor-core rate for each input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

SERVE_SHAPE = (32, 128, 16, 8, 128)       # b, s, h, n_kv, d of llama-1b prefill
LONG_SHAPE = (2, 2048, 16, 8, 128)        # a long prompt: bound by operations
PARITY_SHAPES = [                         # b, s, h, n_kv, d, dtype
    (2, 64, 4, 2, 32, "float32"),
    (1, 128, 8, 8, 16, "float32"),        # MHA
    (2, 32, 4, 1, 8, "float32"),          # MQA, one q tile
    (3, 200, 8, 1, 64, "float32"),        # ragged length, MQA
    (2, 77, 12, 4, 128, "bfloat16"),      # ragged length, GQA (g = 3)
    (2, 64, 4, 2, 8, "bfloat16"),         # d = 8 (test-tiny's head dim)
    (2, 128, 8, 8, 64, "bfloat16"),       # MHA, d = 64
    (3, 200, 8, 1, 64, "bfloat16"),       # MQA, ragged over 4 k tiles
    (1, 300, 4, 1, 128, "bfloat16"),      # MQA, ragged over 5 k tiles
    (2, 96, 4, 4, 32, "bfloat16"),        # MHA, d = 32
]
STRIDED_SHAPE = (2, 160, 8, 2, 128)       # q, k, v as views of one tensor
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # f32: summation order; bf16: one output rounding


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


SLEEP_CYCLES = 50_000_000  # about 25 ms of device spin at H100 clocks


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call: ``iters`` calls queued behind a spin kernel, so
    that the window between the events holds device work only and not the
    host's dispatch of each call. Logs when the spin did not cover the
    dispatch (the window then holds host time too)."""
    import torch
    for _ in range(warmup):
        fn()
    ready = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ready.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if ready.elapsed_time(start) < host_ms:
        log(f"time: spin {ready.elapsed_time(start):.2f} ms did not cover "
            f"{host_ms:.2f} ms of dispatch; the time below includes host")
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 20) -> float:
    """Host microseconds per call of dispatch (the device may lag)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def flash_bound_ms(b, s, h, n_kv, d, dtype) -> tuple[float, str]:
    """Least time for one call: each input read once and the output written
    once at the memory rate, against the causal QK^T and PV operations at
    the input type's peak."""
    import torch
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = b * s * (2 * h + 2 * n_kv) * d * elt
    pairs = b * h * s * (s + 1) // 2
    ops = 4 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qkv(gen, b, s, h, n_kv, d, dtype):
    import torch
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, n_kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, n_kv, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


def check_flash(q, k, v, label: str, dt: str) -> float:
    """The kernel against its plain version on the same inputs."""
    import torch
    from grove_tpu_torch.ops.flash import (flash_causal_attention,
                                           flash_causal_attention_ref)
    out = flash_causal_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_causal_attention_ref(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), rtol=TOL[dt], atol=TOL[dt])
    log(f"kernels: flash {dt} {label} max_abs_err={err:.3e} tol={TOL[dt]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees at {label} {dt}")
    return err


def time_flash(q, k, v, label: str, card: str) -> dict:
    """Kernel, plain and library (scaled_dot_product_attention) device ms
    per call, the bound, and the wrapper's host dispatch per call."""
    import torch
    import torch.nn.functional as F
    from grove_tpu_torch.ops.flash import (flash_causal_attention,
                                           flash_causal_attention_ref)
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t = {"ms": time_ms(lambda: flash_causal_attention(q, k, v)),
         "plain_ms": time_ms(lambda: flash_causal_attention_ref(q, k, v)),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, enable_gqa=True))}
    t["bound_ms"], t["bound_by"] = flash_bound_ms(b, s, h, n_kv, d, q.dtype)
    dispatch = host_us(lambda: flash_causal_attention(q, k, v))
    for name in ("ms", "plain_ms", "bound_ms", "library_ms"):
        log(f"kernels: {label} {name}={t[name]} at b={b} s={s} h={h} "
            f"n_kv={n_kv} d={d} bf16 on {card}")
    log(f"kernels: {label} bound by {t['bound_by']}; kernel at "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound, "
        f"{t['library_ms'] / t['ms']:.2f}x the library's speed; wrapper "
        f"dispatch {dispatch:.1f} us per call on the host")
    return t


def phase_kernels(seed: int, card: str) -> dict:
    import torch
    from grove_tpu_torch.ops.flash import flash_causal_attention, kernel_info
    for dt, d in (("float32", 128), ("bfloat16", 64), ("bfloat16", 128)):
        info = kernel_info(getattr(torch, dt), d)
        log(f"kernels: build {dt} d<={d}: {info['registers']} registers, "
            f"{info['local_bytes']} bytes local (spill) per thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory per CTA")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for (b, s, h, n_kv, d, dt) in PARITY_SHAPES:
        q, k, v = qkv(gen, b, s, h, n_kv, d, getattr(torch, dt))
        check_flash(q, k, v, f"b={b} s={s} h={h} n_kv={n_kv} d={d}", dt)
    # q, k, v as head slices of one [b, s, h + 2 n_kv, d] tensor (the
    # kernel reads them through their strides).
    b, s, h, n_kv, d = STRIDED_SHAPE
    fused = torch.randn((b, s, h + 2 * n_kv, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
    check_flash(fused[:, :, :h], fused[:, :, h:h + n_kv],
                fused[:, :, h + n_kv:],
                f"strided views b={b} s={s} h={h} n_kv={n_kv} d={d}",
                "bfloat16")
    # Row 0 attends only to itself: its output is v[0], up to the output
    # rounding (exactly, since p = 1 and l = 1).
    for dt, tol in (("float32", 1e-5), ("bfloat16", 2 ** -8)):
        q, k, v = qkv(gen, 1, 16, 2, 1, 128, getattr(torch, dt))
        out = flash_causal_attention(q, k, v)
        ref0 = v[0, 0, 0].float()
        err0 = (out[0, 0].float() - ref0).abs().max().item()
        bound = tol * max(1.0, ref0.abs().max().item())
        log(f"kernels: flash {dt} row-0 self-attention "
            f"max_abs_err={err0:.3e} (bound {bound:.3e})")
        if err0 > bound:
            raise AssertionError(f"flash {dt} row 0 does not attend only "
                                 f"to itself")

    q, k, v = qkv(gen, *LONG_SHAPE, torch.bfloat16)
    check_flash(q, k, v, "long prompt b={} s={} h={} n_kv={} d={}".format(
        *LONG_SHAPE), "bfloat16")
    time_flash(q, k, v, "long prompt", card)
    del q, k, v

    q, k, v = qkv(gen, *SERVE_SHAPE, torch.bfloat16)
    err = check_flash(q, k, v, "serving shape b={} s={} h={} n_kv={} "
                      "d={}".format(*SERVE_SHAPE), "bfloat16")
    t = time_flash(q, k, v, "serving shape", card)
    return {"name": "flash_causal_attention", "route": "cuda",
            "source": "grove_tpu_torch/csrc/flash_attn.cu",
            "replaces": "grove_tpu/ops/pallas_flash.py:27",
            "launches": 0, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def phase_serve(seed: int, card: str, cfg=None, device: str = "cuda",
                n_requests: int = 48, prompt_len: int = 128,
                max_new_tokens: int = 32, batch: int = 32,
                max_len: int = 512, bench_steps: int = 64,
                count_launches: bool = True) -> int:
    """Serve through the lanes engine; returns the flash launch count of
    this phase (the counts are zeroed at its start)."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops.flash import flash_causal_attention
    from grove_tpu_torch.serving.engine import PrefillWorker, make_engine

    cfg = cfg or CONFIGS["llama-1b"]
    on_cuda = device == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=device)
    eng = make_engine(cfg, params, mode="lanes", batch=batch,
                      max_len=max_len, quant="int8", host_sync_interval=8,
                      device=device)
    del params
    worker = PrefillWorker(cfg, eng.params, batch=8, max_prompt=prompt_len,
                           device=device)
    sync()
    log(f"serve: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"int8 weights; set-up {time.perf_counter() - t0:.2f} s")

    prefill_ms: list[float] = []
    inner = worker.prefill

    def timed_prefill(prompts):
        t = time.perf_counter()
        out = inner(prompts)  # returns after its host fetch of the tokens
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    worker.prefill = timed_prefill
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_requests, prompt_len)).astype(np.int32)
    bench_prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)

    flash_causal_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    for _ in range(10 * n_requests):
        eng.admit_from_queue(worker)
        if len(eng.completed) == n_requests:
            break
        eng.run(8)
    sync()
    serve_s = time.perf_counter() - t0
    done = sorted(eng.completed, key=lambda r: r.rid)
    if [r.rid for r in done] != rids:
        raise AssertionError(f"{len(done)} of {n_requests} requests answered")
    bad = [r.rid for r in done if len(r.generated) != max_new_tokens]
    if bad:
        raise AssertionError(f"requests {bad} have the wrong token count")
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid} has out-of-vocab tokens")
    log(f"serve: {n_requests} requests of {prompt_len} prompt tokens, "
        f"{max_new_tokens} new tokens each, answered in {serve_s:.3f} s "
        f"through {len(prefill_ms)} worker prefills")

    # The bench posture: a full batch admitted in-engine, then run(64).
    n_before = len(eng.completed)
    sync()
    t = time.perf_counter()
    eng.admit_prompts(bench_prompts, max_new_tokens=bench_steps + 1)
    sync()
    admit_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    eng.run(bench_steps)
    sync()
    decode_s = time.perf_counter() - t
    launches = flash_causal_attention.launches
    bench_done = eng.completed[n_before:]
    if len(bench_done) != batch or any(
            len(r.generated) != bench_steps + 1 for r in bench_done):
        raise AssertionError("bench-posture requests not all answered")
    prefill_calls = len(prefill_ms) + 1
    want = cfg.n_layers * prefill_calls if count_launches else 0
    log(f"serve: flash launches {launches} over {prefill_calls} prefill "
        f"calls x {cfg.n_layers} layers (expected {want})")
    if launches != want:
        raise AssertionError(f"flash launched {launches} times, "
                             f"expected {want}")
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    tok_s = batch * bench_steps / decode_s
    log(f"serve: worker prefill (batch 8 x {prompt_len}) ms per call: "
        f"median {float(np.median(prefill_ms)):.3f}, first "
        f"{prefill_ms[0]:.3f} on {card}")
    log(f"serve: engine prefill (batch {batch} x {prompt_len}) in "
        f"admit_prompts: {admit_ms:.3f} ms on {card}")
    log(f"serve: decode {tok_s:.1f} tokens/s (batch {batch}, run("
        f"{bench_steps}) in {decode_s * 1e3:.1f} ms) on {card}")
    log(f"serve: peak torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.3f} GiB on {card}")
    if on_cuda:
        profile_path(eng, bench_prompts, card, admit_ms,
                     decode_s * 1e3 / bench_steps)
    return launches


def profile_path(eng, prompts, card: str, prefill_ms: float,
                 step_ms: float, steps: int = 8, top: int = 10) -> None:
    """Device time by kernel for one in-engine prefill and one decode window
    of ``steps`` steps. The profiler slows the host, so each busy share is
    taken against the unprofiled wall time of the same work
    (``prefill_ms``, ``step_ms`` per decode step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, fn, wall_ms in (
            ("prefill", lambda: eng.admit_prompts(prompts), prefill_ms),
            ("decode", lambda: eng.run(steps), step_ms * steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []  # kernel-level rows only (operator rows repeat them)
        for e in prof.key_averages():
            if str(e.device_type) != "DeviceType.CUDA":
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        log(f"profile: {name}: device busy {busy_ms:.3f} ms in "
            f"{sum(r[1] for r in rows)} kernels; unprofiled wall "
            f"{wall_ms:.3f} ms; busy share {100 * busy_ms / wall_ms:.1f}% "
            f"on {card}")
        for dev_us, count, key in rows[:top]:
            log(f"profile: {name}:   {dev_us / 1e3:9.3f} ms "
                f"{100 * dev_us / 1e3 / busy_ms:5.1f}% x{count:<5d} "
                f"{key[:90]}")
        flash_us = sum(r[0] for r in rows if "flash_fwd" in r[2])
        flash_n = sum(r[1] for r in rows if "flash_fwd" in r[2])
        log(f"profile: {name}: flash kernel {flash_us / 1e3:.3f} ms in "
            f"{flash_n} launches, {100 * flash_us / 1e3 / busy_ms:.1f}% of "
            f"device busy, {100 * flash_us / 1e3 / wall_ms:.1f}% of the "
            f"unprofiled wall on {card}")


def phase_model(seed: int, card: str, cfg=None, device: str = "cuda",
                batch: int = 32, prompt_len: int = 128) -> None:
    """llama-1b bf16 prefill logits through the kernel vs the plain
    attention formulation (GROVE_FLASH_ATTENTION=0)."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params, prefill
    from grove_tpu_torch.ops.kvcache import KVCache

    cfg = cfg or CONFIGS["llama-1b"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    params = init_params(cfg, gen, device=device)
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)

    def run(flash_env: str | None):
        old = os.environ.pop("GROVE_FLASH_ATTENTION", None)
        if flash_env is not None:
            os.environ["GROVE_FLASH_ATTENTION"] = flash_env
        try:
            cache = KVCache.create(cfg.n_layers, batch, prompt_len,
                                   cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                                   device)
            logits, _ = prefill(cfg, params, tokens, cache)
            return logits.float()
        finally:
            os.environ.pop("GROVE_FLASH_ATTENTION", None)
            if old is not None:
                os.environ["GROVE_FLASH_ATTENTION"] = old

    kernel, plain = run(None), run("0")
    if not (torch.isfinite(kernel).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite logits")
    diff = (kernel - plain).abs().max().item()
    bound = 5e-2 * plain.abs().max().item()
    agree = int((kernel.argmax(-1) == plain.argmax(-1)).sum().item())
    log(f"model: {cfg.n_layers}-layer bf16 prefill logits, kernel vs plain: "
        f"max abs diff "
        f"{diff:.4e} (bound {bound:.4e}), argmax agrees on {agree}/{batch} "
        f"rows (need >= {batch - 1})")
    if diff > bound or agree < batch - 1:
        raise AssertionError("kernel and plain prefill disagree")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from grove_tpu_torch.ops import _build

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"device: nvidia-smi name, power.limit: {card}")

    # 2. build
    t0 = time.perf_counter()
    build = _build.build_all()
    log(f"build: {len(build.paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s ({build.seconds:.2f} s nvcc)")
    for stem, out in build.logs.items():
        for line in out.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                log(f"build: {stem}: {line.strip()}")

    # 3. kernels vs plain
    flash_row = phase_kernels(args.seed, card)
    # 4. the main path; 5. the kernel through the model
    flash_row["launches"] = phase_serve(args.seed, card)
    phase_model(args.seed, card)

    print(json.dumps({"kernels": [flash_row]}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
