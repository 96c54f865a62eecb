#!/usr/bin/env python3
"""Drive the PyTorch port (grove_tpu_torch) once on one CUDA card.

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile every kernel from grove_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card
     (f32 and bf16): the flash kernel at its parity shapes (strided views
     among them), the serving shape and a long prompt, with times, bounds
     and the library call's time at the last two, and each build's
     registers, spills and shared memory; the paged decode and chunk
     kernels at ragged lengths, GQA/MHA/MQA groups and chunk offsets, then
     timed at the serving shapes (and decode at max_len) beside their
     bounds, their plain versions and a gather +
     scaled_dot_product_attention yardstick, and a bitwise check that a
     bf16 row depends only on its position (chunk offset, table width,
     decode vs chunk); the same over int8 pools (the int8 kernels, each
     timed beside the bf16 kernel on the same pools dequantized, with both
     builds' registers, spills and shared memory), the KV write kernel
     with rope off into both pool kinds (the scatters alone) and with rope
     on (the fused rope + write the paged path runs: q, pools and int8
     scales) bitwise against their plain versions (rows past the table's
     width and invalid rows in the null block, positions past the rope
     table, f32 and bf16 rows, the decode and chunk shapes), timed at the
     serving shapes (the write alone beside index_put_ per pool, the fused
     write beside the unfused rope + write); the W8A16 GEMM's builds
     (registers, spills, shared memory, cluster size and resident
     clusters), then the
     GEMM at llama-1b's five launches at M = 32 (QKV and gate/up one
     launch each; gate/up also at M = 4,096), grouped launches at M = 1,
     8, 64 and 256, ragged and f32 shapes, timed beside its bound, its
     plain version, a bf16-weight matmul and torch._weight_int8pack_mm,
     and a bitwise check that its rows do not depend on M (1..256); its
     bf16-weight build (the engine's default weights) at llama-1b's five
     launches at M = 32 and 128 (the head with an f32 output), the tiny
     draft's and ragged shapes, f32 weights, timed per forward beside its
     byte bound and torch.matmul, its rows bitwise across M = 1..256 and
     slabbed calls at M = 512 (int8 weights too) bitwise equal to the same
     rows at M <= 256; rms_norm, and add_rms_norm (the residual add fused
     into the norm) against its plain version, bitwise against rms_norm
     of its sum, rows bitwise across row counts, timed at 32, 128 and
     4,096 rows beside its bound and x + delta then F.rms_norm;
  4. lanes serve: llama-1b at full width and depth (random weights from
     --seed) through make_engine(mode="lanes") with int8 weights, its
     decode replaying CUDA graphs (warmup captures the single step and the
     K-step block, and nothing is captured in traffic): queued requests
     admitted through a PrefillWorker, then the bench posture
     (admit_prompts + run(64)), whose tokens are bitwise those of an eager
     loop of llama.prefill + decode_step + argmax; the flash and W8A16
     launch counts are read from these two runs alone (through the
     replays); the sampled lanes engine (top_k=1 equals greedy, a seed
     repeats, two seeds differ); then a torch.profiler pass over one
     in-engine prefill and one run(8) window gives the kernels by device
     time and the device's busy share, and the bench posture again with
     the graphs off (each step dispatched from the host) gives tokens/s,
     busy share and kernels per step beside it;
  5. model: llama-1b prefill logits with int8 weights through the flash
     and W8A16 kernels vs the plain attention and the GEMM's plain version;
  6. paged parity: test-tiny f32 through the paged engine with the kernels
     and CUDA graphs on: paged vs lanes, prefix cache on vs off, tight vs
     roomy pool give equal tokens, over f32 and int8 KV; sampled decoding
     with top_k=1 equals greedy, one seed repeats, two seeds differ, and
     graph replays draw fresh noise;
  7. paged serve: llama-1b through the default make_engine (the paged
     engine, int8 weights, batch 32, max_len 2048): decode and prefill-chunk
     graphs captured at warmup, 64 requests (prompts 64-1024 tokens, half
     opening with one shared 264-token prefix, 64 new tokens each) with no
     capture during traffic, the kernels' launch counts read from this run
     alone (4 GEMM launches per layer and one for the head, and one fused
     rope + KV write per layer, per decode step and per chunk), a window
     of mixed ticks timed; a full-batch decode window with a profiler pass
     (kernels per 8 decode steps); the same traffic on a quarter-size pool
     (the same window of mixed ticks under the profiler), then a full
     batch decoding
     past that pool's capacity, which must preempt and still finish every
     request; the same traffic and decode window over int8 KV, whose
     kernels' launch counts are read from its run; then the engine's
     default bf16 weights (quant None): a full batch decoding with a
     profiled window, every projection through the GEMM's bf16-weight
     build (65 launches per forward, counted from this run);
  8. paged model: llama-1b bf16 decode_step_paged and prefill_chunk_paged
     logits with int8 weights through the kernels vs their plain versions;
     then 8 sequences' decode logits alone vs inside a batch of 32,
     bitwise, naming the first op whose rows differ (reported);
  9. speculative serve: llama-1b, int8 weights, batch 32, 32 requests of
     64-1,024 prompt tokens and 64 new tokens each through
     make_engine(spec_decode=True, spec_k=3): self-draft over a bf16 and an
     int8 pool and the tiny draft over a bf16 pool give the tokens of spec
     off per request, every spec graph captured at warmup and none during
     traffic, the kernels' launches per dispatch as counted (self-draft: k
     decode steps and one verify chunk; tiny draft: its own pool, its
     chunk replay); a full batch of 512-token prompts decoding, spec
     against off tokens/s over each pool with a profiled window; k = 7 at
     batch 32 (the verify's GEMM at M = 256) equal to spec off; bf16
     weights (the dense GEMM build) spec equal to off, and a verify row
     bitwise the decode row with bf16 and with int8 weights (else the
     first op whose rows differ is named); k = 7 at batch 64 (the verify's
     M = 512, slabs of 256 rows) equal to spec off. Phase 3 also checks
     and times the chunk kernels at the verify shape (b = 32, c = 4,
     per-sequence offsets).
 10. disaggregated serve: phase 7's traffic through make_engine with
     GROVE_DISAGG=1 (a PrefillEngine handing each finished prompt to a
     PagedDecodeEngine over the KV block handoff, each tier with its own
     pool), beside the mono engine on the same traffic, int8 weights over
     a bf16 pool and bf16 weights over an int8 pool: each tier captures
     only its own graphs at warmup and none during traffic, tokens equal
     mono's rid for rid, the handoff's bytes and shared blocks, both
     allocators clean after the drain, the kernels' launches from the
     pair's runs; wall, tokens/s, TTFT and per-tick device time beside
     mono's; the handoff copy timed and profiled against its byte bound;
     the prefill-replica kill recovers with mono's tokens;
 11. chunked lanes prefill: llama-1b, int8 weights, PrefillWorker(batch 8,
     max_prompt 1024, prefill_chunk 128) against the one-shot worker:
     logits within phase 5's bound, next tokens' agreement, flash once per
     layer (window 0), ms per call and the later windows' plain
     attention, and a lanes DecodeEngine fed by the chunked worker.
 12. observatories (on by default in every phase, as in the JAX package):
     phase 7's serve and a full-batch decode on an engine with
     GROVE_XPROF/GROVE_REQTRACE on and one with them off, in turns, twice
     each: tokens equal rid for rid, no graph captured during traffic, the
     compile table equal to the warmup's captures, memory read from the
     device with the pool's bytes, every finished rid traced, both
     renderers run; tokens/s on / off (the serve by turn, the decode
     windows best, median and paired) and the flight recorder's
     event-timed step p50 beside phase 7's profiler; the
     disaggregated pair once (one trace per rid across the seam, handoff
     series equal to handoff_view()) and the lanes engine once (an
     event-timed prefill of the flash path).
 13. training and checkpoints, one JSON line per check: test-tiny and
     moe-test-tiny training in f32 on the card against the CPU (loss,
     every gradient, three AdamW steps); llama-1b at full width and depth
     in bf16, three train steps on 2 x 2,048 tokens (a falling loss, step
     time, tokens/s, peak memory, model-FLOP share, a profiled step's
     device time by kernel family); one MoE train step at
     Mixtral-8x7B's widths with 2 of its 32 layers; no kernel launched by
     training; the trained params through save_params / load_params
     bitwise; A -> B -> A warm restarts into live llama-1b engines (paged
     with bf16 and int8 weights and self-draft spec, and the lanes engine
     with 128-token prompts through the flash kernel and its decode
     graphs): tokens equal fresh engines' tokens, no new build, the
     barrier responder's new step.
 14. tensor-parallel serving: a one-rank NCCL group and build_mesh(
     MeshPlan()); llama-1b through make_engine(mesh=) with int8 weights
     over a bf16 pool and with bf16 weights over an int8 pool, 16 requests
     of 64-512 prompt tokens, 32 new each, tokens equal to mesh=None's
     rid for rid, bitwise; spec self-draft under the mesh equal to greedy
     under it; the disaggregated pair under the mesh equal to mono under
     it; every graph captured at warmup with the group's collectives
     inside, 2 n_layers + 2 = 34 per forward by the group's host count;
     a full batch decoding with and without the mesh (tokens/s, device ms
     per 8 steps, the copies and NCCL kernels in the replayed graphs);
     each kernel of the paged path at one rank's widths of llama-1b at
     tp = 2, 4, 8 and llama-70b at tp = 8 against its plain version,
     timed beside its bound, the GEMMs' rows bitwise across M; and
     samples/workloads/allreduce_worker_torch.py as a world of one over
     NCCL (result 1.0); the lanes model functions under tp: the flash
     kernel at one rank's head counts of llama-1b (tp = 2, 4, 8; b = 32,
     s = 128 and 2,048) against its plain version, timed beside its bound
     and scaled_dot_product_attention, and llama-1b's lanes prefill + 16
     decode steps with tp= the group, bitwise equal to tp=None (its flash
     launches in the kernels line's flash row, "tp_launches"); checkpoints
     of a tp engine: a two-rank gloo world on the CPU writes an
     int8-weight llama-1b step with save_engine (rank0.pt, rank1.pt),
     whose whole tree is bitwise the params of an engine built here on
     the same weights and which restores into a plain engine and a
     one-rank mesh engine on other weights, both then serving the
     reference's tokens bitwise ("tp_restart_launches"); A -> B -> A into
     a live one-rank mesh engine; the save and load GB/s beside phase
     13's.
 15. parallel training at one rank, over a one-rank NCCL group and
     build_mesh(MeshPlan()), one JSON line per check: test-tiny and
     moe-test-tiny in f32, each strategy on the card against the same
     strategy on the CPU over a gloo group (llama's loss_fn(mesh=) plain,
     ring and Ulysses, pipeline_forward at pp = 1 with 2 microbatches, the
     MoE through _ep_moe_block; loss and every gradient); llama-1b in bf16
     at full width and depth, one train step of each strategy against
     mesh=None on 2 x 2,048 tokens (loss and gradient error, collectives
     by axis, step ms, tokens/s, peak memory, NCCL kernel time; the ring's
     hop at one rank is a local copy, no send/recv); the MoE at
     Mixtral-8x7B's widths with 2 of its 32 layers through the
     expert-parallel layer against the dense path (layer 0's block, the
     loss; the logits and routing flips reported), the dropped share at
     capacity factor 1.25, one train step; train.dryrun_multichip as a
     world of one (its ok line, the disaggregated section skipped below 8
     ranks as in JAX); no kernel launched.
 16. serving worker: samples/workloads/serving_worker_torch.py as a
     subprocess on the card with llama-1b for 5 s: the ready file appears
     only after the warm line, "served N decode steps" with N > 0, and the
     same 2 graphs captured before ready and after serving.
 17. the data-plane gates over the port (grove_tpu_torch.serving.
     decode_gate, grove_tpu_torch.chaos), at llama-1b's widths: the
     decode smoke's four paged engines and the lanes engine in f32 (the
     pinned build sets, none in the steady state, tokens equal to the
     lanes engine's), the disaggregated pair in bf16 (each tier's pins,
     tokens bitwise the mono engine's) and the prefill-replica kill;
     their kernel launches counted from zero ("gate_launches"). The
     twins that also drive the control plane (tools/*_torch.py) run on
     their own: python3 tools/serving_smoke_torch.py --model llama-1b.
Each phase's seconds are printed.
Usage: python3 chip_smoke.py [--seed N]
       python3 chip_smoke.py --decode-only [--root CHECKOUT]: only the
       bf16-weight paged decode of phase 7, importing grove_tpu_torch from
       CHECKOUT (to time two commits in turn in one call).
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
                count_launches: bool = True,
                sample_steps: int = 16) -> dict[str, int]:
    """Serve through the lanes engine; returns the flash and W8A16 launch
    counts of its queued serve and bench posture (zeroed just before).

    On the card the decode replays CUDA graphs: ``warmup`` captures the
    single step and the K-step block (2 graphs), and nothing is captured
    in traffic. The bench posture's tokens are held bitwise to an eager
    loop of ``llama.prefill`` + ``decode_step`` + argmax on the same params
    and prompts (``eager_lanes``); the sampled lanes (``sampled_lanes``):
    ``top_k = 1`` equals greedy, a seed repeats, two seeds differ. Then the
    bench posture again with the graphs off (each step dispatched from the
    host, as before the graphs) beside it: tokens/s, and on the card the
    profiled busy share and kernels per decode step of both."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops.flash import flash_causal_attention
    from grove_tpu_torch.ops.w8a16 import w8a16_matmul
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

    t0 = time.perf_counter()
    built = eng.warmup()
    log(f"serve: warmup built {built} decode executables in "
        f"{time.perf_counter() - t0:.2f} s ({eng.graphs_captured} CUDA "
        f"graphs captured, {eng.capture_seconds:.2f} s of capture) on "
        f"{card}")
    if on_cuda and eng.graphs_captured != 2:
        raise AssertionError(f"warmup captured {eng.graphs_captured} "
                             f"graphs, expected 2 (step, step_block)")
    captured = eng.graphs_captured

    flash_causal_attention.launches = 0
    w8a16_matmul.launches = 0
    steps0 = eng.steps
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
    gemms = w8a16_matmul.launches
    bench_done = eng.completed[n_before:]
    if len(bench_done) != batch or any(
            len(r.generated) != bench_steps + 1 for r in bench_done):
        raise AssertionError("bench-posture requests not all answered")
    log(f"serve: graphs captured during the queued serve and the bench "
        f"posture: {eng.graphs_captured - captured}")
    if eng.graphs_captured != captured:
        raise AssertionError("a decode graph was captured in traffic")
    bench_tokens = [r.generated for r in sorted(bench_done,
                                                key=lambda r: r.rid)]
    eager = eager_lanes(cfg, eng.params, bench_prompts, max_len,
                        bench_steps)
    same = sum(a == b for a, b in zip(bench_tokens, eager))
    log(f"serve: bench posture vs an eager loop of llama.prefill + "
        f"decode_step + argmax: {same}/{batch} lanes' {bench_steps + 1} "
        f"tokens bitwise equal")
    if same != batch:
        raise AssertionError("the graphs' tokens differ from the eager "
                             "model functions'")
    prefill_calls = len(prefill_ms) + 1
    want = cfg.n_layers * prefill_calls if count_launches else 0
    log(f"serve: flash launches {launches} over {prefill_calls} prefill "
        f"calls x {cfg.n_layers} layers (expected {want})")
    if launches != want:
        raise AssertionError(f"flash launched {launches} times, "
                             f"expected {want}")
    forwards = prefill_calls + eng.steps - steps0
    per = GEMMS_PER_LAYER * cfg.n_layers + 1
    want = per * forwards if count_launches else 0
    log(f"serve: w8a16 launches {gemms} over {forwards} forwards ("
        f"{prefill_calls} prefills, {eng.steps - steps0} decode steps) x "
        f"{per} (expected {want})")
    if gemms != want:
        raise AssertionError(f"w8a16 launched {gemms} times, expected "
                             f"{want}")
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
    sampled_lanes(cfg, eng.params, bench_prompts, bench_tokens, max_len,
                  sample_steps, device, card)
    graphs = {"tokens_per_s": tok_s}
    if on_cuda:
        graphs.update(profile_path(eng, bench_prompts, card, admit_ms,
                                   decode_s * 1e3 / bench_steps))
    # The same posture with each step dispatched from the host (the graphs
    # off, this engine's decode as it ran before them).
    live, capture = eng._graphs, eng._capture
    eng._graphs, eng._capture = {}, (lambda step: step)
    try:
        eng.admit_prompts(bench_prompts, max_new_tokens=bench_steps + 1)
        sync()
        t = time.perf_counter()
        eng.run(bench_steps)
        sync()
        eager_s = time.perf_counter() - t
        eager_tokens = [r.generated for r in sorted(
            eng.completed[-batch:], key=lambda r: r.rid)]
        off = {"tokens_per_s": batch * bench_steps / eager_s}
        log(f"serve: decode with the graphs off {off['tokens_per_s']:.1f} "
            f"tokens/s (run({bench_steps}) in {eager_s * 1e3:.1f} ms) on "
            f"{card}")
        if eager_tokens != bench_tokens:
            raise AssertionError("graphs off gives other tokens")
        if on_cuda:
            eng.admit_prompts(bench_prompts)
            prof = profile_window("decode, graphs off", lambda: eng.run(8),
                                  eager_s * 1e3 / bench_steps * 8, card,
                                  ("w8a16",))
            off.update(busy_ms=prof["busy_ms"], kernels=prof["count"],
                       wall_ms=eager_s * 1e3 / bench_steps * 8)
    finally:
        eng._graphs, eng._capture = live, capture
    if on_cuda:
        # The step and its attention path timed the same way: replays
        # queued behind a spin kernel.
        step_ms = time_ms(eng.step)
        attn_ms = lanes_attention_ms(cfg, batch, max_len,
                                     prompt_len + bench_steps // 2)
        log(f"serve: the lanes decode's plain rope + write_rows + "
            f"decode_attention over {cfg.n_layers} layers, one graph "
            f"replayed: {attn_ms:.4f} ms per step, "
            f"{100 * attn_ms / step_ms:.1f}% of a graphed step's "
            f"{step_ms:.4f} device ms (the profiled window: "
            f"{graphs['busy_ms'] / 8:.4f} ms per step) on {card}")
        log(f"serve: decode graphs on / off: {graphs['tokens_per_s']:.1f} / "
            f"{off['tokens_per_s']:.1f} tokens/s "
            f"({graphs['tokens_per_s'] / off['tokens_per_s']:.2f}x); busy "
            f"share {100 * graphs['busy_ms'] / graphs['wall_ms']:.1f}% / "
            f"{100 * off['busy_ms'] / off['wall_ms']:.1f}%; kernels per "
            f"decode step {graphs['kernels'] / 8:.1f} / "
            f"{off['kernels'] / 8:.1f} on {card}")
    return {"flash_causal_attention": launches, "w8a16_matmul": gemms}


def lanes_attention_ms(cfg, batch: int, max_len: int, length: int) -> float:
    """Device ms of one lanes decode step's attention path without the rest
    of the step: for every layer, ``apply_rope`` on q and k, ``write_rows``
    of k and v into that layer's cache and the plain ``decode_attention``
    over all ``max_len`` rows, at lanes of ``length`` tokens, captured in
    one CUDA graph and timed by its replays."""
    import torch
    from grove_tpu_torch.models.llama import _rope
    from grove_tpu_torch.ops.attention import decode_attention
    from grove_tpu_torch.ops.kvcache import KVCache, write_rows
    from grove_tpu_torch.ops.rope import apply_rope
    gen = torch.Generator(device="cuda").manual_seed(7)
    h, n_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((batch, 1, h, d), generator=gen, device="cuda").to(
        cfg.dtype)
    k, v = (torch.randn((batch, 1, n_kv, d), generator=gen,
                        device="cuda").to(cfg.dtype) for _ in range(2))
    cache = KVCache.create(cfg.n_layers, batch, max_len, n_kv, d, cfg.dtype,
                           "cuda")
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    lengths = torch.full((batch,), length, dtype=torch.int32, device="cuda")
    positions = lengths[:, None]
    cos, sin = _rope(cfg.max_seq_len, d, cfg.rope_theta,
                     torch.device("cuda"))

    def attend() -> None:
        for i in range(cfg.n_layers):
            qr = apply_rope(q, cos, sin, positions)
            kr = apply_rope(k, cos, sin, positions)
            kc = write_rows(cache.k[i], kr, lengths)
            vc = write_rows(cache.v[i], v, lengths)
            decode_attention(qr, kc, vc, lengths + 1)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attend()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        attend()
    ms = time_ms(graph.replay)
    del graph, cache
    torch.cuda.empty_cache()
    return ms


def eager_lanes(cfg, params, prompts, max_len: int, steps: int
                ) -> list[list[int]]:
    """Each lane's greedy tokens from the model functions called one by one
    (no engine, no graph): ``llama.prefill`` into a fresh cache, then
    ``steps`` of ``decode_step`` + argmax."""
    import torch
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.ops.kvcache import KVCache
    b = prompts.shape[0]
    with torch.no_grad():
        cache = KVCache.create(cfg.n_layers, b, max_len, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype, prompts.device)
        logits, cache = llama.prefill(cfg, params, prompts, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        for _ in range(steps):
            logits, cache = llama.decode_step(cfg, params, tok, cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
    return torch.stack(out).T.cpu().tolist()


def sampled_lanes(cfg, params, prompts, greedy: list[list[int]],
                  max_len: int, steps: int, device: str, card: str) -> None:
    """The sampled lanes engine (its ``step_block_sampled`` graph, the
    generator registered with it) on the bench prompts: ``top_k = 1``
    gives the greedy tokens (their first ``steps + 1``), one seed repeats
    its tokens, and two seeds differ."""
    from grove_tpu_torch.serving.engine import DecodeEngine, SamplerConfig
    b = prompts.shape[0]

    def tokens(**sampler) -> list[list[int]]:
        eng = DecodeEngine(cfg, params, batch=b, max_len=max_len,
                           host_sync_interval=8, device=device,
                           sampler=SamplerConfig(**sampler))
        eng.admit_prompts(prompts, max_new_tokens=steps + 1)
        eng.run(steps)
        eng.sync()
        if len(eng.completed) != b:
            raise AssertionError(f"sampled lanes {sampler}: "
                                 f"{len(eng.completed)} of {b} answered")
        return [r.generated for r in sorted(eng.completed,
                                            key=lambda r: r.rid)]

    top1 = tokens(temperature=1.0, top_k=1, seed=3)
    a = tokens(temperature=1.0, top_k=50, seed=3)
    again = tokens(temperature=1.0, top_k=50, seed=3)
    other = tokens(temperature=1.0, top_k=50, seed=4)
    want = [g[:steps + 1] for g in greedy]
    log(f"serve: sampled lanes: top_k=1 equals greedy "
        f"{top1 == want}, seed 3 repeats {a == again}, seeds 3 and 4 "
        f"differ {a != other} ({b} lanes x {steps + 1} tokens) on {card}")
    if not (top1 == want and a == again and a != other):
        raise AssertionError("the sampled lanes engine failed a check")


def profile_path(eng, prompts, card: str, prefill_ms: float,
                 step_ms: float, steps: int = 8) -> dict:
    """Device time by kernel for one in-engine prefill and one decode window
    of ``steps`` steps of the lanes engine; returns the decode window's
    busy ms, kernel count and unprofiled wall ms."""
    profile_window("prefill", lambda: eng.admit_prompts(prompts),
                   prefill_ms, card, ("flash_fwd", "w8a16"))
    prof = profile_window("decode", lambda: eng.run(steps), step_ms * steps,
                          card, ("flash_fwd", "w8a16"))
    return {"busy_ms": prof["busy_ms"], "kernels": prof["count"],
            "wall_ms": step_ms * steps}


def profile_window(name: str, fn, wall_ms: float, card: str,
                   kernels: tuple[str, ...], top: int = 10) -> dict:
    """Device time by kernel for one call of ``fn``. The profiler slows the
    host, so the busy share is taken against ``wall_ms``, the unprofiled
    wall time of the same work; ``kernels`` name the hand-written kernels
    whose share is reported. Returns their device ms, their launches
    (``launches``), the kernel count (``count``) and the device's busy ms
    (``busy_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []  # kernel-level rows only (operator rows repeat them)
    for e in prof.key_averages():
        # A user annotation's device row (the optimizer's step) spans the
        # kernels inside it, which have rows of their own.
        if str(e.device_type) != "DeviceType.CUDA" or \
                getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"profile {name}: no device time traced")
    log(f"profile: {name}: device busy {busy_ms:.3f} ms in "
        f"{sum(r[1] for r in rows)} kernels; unprofiled wall "
        f"{wall_ms:.3f} ms; busy share {100 * busy_ms / wall_ms:.1f}% "
        f"on {card}")
    for dev_us, count, key in rows[:top]:
        log(f"profile: {name}:   {dev_us / 1e3:9.3f} ms "
            f"{100 * dev_us / 1e3 / busy_ms:5.1f}% x{count:<5d} "
            f"{key[:90]}")
    out = {"count": sum(r[1] for r in rows), "busy_ms": busy_ms,
           "launches": {}}
    for kernel in kernels:
        k_us = sum(r[0] for r in rows if kernel in r[2])
        k_n = sum(r[1] for r in rows if kernel in r[2])
        out[kernel] = k_us / 1e3
        out["launches"][kernel] = k_n
        log(f"profile: {name}: {kernel} {k_us / 1e3:.3f} ms in {k_n} "
            f"launches, {100 * k_us / 1e3 / busy_ms:.1f}% of device busy, "
            f"{100 * k_us / 1e3 / wall_ms:.1f}% of the unprofiled wall on "
            f"{card}")
    return out


def phase_model(seed: int, card: str, cfg=None, device: str = "cuda",
                batch: int = 32, prompt_len: int = 128) -> None:
    """llama-1b bf16 prefill logits with int8 weights through the kernels
    (flash, W8A16) vs the plain attention formulation
    (GROVE_FLASH_ATTENTION=0) and the GEMM's plain version."""
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.models.llama import CONFIGS, init_params, prefill
    from grove_tpu_torch.ops import w8a16
    from grove_tpu_torch.ops.kvcache import KVCache
    from grove_tpu_torch.serving.quant import quantize_params

    cfg = cfg or CONFIGS["llama-1b"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    params = quantize_params(init_params(cfg, gen, device=device))
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)

    def run(flash_env: str | None):
        old = os.environ.pop("GROVE_FLASH_ATTENTION", None)
        if flash_env is not None:
            os.environ["GROVE_FLASH_ATTENTION"] = flash_env
            llama.w8a16_matmul_group = plain_gemm
        try:
            cache = KVCache.create(cfg.n_layers, batch, prompt_len,
                                   cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                                   device)
            logits, _ = prefill(cfg, params, tokens, cache)
            return logits.float()
        finally:
            llama.w8a16_matmul_group = w8a16.w8a16_matmul_group
            os.environ.pop("GROVE_FLASH_ATTENTION", None)
            if old is not None:
                os.environ["GROVE_FLASH_ATTENTION"] = old

    kernel, plain = run(None), run("0")
    if not (torch.isfinite(kernel).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite logits")
    diff = (kernel - plain).abs().max().item()
    bound = 5e-2 * plain.abs().max().item()
    agree = int((kernel.argmax(-1) == plain.argmax(-1)).sum().item())
    log(f"model: {cfg.n_layers}-layer bf16 prefill logits (int8 weights), "
        f"kernels vs plain: "
        f"max abs diff "
        f"{diff:.4e} (bound {bound:.4e}), argmax agrees on {agree}/{batch} "
        f"rows (need >= {batch - 1})")
    if diff > bound or agree < batch - 1:
        raise AssertionError("kernel and plain prefill disagree")


def plain_gemm(x, weights, out_dtype=None, slabbed=False):
    """The W8A16 GEMM's plain version under the wrapper's signature (a
    slabbed call's rows are the plain product's rows)."""
    from grove_tpu_torch.ops import w8a16
    return w8a16.w8a16_matmul_group_ref(x, weights, out_dtype)


# ---- the paged path (the default make_engine) ----

PAGED_DECODE_CASES = [                    # B, W, n_kv, g, d
    (1, 128, 8, 2, 128),                  # one sequence, a full W = 128 table
    (10, 32, 8, 2, 128),                  # lengths at block and span edges
    (5, 16, 4, 1, 64),                    # MHA (g = 1)
    (5, 8, 2, 8, 128),                    # g = 8
    (32, 64, 8, 2, 128),                  # llama-1b's heads
    (32, 4, 1, 8, 64),                    # MQA, short tables
    (4, 8, 4, 3, 64),                     # g = 3
]
PAGED_CHUNK_CASES = [                     # offset, n_valid, n_kv, g, d
    (0, 5, 8, 2, 128),                    # rows past the table's 16 keys clamp
    (13, 20, 4, 1, 64),
    (992, 7, 2, 8, 128),
    (112, 32, 8, 2, 128),                 # rows on both sides of a span edge
    (241, 32, 8, 2, 128),                 # rows across position 256
    (100, 32, 2, 16, 64),                 # g = 16: four positions per row tile
]
PAGED_BS = 16                             # the engine's default block size
PAGED_CHUNK = 32                          # the engine's default chunk
SERVE_DECODE = (32, 64, 512, 1024)        # B, W, shortest and longest length
LONG_DECODE = (32, 128, 1536, 2048)       # at the engine's max_len of 2048
SERVE_CHUNK_OFFSET = 992                  # b = 1, c = 32, W = 64
SPEC_VERIFY = (32, 4, 64, 512, 1020)      # b, c = k + 1, W, lengths lo..hi


def paged_pools(gen, lengths, W, n_kv, d, dtype, spare: int = 3):
    """Pools of one layer holding ``lengths`` tokens per sequence in
    distinct random blocks, and the [B, W] tables reaching them (NULL
    past each sequence's blocks)."""
    import torch
    need = [-(-n // PAGED_BS) for n in lengths]
    nb = 1 + sum(need) + spare
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        int(sum(lengths)))) + 1
    tables = torch.zeros((len(lengths), W), dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
    k = torch.randn((nb, PAGED_BS, n_kv, d), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((nb, PAGED_BS, n_kv, d), generator=gen,
                    device="cuda").to(dtype)
    return k, v, tables.cuda()


def decode_lengths(rng, B, W):
    """Ragged lengths in [1, W * bs]: a full table first, then the edges of
    a block, of a key span and of position 256 that fit, then random."""
    import numpy as np
    from grove_tpu_torch.ops.paged import SPLIT_KEYS
    full = W * PAGED_BS
    lengths = rng.integers(1, full + 1, size=B)
    edges = [full] + [x for x in (1, PAGED_BS, PAGED_BS + 1, SPLIT_KEYS - 1,
                                  SPLIT_KEYS, SPLIT_KEYS + 1, 255, 256, 257)
                      if x < full]
    lengths[:min(B, len(edges))] = edges[:B]
    return lengths.astype(np.int32)


def paged_bound_ms(kv_rows: int, q_rows: int, pairs: int, n_kv: int, h: int,
                   d: int, dtype, int8: bool = False) -> tuple[float, str]:
    """Least time for one call: the K/V rows the call needs (``kv_rows``
    positions, all kv heads, K and V) read once, q read and the output
    written once, at the memory rate; against 4 d operations per (query
    head, visible key) pair at the input type's peak. An int8 pool's row
    is d int8 codes plus one f32 scale per kv head."""
    import torch
    elt = torch.empty((), dtype=dtype).element_size()
    kv_row = d + 4 if int8 else d * elt
    nbytes = 2 * kv_rows * n_kv * kv_row + 2 * q_rows * h * d * elt
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * pairs / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_paged(out, ref, label: str, dt: str) -> float:
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), rtol=TOL[dt], atol=TOL[dt])
    log(f"kernels: {label} {dt} max_abs_err={err:.3e} tol={TOL[dt]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} kernel disagrees ({dt})")
    return err


def gather_sdpa(q, k_pool, v_pool, idx, mask):
    """The gather + attention yardstick: one ``index_select`` per pool,
    then ``scaled_dot_product_attention`` over the gathered cache."""
    import torch.nn.functional as F
    b = q.shape[0]
    nb, bs, n_kv, d = k_pool.shape
    k = k_pool.index_select(0, idx).view(b, -1, n_kv, d).transpose(1, 2)
    v = v_pool.index_select(0, idx).view(b, -1, n_kv, d).transpose(1, 2)
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask, enable_gqa=True)


def time_paged(label, kernel, plain, yard, bound, card: str,
               yard_name: str = "index_select per pool + "
               "scaled_dot_product_attention") -> dict:
    t = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
         "yardstick_ms": time_ms(yard) if yard is not None else None}
    t["bound_ms"], t["bound_by"] = bound
    dispatch = host_us(kernel)
    for name in ("ms", "plain_ms", "bound_ms", "yardstick_ms"):
        log(f"kernels: {label} {name}={t[name]} on {card}")
    speed = (f"{t['yardstick_ms'] / t['ms']:.2f}x the yardstick's speed "
             f"({yard_name}; no single PyTorch call computes this)"
             if yard is not None else "no yardstick")
    log(f"kernels: {label} bound by {t['bound_by']}; kernel at "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound, {speed}; "
        f"wrapper dispatch {dispatch:.1f} us per call on the host")
    return t


def paged_build_info() -> None:
    """Registers, spills, shared memory and ring stages of every paged
    kernel build; the bf16 tensor-core builds must not spill."""
    import torch
    from grove_tpu_torch.ops.paged import kernel_info
    for which, dt, d, q8 in (("partial", "float32", 128, False),
                             ("partial", "bfloat16", 64, False),
                             ("partial", "bfloat16", 128, False),
                             ("partial", "float32", 128, True),
                             ("partial", "bfloat16", 64, True),
                             ("partial", "bfloat16", 128, True),
                             ("partial_chunk", "bfloat16", 64, True),
                             ("partial_chunk", "bfloat16", 128, True),
                             ("combine", "float32", 128, False),
                             ("combine", "bfloat16", 128, False)):
        info = kernel_info(which, getattr(torch, dt), d, int8_pool=q8)
        pool = "int8 pool" if q8 else "pool of q's type"
        ring = f", {info['stages']} stages" if info["stages"] else ""
        log(f"kernels: build paged {which} {dt} d<={d} {pool}: "
            f"{info['registers']} registers, {info['local_bytes']} bytes "
            f"local (spill) per thread, {info['smem_bytes']} bytes dynamic "
            f"shared memory per CTA{ring}")
        if dt == "bfloat16" and info["local_bytes"]:
            raise AssertionError(f"the bf16 paged {which} kernel spills "
                                 f"({pool})")


def check_row_invariance(gen, int8: bool = False) -> None:
    """bf16, llama-1b's heads: a row's output depends only on its absolute
    position, bitwise. A chunk at offset 0 against its tail at offset k;
    a table of width W against the same table padded to 2W (chunk and
    decode); and decode at length p + 1 against the chunk's row at p. With
    ``int8``, over int8 pools through the int8 kernels."""
    import torch
    from grove_tpu_torch.ops import paged
    n_kv, g, d, W, c, k0 = 8, 2, 128, 8, 48, 19
    dtype = torch.bfloat16
    if int8:
        kq, vq, ks, vs, tables = int8_pools(gen, [W * PAGED_BS] * 2, W, n_kv,
                                            d)

        def paged_chunk_attention(q, k, v, t, off):
            return paged.paged_chunk_attention_q8(q, kq, vq, ks, vs, t, off)

        def paged_decode_attention(q, k, v, t, lens):
            return paged.paged_decode_attention_q8(q, kq, vq, ks, vs, t, lens)
        k = v = None
    else:
        paged_chunk_attention = paged.paged_chunk_attention
        paged_decode_attention = paged.paged_decode_attention
        k, v, tables = paged_pools(gen, [W * PAGED_BS] * 2, W, n_kv, d,
                                   dtype)
    wide = torch.cat([tables, torch.zeros_like(tables)], 1)
    q = torch.randn((2, c, n_kv * g, d), generator=gen,
                    device="cuda").to(dtype)
    zero = torch.zeros((2,), dtype=torch.int32, device="cuda")
    whole = paged_chunk_attention(q, k, v, tables, zero)
    tail = paged_chunk_attention(q[:, k0:], k, v, tables, zero + k0)
    padded = paged_chunk_attention(q, k, v, wide, zero)
    # Decode rows: sequence 0's chunk rows at every position p.
    pos = torch.arange(c, device="cuda")
    dec_q = q[0][:, None]                                  # [c, 1, h, d]
    dec_t = tables[:1].expand(c, W).contiguous()
    lens = (pos + 1).to(torch.int32)
    dec = paged_decode_attention(dec_q, k, v, dec_t, lens)
    dec_wide = paged_decode_attention(dec_q, k, v,
                                      wide[:1].expand(c, 2 * W).contiguous(),
                                      lens)
    torch.cuda.synchronize()
    checks = {
        f"chunk tail at offset {k0} vs offset 0": torch.equal(
            tail, whole[:, k0:]),
        f"chunk table width {W} vs {2 * W}": torch.equal(padded, whole),
        f"decode table width {W} vs {2 * W}": torch.equal(dec_wide, dec),
        "decode at length p + 1 vs chunk row p": torch.equal(
            dec[:, 0], whole[0]),
    }
    pool = "int8 pool" if int8 else "bf16 pool"
    for name, same in checks.items():
        log(f"kernels: bf16 row invariance ({pool}): {name}: "
            f"{'bitwise equal' if same else 'DIFFER'}")
    if not all(checks.values()):
        raise AssertionError("bf16 paged rows depend on more than their "
                             "position")


def time_verify_shape(gen, rng, card: str, int8: bool = False) -> dict:
    """The chunk kernel at the speculative verify shape (SPEC_VERIFY: b =
    32 sequences at their own offsets, c = 4 rows each, llama-1b's heads,
    bf16 queries): against its plain version, decode row at length p + 1
    against the chunk's row at p bitwise, then timed beside its bound, its
    plain version, the gather + SDPA yardstick and the decode kernel over
    the same sequences (one query each at the chunk's first position).
    Returns the verify columns of the chunk kernel's row."""
    import numpy as np
    import torch
    from grove_tpu_torch.ops import paged
    b, c, W, lo, hi = SPEC_VERIFY
    n_kv, g, d = 8, 2, 128
    h = n_kv * g
    dtype = torch.bfloat16
    lengths = rng.integers(lo, hi + 1, size=b).astype(np.int32)
    pool = "int8 pool" if int8 else "bf16 pool"
    if int8:
        kq, vq, ks, vs, tables = int8_pools(gen, lengths + c, W, n_kv, d)

        def chunk(q, offs):
            return paged.paged_chunk_attention_q8(q, kq, vq, ks, vs, tables,
                                                  offs)

        def chunk_ref(q, offs):
            return paged.paged_chunk_attention_ref(q, kq, vq, tables, offs,
                                                   ks, vs)

        def decode(q, lens):
            return paged.paged_decode_attention_q8(q, kq, vq, ks, vs, tables,
                                                   lens)

        def yard(q):
            return gather_q_sdpa(q, kq, vq, ks, vs, idx, mask)
    else:
        k, v, tables = paged_pools(gen, lengths + c, W, n_kv, d, dtype)

        def chunk(q, offs):
            return paged.paged_chunk_attention(q, k, v, tables, offs)

        def chunk_ref(q, offs):
            return paged.paged_chunk_attention_ref(q, k, v, tables, offs)

        def decode(q, lens):
            return paged.paged_decode_attention(q, k, v, tables, lens)

        def yard(q):
            return gather_sdpa(q, k, v, idx, mask)
    offs = torch.from_numpy(lengths).cuda()
    q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(dtype)
    idx = tables.reshape(-1).long()
    mask = (torch.arange(W * PAGED_BS, device="cuda")[None, None, :]
            <= (offs[:, None] + torch.arange(c, device="cuda")[None, :]
                )[:, :, None].long())[:, None]
    label = (f"paged chunk verify shape ({pool}) b={b} c={c} W={W} "
             f"lengths {lo}..{hi} h={h} n_kv={n_kv} d={d} bf16")
    out = chunk(q, offs)
    err = check_paged(out, chunk_ref(q, offs), label, "bfloat16")
    same = all(torch.equal(decode(q[:, i:i + 1].contiguous(), offs + i + 1)
                           [:, 0], out[:, i]) for i in range(c))
    log(f"kernels: bf16 row invariance ({pool}): decode at length p + 1 vs "
        f"verify chunk row p at b={b} c={c}: "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"verify rows differ from decode rows ({pool})")
    kv_rows = int(lengths.sum()) + b * c
    pairs = h * sum(int(n) * c + c * (c + 1) // 2 for n in lengths)
    t = time_paged(label, lambda: chunk(q, offs), lambda: chunk_ref(q, offs),
                   lambda: yard(q), paged_bound_ms(
                       kv_rows, b * c, pairs, n_kv, h, d, dtype, int8=int8),
                   card)
    q1 = q[:, :1].contiguous()
    dec_ms = time_ms(lambda: decode(q1, offs + 1))
    log(f"kernels: {label}: the decode kernel over the same sequences (one "
        f"query each, lengths + 1) {dec_ms} ms; verify / decode "
        f"{t['ms'] / dec_ms:.2f}x on {card}")
    return {"verify_ms": t["ms"], "verify_plain_ms": t["plain_ms"],
            "verify_bound_ms": t["bound_ms"],
            "verify_yardstick_ms": t["yardstick_ms"],
            "verify_decode_ms": dec_ms, "verify_max_abs_err": err}


def phase_paged_kernels(seed: int, card: str) -> list[dict]:
    """Both paged kernels against their plain versions at f32 and bf16,
    the bf16 row-invariance check, then timed at the serving shapes and at
    a long decode. Returns their kernel-table rows."""
    import numpy as np
    import torch
    from grove_tpu_torch.ops.paged import (paged_chunk_attention,
                                           paged_chunk_attention_ref,
                                           paged_decode_attention,
                                           paged_decode_attention_ref)
    paged_build_info()
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    errs = {"decode": 0.0, "chunk": 0.0}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for (B, W, n_kv, g, d) in PAGED_DECODE_CASES:
            lengths = decode_lengths(rng, B, W)
            k, v, tables = paged_pools(gen, lengths, W, n_kv, d, dtype)
            q = torch.randn((B, 1, n_kv * g, d), generator=gen,
                            device="cuda").to(dtype)
            lens = torch.from_numpy(lengths).cuda()
            out = paged_decode_attention(q, k, v, tables, lens)
            torch.cuda.synchronize()
            ref = paged_decode_attention_ref(q, k, v, tables, lens)
            errs["decode"] = max(errs["decode"], check_paged(
                out, ref, f"paged decode B={B} W={W} n_kv={n_kv} g={g} "
                f"d={d} lengths {lengths.min()}..{lengths.max()}", dt))
        for (off, n_valid, n_kv, g, d) in PAGED_CHUNK_CASES:
            backed = -(-(off + n_valid) // PAGED_BS)
            W = 1 << (backed - 1).bit_length()
            k, v, tables = paged_pools(gen, [off + n_valid] * 2, W, n_kv, d,
                                       dtype)
            q = torch.randn((2, PAGED_CHUNK, n_kv * g, d), generator=gen,
                            device="cuda").to(dtype)
            offs = torch.full((2,), off, dtype=torch.int32, device="cuda")
            out = paged_chunk_attention(q, k, v, tables, offs)
            torch.cuda.synchronize()
            ref = paged_chunk_attention_ref(q, k, v, tables, offs)
            errs["chunk"] = max(errs["chunk"], check_paged(
                out, ref, f"paged chunk b=2 c={PAGED_CHUNK} offset={off} "
                f"n_valid={n_valid} W={W} n_kv={n_kv} g={g} d={d}", dt))
    check_row_invariance(gen)

    rows = []
    dtype = torch.bfloat16
    n_kv, g, d = 8, 2, 128
    h = n_kv * g
    timed = {}
    for name, (B, W, lo, hi) in (("serving shape", SERVE_DECODE),
                                 ("long decode", LONG_DECODE)):
        lengths = rng.integers(lo, hi + 1, size=B).astype(np.int32)
        k, v, tables = paged_pools(gen, lengths, W, n_kv, d, dtype)
        q = torch.randn((B, 1, h, d), generator=gen, device="cuda").to(dtype)
        lens = torch.from_numpy(lengths).cuda()
        idx = tables.reshape(-1).long()
        mask = (torch.arange(W * PAGED_BS, device="cuda")[None, :]
                < lens[:, None].long())[:, None, None, :]
        label = (f"paged decode {name} B={B} W={W} lengths {lo}..{hi} "
                 f"h={h} n_kv={n_kv} d={d} bf16")
        err = check_paged(paged_decode_attention(q, k, v, tables, lens),
                          paged_decode_attention_ref(q, k, v, tables, lens),
                          label, "bfloat16")
        total = int(lengths.sum())
        timed[name] = (err, time_paged(
            label, lambda: paged_decode_attention(q, k, v, tables, lens),
            lambda: paged_decode_attention_ref(q, k, v, tables, lens),
            lambda: gather_sdpa(q, k, v, idx, mask),
            paged_bound_ms(total, B, h * total, n_kv, h, d, dtype), card))
        del k, v
    err, t = timed["serving shape"]
    rows.append({"name": "paged_decode_attention", "route": "cuda",
                 "source": "grove_tpu_torch/csrc/paged_attn.cu",
                 "replaces": "grove_tpu/models/llama.py:637",
                 "launches": 0,
                 "max_abs_err": max(err, errs["decode"],
                                    timed["long decode"][0]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "yardstick_ms": t["yardstick_ms"]})

    W = SERVE_DECODE[1]
    off, c = SERVE_CHUNK_OFFSET, PAGED_CHUNK
    k, v, tables = paged_pools(gen, [off + c], W, n_kv, d, dtype)
    q = torch.randn((1, c, h, d), generator=gen, device="cuda").to(dtype)
    offs = torch.full((1,), off, dtype=torch.int32, device="cuda")
    idx = tables.reshape(-1).long()
    mask = (torch.arange(W * PAGED_BS, device="cuda")[None, :]
            <= off + torch.arange(c, device="cuda")[:, None])[None, None]
    label = (f"paged chunk serving shape b=1 c={c} offset={off} W={W} "
             f"h={h} n_kv={n_kv} d={d} bf16")
    err = check_paged(paged_chunk_attention(q, k, v, tables, offs),
                      paged_chunk_attention_ref(q, k, v, tables, offs),
                      label, "bfloat16")
    pairs = h * sum(off + i + 1 for i in range(c))
    t = time_paged(
        label, lambda: paged_chunk_attention(q, k, v, tables, offs),
        lambda: paged_chunk_attention_ref(q, k, v, tables, offs),
        lambda: gather_sdpa(q, k, v, idx, mask),
        paged_bound_ms(off + c, c, pairs, n_kv, h, d, dtype), card)
    verify = time_verify_shape(gen, rng, card)
    rows.append({"name": "paged_chunk_attention", "route": "cuda",
                 "source": "grove_tpu_torch/csrc/paged_attn.cu",
                 "replaces": "grove_tpu/models/llama.py:710",
                 "launches": 0, "max_abs_err": max(
                     err, errs["chunk"], verify["verify_max_abs_err"]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "yardstick_ms": t["yardstick_ms"],
                 **verify})
    return rows


def int8_pools(gen, lengths, W, n_kv, d):
    """``paged_pools`` quantized as the int8 write does it: int8 pools, their
    f32 scales and the tables."""
    import torch
    from grove_tpu_torch.ops.kvquant import quantize_rows
    k, v, tables = paged_pools(gen, lengths, W, n_kv, d, torch.float32)
    (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
    return kq, vq, ks, vs, tables


def gather_q_sdpa(q, kq, vq, ks, vs, idx, mask):
    """The int8 yardstick: ``index_select`` of each int8 pool and its
    scales, the dequantize, then ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    b = q.shape[0]
    nb, bs, n_kv, d = kq.shape

    def rows(pool, scale):
        x = pool.index_select(0, idx).float() * scale.index_select(
            0, idx)[..., None]
        return x.to(q.dtype).view(b, -1, n_kv, d).transpose(1, 2)

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), rows(kq, ks), rows(vq, vs), attn_mask=mask,
        enable_gqa=True)


def check_scatter_q(gen, card: str) -> None:
    """The write kernel with rope off into int8 pools (``paged_scatter_q``)
    against its plain version, bitwise on codes and scales, for f32 and
    bf16 rows: one sequence's chunk running past its table's width, the
    other's padded tail marked invalid (both land in the null block, in
    distinct slots, so the comparison covers it); then timed at the decode
    step's shape. The paged path runs this kernel with rope on
    (``check_rope_scatter``)."""
    import numpy as np
    import torch
    from grove_tpu_torch.ops.kvquant import (paged_scatter_q,
                                             paged_scatter_q_ref)
    n_kv, d, W, c = 8, 128, 4, PAGED_CHUNK
    nb = 1 + 2 * W + 3
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(5))
    tables = (1 + perm[:2 * W]).reshape(2, W).to(torch.int32).cuda()
    steps = torch.arange(c, dtype=torch.int32, device="cuda")
    # Sequence 0 at offset 36: positions 64..67 lie past the table's 64
    # (null slots 0..3); sequence 1 at 0 with 24 valid rows: rows 24..31
    # are rerouted (null slots 8..15).
    positions = torch.stack([36 + steps, steps])
    valid = torch.ones((2, c), dtype=torch.bool, device="cuda")
    valid[1, 24:] = False
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        k = (3 * torch.randn((2, c, n_kv, d), generator=gen,
                             device="cuda")).to(dtype)
        v = torch.randn((2, c, n_kv, d), generator=gen,
                        device="cuda").to(dtype)
        k[0, 5, 3] = 0  # an all-zero row takes the floor scale
        pools = [torch.randint(-127, 128, (nb, PAGED_BS, n_kv, d),
                               generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((nb, PAGED_BS, n_kv), generator=gen,
                             device="cuda") for _ in range(2)]
        mine = [t.clone() for t in (*pools, *scales)]
        ref = [t.clone() for t in (*pools, *scales)]
        before = paged_scatter_q.launches
        paged_scatter_q(*mine, k, v, tables, positions, valid)
        torch.cuda.synchronize()
        if paged_scatter_q.launches != before + 1:
            raise AssertionError("the scatter wrapper did not count its "
                                 "launch")
        paged_scatter_q_ref(ref[0], ref[2], k, tables, positions, valid)
        paged_scatter_q_ref(ref[1], ref[3], v, tables, positions, valid)
        same = [torch.equal(a, b) for a, b in zip(mine, ref)]
        log(f"kernels: paged_scatter_q {dt} b=2 c={c} n_kv={n_kv} d={d} "
            f"W={W} (rows past the width and invalid rows in the null "
            f"block): codes K {same[0]}, V {same[1]}, scales K {same[2]}, "
            f"V {same[3]} bitwise equal to the plain version")
        if not all(same):
            raise AssertionError(f"the scatter kernel disagrees ({dt})")
    # The decode step's shape: one row per sequence at lengths 512..1024.
    B, Wd, lo, hi = SERVE_DECODE
    lengths = np.random.default_rng(17).integers(lo, hi, size=B)
    kq, vq, ks, vs, tables = int8_pools(gen, lengths + 1, Wd, n_kv, d)
    k = torch.randn((B, 1, n_kv, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((B, 1, n_kv, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pos = torch.from_numpy(lengths.astype(np.int32)).cuda()[:, None]
    rows = B * n_kv
    nbytes = 2 * rows * d * 2 + 2 * rows * (d + 4) + 2 * B * 4
    bound = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
    label = (f"paged_scatter_q decode shape B={B} s=1 n_kv={n_kv} d={d} "
             f"bf16 rows")
    time_paged(
        label, lambda: paged_scatter_q(kq, vq, ks, vs, k, v, tables, pos),
        lambda: (paged_scatter_q_ref(kq, ks, k, tables, pos),
                 paged_scatter_q_ref(vq, vs, v, tables, pos)),
        None, bound, card)


# What bound the int8 kernels before their redesign (PERF.md section 6,
# step 0): the PR 5 kernel and three variants of it, ms at the serving
# shapes on one NVIDIA H100 80GB HBM3 at 700 W.
STEP0_Q8 = (("as it was", 0.05952, 0.02564),
            ("with a dequantize that does no arithmetic", 0.05334, 0.02324),
            ("without mma and softmax", 0.05352, 0.01809),
            ("copies only", 0.04647, 0.01584))


def beside_bf16(label, ms, kq, vq, ks, vs, bf16_call, c: int,
                card: str) -> None:
    """The bf16 kernel at the int8 kernel's shape, on the int8 pools
    dequantized to bf16, timed in the same run; both builds' registers,
    spills and shared memory."""
    import torch
    from grove_tpu_torch.ops.paged import kernel_info
    kb = (kq.float() * ks[..., None]).to(torch.bfloat16)
    vb = (vq.float() * vs[..., None]).to(torch.bfloat16)
    bf16_ms = time_ms(lambda: bf16_call(kb, vb))
    which = "partial_chunk" if c > 1 else "partial"
    q8 = kernel_info(which, torch.bfloat16, kq.shape[3], int8_pool=True)
    bf = kernel_info(which, torch.bfloat16, kq.shape[3])
    log(f"kernels: {label}: int8 {ms} ms ({q8['registers']} registers, "
        f"{q8['local_bytes']} bytes spill, {q8['smem_bytes']} bytes shared "
        f"memory, {q8['stages']} stages) beside the bf16 kernel "
        f"{bf16_ms} ms at the same shape ({bf['registers']} registers, "
        f"{bf['local_bytes']} bytes spill, {bf['smem_bytes']} bytes shared "
        f"memory): int8 at {bf16_ms / ms:.2f}x the bf16 kernel's speed on "
        f"{card}")


def phase_int8_kernels(seed: int, card: str) -> list[dict]:
    """The write kernel with rope off into int8 pools, then both paged
    kernels over int8 pools against their plain versions (f32 and bf16
    queries), the bf16 row invariance over int8 pools, and the int8
    kernels timed at the serving shapes. Returns their two kernel-table
    rows."""
    import numpy as np
    import torch
    from grove_tpu_torch.ops.paged import (paged_chunk_attention,
                                           paged_chunk_attention_q8,
                                           paged_chunk_attention_ref,
                                           paged_decode_attention,
                                           paged_decode_attention_q8,
                                           paged_decode_attention_ref)
    for name, dec_ms, chunk_ms in STEP0_Q8:
        log(f"kernels: int8 step 0, the PR 5 kernel {name}: decode "
            f"{dec_ms} ms, chunk {chunk_ms} ms at the serving shapes "
            f"(earlier lines: measured once by a scratch copy, PERF.md "
            f"section 6; not re-run here)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    rng = np.random.default_rng(seed + 9)
    check_scatter_q(gen, card)
    rows = []
    errs = {"decode": 0.0, "chunk": 0.0}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for (B, W, n_kv, g, d) in PAGED_DECODE_CASES:
            lengths = decode_lengths(rng, B, W)
            kq, vq, ks, vs, tables = int8_pools(gen, lengths, W, n_kv, d)
            q = torch.randn((B, 1, n_kv * g, d), generator=gen,
                            device="cuda").to(dtype)
            lens = torch.from_numpy(lengths).cuda()
            out = paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lens)
            torch.cuda.synchronize()
            ref = paged_decode_attention_ref(q, kq, vq, tables, lens, ks, vs)
            errs["decode"] = max(errs["decode"], check_paged(
                out, ref, f"int8 paged decode B={B} W={W} n_kv={n_kv} g={g} "
                f"d={d} lengths {lengths.min()}..{lengths.max()}", dt))
        for (off, n_valid, n_kv, g, d) in PAGED_CHUNK_CASES:
            backed = -(-(off + n_valid) // PAGED_BS)
            W = 1 << (backed - 1).bit_length()
            kq, vq, ks, vs, tables = int8_pools(gen, [off + n_valid] * 2, W,
                                                n_kv, d)
            q = torch.randn((2, PAGED_CHUNK, n_kv * g, d), generator=gen,
                            device="cuda").to(dtype)
            offs = torch.full((2,), off, dtype=torch.int32, device="cuda")
            out = paged_chunk_attention_q8(q, kq, vq, ks, vs, tables, offs)
            torch.cuda.synchronize()
            ref = paged_chunk_attention_ref(q, kq, vq, tables, offs, ks, vs)
            errs["chunk"] = max(errs["chunk"], check_paged(
                out, ref, f"int8 paged chunk b=2 c={PAGED_CHUNK} offset={off} "
                f"n_valid={n_valid} W={W} n_kv={n_kv} g={g} d={d}", dt))
    check_row_invariance(gen, int8=True)

    n_kv, g, d = 8, 2, 128
    h = n_kv * g
    B, W, lo, hi = SERVE_DECODE
    lengths = rng.integers(lo, hi + 1, size=B).astype(np.int32)
    kq, vq, ks, vs, tables = int8_pools(gen, lengths, W, n_kv, d)
    lens = torch.from_numpy(lengths).cuda()
    idx = tables.reshape(-1).long()
    mask = (torch.arange(W * PAGED_BS, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]
    label = (f"int8 paged decode serving shape B={B} W={W} lengths "
             f"{lo}..{hi} h={h} n_kv={n_kv} d={d}")
    for dt in ("float32", "bfloat16"):
        q = torch.randn((B, 1, h, d), generator=gen,
                        device="cuda").to(getattr(torch, dt))
        err = check_paged(
            paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lens),
            paged_decode_attention_ref(q, kq, vq, tables, lens, ks, vs),
            label, dt)
        errs["decode"] = max(errs["decode"], err)
    total = int(lengths.sum())
    t = time_paged(
        label + " bf16",
        lambda: paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lens),
        lambda: paged_decode_attention_ref(q, kq, vq, tables, lens, ks, vs),
        lambda: gather_q_sdpa(q, kq, vq, ks, vs, idx, mask),
        paged_bound_ms(total, B, h * total, n_kv, h, d, q.dtype, int8=True),
        card, "index_select of each int8 pool and its scales, dequantize, "
        "scaled_dot_product_attention")
    beside_bf16(label, t["ms"], kq, vq, ks, vs,
                lambda k, v: paged_decode_attention(q, k, v, tables, lens),
                1, card)
    rows.append({"name": "paged_decode_attention_q8", "route": "cuda",
                 "source": "grove_tpu_torch/csrc/paged_attn.cu",
                 "replaces": "grove_tpu/models/llama.py:634",
                 "launches": 0, "max_abs_err": errs["decode"],
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "yardstick_ms": t["yardstick_ms"]})

    off, c = SERVE_CHUNK_OFFSET, PAGED_CHUNK
    kq, vq, ks, vs, tables = int8_pools(gen, [off + c], W, n_kv, d)
    offs = torch.full((1,), off, dtype=torch.int32, device="cuda")
    idx = tables.reshape(-1).long()
    mask = (torch.arange(W * PAGED_BS, device="cuda")[None, :]
            <= off + torch.arange(c, device="cuda")[:, None])[None, None]
    label = (f"int8 paged chunk serving shape b=1 c={c} offset={off} W={W} "
             f"h={h} n_kv={n_kv} d={d}")
    for dt in ("float32", "bfloat16"):
        q = torch.randn((1, c, h, d), generator=gen,
                        device="cuda").to(getattr(torch, dt))
        err = check_paged(
            paged_chunk_attention_q8(q, kq, vq, ks, vs, tables, offs),
            paged_chunk_attention_ref(q, kq, vq, tables, offs, ks, vs),
            label, dt)
        errs["chunk"] = max(errs["chunk"], err)
    pairs = h * sum(off + i + 1 for i in range(c))
    t = time_paged(
        label + " bf16",
        lambda: paged_chunk_attention_q8(q, kq, vq, ks, vs, tables, offs),
        lambda: paged_chunk_attention_ref(q, kq, vq, tables, offs, ks, vs),
        lambda: gather_q_sdpa(q, kq, vq, ks, vs, idx, mask),
        paged_bound_ms(off + c, c, pairs, n_kv, h, d, q.dtype, int8=True),
        card, "index_select of each int8 pool and its scales, dequantize, "
        "scaled_dot_product_attention")
    beside_bf16(label, t["ms"], kq, vq, ks, vs,
                lambda k, v: paged_chunk_attention(q, k, v, tables, offs),
                c, card)
    verify = time_verify_shape(gen, rng, card, int8=True)
    rows.append({"name": "paged_chunk_attention_q8", "route": "cuda",
                 "source": "grove_tpu_torch/csrc/paged_attn.cu",
                 "replaces": "grove_tpu/models/llama.py:707",
                 "launches": 0, "max_abs_err": max(
                     errs["chunk"], verify["verify_max_abs_err"]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "yardstick_ms": t["yardstick_ms"],
                 **verify})
    return rows


# ---- the W8A16 GEMM and the model-dtype KV write ----

W8A16_LAUNCHES = [                        # name, K, N of each weight, per forward
    ("wq, wk, wv", 2048, (2048, 1024, 1024), 16),  # one launch per layer
    ("wo", 2048, (2048,), 16),
    ("w_gate, w_up", 2048, (5632, 5632), 16),
    ("w_down", 5632, (2048,), 16),
    ("lm_head", 2048, (32000,), 1),
]
GEMMS_PER_LAYER = 4                       # launches of the GEMM per layer
W8A16_M = 32                              # the decode batch and the chunk
W8A16_PREFILL_M = 4096                    # the lanes prefill, 32 x 128
ROW_CHECK_M = (1, 2, 7, 8, 31, 32, 33, 64, 65, 128, 129, 192, 193, 256)
W8A16_TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # relative to max |plain|:
# bf16 one output rounding (2^-8) after another sum order; f32 the order
ROTATE_BYTES = 128 << 20                  # weights cycled per timing: > L2


def w8a16_bound_ms(M: int, K: int, ns, out_elt: int) -> tuple[float, str]:
    """Least time for one launch: the int8 weights, their bf16 scales and x
    (bf16) read once and the outputs written once at the memory rate,
    against 2 M K N operations at the bf16 tensor-core peak."""
    N = sum(ns)
    nbytes = K * N + 2 * N + 2 * M * K + out_elt * M * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_weights(gen, K: int, ns):
    """Random int8 weights [K, n] with bf16 column scales, one per n."""
    import torch
    return [(torch.randint(-127, 128, (K, n), generator=gen, device="cuda",
                           dtype=torch.int8),
             (torch.rand((n,), generator=gen, device="cuda") * 2e-3
              + 1e-4).to(torch.bfloat16)) for n in ns]


def check_w8a16(x, weights, out, label: str) -> float:
    """One launch against the plain version of each weight, within
    W8A16_TOL relative to max |plain|."""
    import torch
    from grove_tpu_torch.ops.w8a16 import (w8a16_matmul, w8a16_matmul_group,
                                           w8a16_matmul_ref)
    before = w8a16_matmul.launches
    got = w8a16_matmul_group(x, weights, out)
    torch.cuda.synchronize()
    launched = w8a16_matmul.launches - before
    dt = str(out)[6:]
    tol = W8A16_TOL[dt]
    err, ok = 0.0, launched == 1
    for g, (q, s) in zip(got, weights):
        want = w8a16_matmul_ref(x, q, s, out)
        err = max(err, (g.float() - want.float()).abs().max().item())
        bound = tol * want.float().abs().max().item()
        ok = ok and g.dtype == out and bool(torch.isfinite(g).all()) and \
            torch.allclose(g.float(), want.float(), rtol=tol, atol=bound)
    log(f"kernels: w8a16 {label} -> {dt}: max_abs_err={err:.3e} (rtol "
        f"{tol}, atol {tol} x max |plain|), {launched} launch "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"w8a16 kernel disagrees at {label}")
    return err


def time_w8a16(gen, M: int, K: int, ns, out, label: str, card: str) -> dict:
    """Kernel (one launch for the weights ``ns``), plain, yardstick
    (torch.matmul against each bf16 weight dequantized once) and library
    (torch._weight_int8pack_mm per weight) device ms, each cycling through
    enough distinct weights that every call reads its weights from device
    memory, not from the 50 MB L2."""
    import itertools
    import torch
    from grove_tpu_torch.ops.w8a16 import (w8a16_matmul_group,
                                           w8a16_matmul_group_ref,
                                           w8a16_matmul_ref)
    copies = max(2, -(-ROTATE_BYTES // (K * sum(ns))))
    sets = [int8_weights(gen, K, ns) for _ in range(copies)]
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    err = check_w8a16(x, sets[0], out, f"{label} M={M}")
    iters = 2 * copies if copies > 10 else 20

    def cycled(fn, items):
        it = itertools.cycle(items)
        return lambda: fn(next(it))

    t = {"ms": time_ms(cycled(lambda ws: w8a16_matmul_group(x, ws, out),
                              sets), iters=iters),
         "plain_ms": time_ms(cycled(
             lambda ws: w8a16_matmul_group_ref(x, ws, out), sets),
             iters=iters)}
    dense = [[q.to(torch.bfloat16) * s for q, s in ws] for ws in sets]
    t["yardstick_ms"] = time_ms(cycled(lambda ws: [x @ w for w in ws],
                                       dense), iters=iters)
    del dense
    packed = [[(q.t().contiguous(), s) for q, s in ws] for ws in sets]
    try:
        lib = torch._weight_int8pack_mm(x, *packed[0][0])
        torch.cuda.synchronize()
        ref = w8a16_matmul_ref(x, *sets[0][0], torch.bfloat16).float()
        log(f"kernels: w8a16 {label}: torch._weight_int8pack_mm agrees with "
            f"the plain version to {(lib.float() - ref).abs().max().item():.3e}")
        t["library_ms"] = time_ms(cycled(
            lambda ws: [torch._weight_int8pack_mm(x, q, s) for q, s in ws],
            packed), iters=iters)
    except (RuntimeError, NotImplementedError) as e:
        t["library_ms"] = None
        log(f"kernels: w8a16 {label}: torch._weight_int8pack_mm does not run "
            f"here ({type(e).__name__}: {str(e).splitlines()[0][:120]}); "
            f"library_ms null")
    del packed
    t["bound_ms"], t["bound_by"] = w8a16_bound_ms(
        M, K, ns, torch.empty((), dtype=out).element_size())
    t["err"] = err
    dispatch = host_us(lambda: w8a16_matmul_group(x, sets[0], out))
    log(f"kernels: w8a16 {label} M={M} K={K} N={list(ns)} ({copies} weight "
        f"sets cycled): ms={t['ms']} plain_ms={t['plain_ms']} yardstick_ms="
        f"{t['yardstick_ms']} library_ms={t['library_ms']} bound_ms="
        f"{t['bound_ms']} ({t['bound_by']}) on {card}")
    log(f"kernels: w8a16 {label} M={M}: kernel at "
        f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound, "
        f"{t['yardstick_ms'] / t['ms']:.2f}x the bf16-weight matmul's speed, "
        f"{t['plain_ms'] / t['ms']:.2f}x the plain version's; wrapper "
        f"dispatch {dispatch:.1f} us per call on the host")
    return t


def check_w8a16_rows(gen, K: int, ns, out, label: str) -> None:
    """Bitwise: each row of a launch with M rows equals the same row inside
    a launch with 256 rows, for every M of ROW_CHECK_M."""
    import torch
    from grove_tpu_torch.ops.w8a16 import w8a16_matmul_group
    weights = int8_weights(gen, K, ns)
    x = torch.randn((max(ROW_CHECK_M), K), generator=gen,
                    device="cuda").to(torch.bfloat16)
    whole = w8a16_matmul_group(x, weights, out)
    same = {M: all(torch.equal(a, w[:M]) for a, w in zip(
        w8a16_matmul_group(x[:M], weights, out), whole))
        for M in ROW_CHECK_M}
    torch.cuda.synchronize()
    log(f"kernels: w8a16 row invariance {label} K={K} N={list(ns)}: rows of "
        f"M in {list(ROW_CHECK_M)} vs the same rows at M=256: " + ", ".join(
            f"{M} {'equal' if v else 'DIFFER'}" for M, v in same.items()))
    if not all(same.values()):
        raise AssertionError(f"w8a16 rows depend on M ({label})")


def w8a16_host_parts(gen) -> None:
    """Host microseconds per call of the GEMM wrapper at the QKV launch (M
    = 32), and of its parts: the plan's key and lookup, the output's
    allocation, the foreign call (x's tensor map and the launch); beside
    them one small PyTorch launch (``zero_`` of a 32-row output)."""
    import torch
    from grove_tpu_torch.ops import w8a16
    ws = int8_weights(gen, 2048, (2048, 1024, 1024))
    x = torch.randn((32, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    w8a16.w8a16_matmul_group(x, ws)

    def key():
        return w8a16._plan_key(x, [q for q, _ in ws], [s for _, s in ws],
                               torch.bfloat16, "int8", False)

    addr, _, _, total, _ = w8a16._plans[key()]
    out = torch.empty((32 * total,), dtype=torch.bfloat16, device="cuda")
    _, run, _, _, _ = w8a16._kernel()
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    parts = {
        "whole call": lambda: w8a16.w8a16_matmul_group(x, ws),
        "plan key and lookup": lambda: w8a16._plans.get(key()),
        "torch.empty of the outputs": lambda: torch.empty(
            (32 * total,), dtype=torch.bfloat16, device="cuda"),
        "current stream": lambda: torch._C._cuda_getCurrentRawStream(
            x.get_device()),
        "foreign call (x map + launch)": lambda: run(
            addr, x.data_ptr(), out.data_ptr(), 32, 256, stream),
        "reference: out.zero_()": lambda: out.zero_(),
    }
    log("kernels: w8a16 wrapper host time, us per call over 200 calls: "
        + ", ".join(f"{name} {host_us(fn, iters=200):.1f}"
                    for name, fn in parts.items()))


def phase_w8a16_kernels(seed: int, card: str) -> dict:
    """The W8A16 GEMM: each build's registers, spills, shared memory,
    cluster size and residency;
    against its plain version at llama-1b's launches (M = 32, and M = 4,096
    for the MLP's gate and up), at ragged and f32 shapes; the row
    invariance; times. Returns its kernel-table row, whose times are the
    sums over one llama-1b forward at M = 32 (65 launches)."""
    import torch
    from grove_tpu_torch.ops.w8a16 import kernel_info
    for which in ("small", "wide", "fma"):
        info = kernel_info(which)
        resident = (f"{info['resident']} clusters of {info['cluster']} "
                    f"resident at once" if info["cluster"] > 1 else
                    f"{info['resident']} CTAs per SM")
        log(f"kernels: build w8a16 {which} (tile {info['tile'][0]} x "
            f"{info['tile'][1]}): {info['registers']} registers, "
            f"{info['local_bytes']} bytes local (spill) per thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory per CTA, "
            f"cluster size up to {info['cluster']}, {resident}")
        if info["local_bytes"]:
            raise AssertionError(f"the w8a16 {which} kernel spills")
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    err = 0.0
    # Ragged rows and columns (tiles of 128 cut at 32 and 48), test-tiny's
    # shapes, grouped launches at M = 1, 8, 64 and 256 (splits 8, 8, 4, 8),
    # and f32 activations (the CUDA-core kernel).
    for M, K, ns, dt, out in (
            (1, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
            (8, 5632, (2048,), torch.bfloat16, torch.bfloat16),
            (64, 2048, (5632, 5632), torch.bfloat16, torch.bfloat16),
            (256, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
            (5, 64, (32,), torch.bfloat16, torch.bfloat16),
            (7, 128, (64, 32, 48), torch.bfloat16, torch.bfloat16),
            (300, 128, (256,), torch.bfloat16, torch.float32),
            (300, 2048, (1024, 512), torch.bfloat16, torch.bfloat16),
            (3, 64, (256, 32), torch.float32, torch.float32),
            (32, 2048, (2048, 1024, 1024), torch.float32, torch.float32),
            (300, 5632, (2048,), torch.float32, torch.float32)):
        x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        err = max(err, check_w8a16(x, int8_weights(gen, K, ns), out,
                                   f"{str(dt)[6:]} x M={M} K={K} "
                                   f"N={list(ns)}"))
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "yardstick_ms": 0.0,
           "library_ms": 0.0}
    launches = 0
    for name, K, ns, calls in W8A16_LAUNCHES:
        out = torch.float32 if name == "lm_head" else torch.bfloat16
        t = time_w8a16(gen, W8A16_M, K, ns, out, name, card)
        err = max(err, t["err"])
        launches += calls
        for key in row:
            if row[key] is not None:
                row[key] = None if t[key] is None else \
                    row[key] + calls * t[key]
    for key, v in row.items():
        log(f"kernels: w8a16 one llama-1b forward at M={W8A16_M} ({launches} "
            f"launches): {key}={v} on {card}")
    w8a16_host_parts(gen)
    t = time_w8a16(gen, W8A16_PREFILL_M, 2048, (5632, 5632), torch.bfloat16,
                   "w_gate, w_up (lanes prefill)", card)
    err = max(err, t["err"])
    check_w8a16_rows(gen, 2048, (2048, 1024, 1024), torch.bfloat16,
                     "wq, wk, wv")
    check_w8a16_rows(gen, 2048, (2048,), torch.bfloat16, "wo")
    check_w8a16_rows(gen, 2048, (32000,), torch.float32, "lm_head")
    return {"name": "w8a16_matmul", "route": "cuda",
            "source": "grove_tpu_torch/csrc/w8a16_gemm.cu",
            "replaces": "grove_tpu/serving/quant.py:42",
            "launches": 0, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
            "yardstick_ms": row["yardstick_ms"],
            "per": f"one llama-1b forward at M={W8A16_M}: {launches} "
                   f"launches"}


DENSE_M = (8, 32, 128, 256)               # small and full decode; the k = 3
# and k = 7 verifies at b = 32 (one to four token tiles of the dense kernel)
SLAB_M = 512                              # a verify of batch 64 at k = 7


def dense_bound_ms(M: int, K: int, ns, out_elt: int) -> tuple[float, str]:
    """Least time for one dense launch: the bf16 weights and x read once
    and the outputs written once at the memory rate, against 2 M K N
    operations at the bf16 tensor-core peak."""
    N = sum(ns)
    nbytes = 2 * K * N + 2 * M * K + out_elt * M * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_weights(gen, K: int, ns):
    """Random dense bf16 weights [K, n], scaled by K^-1/2."""
    import torch
    return [(torch.randn((K, n), generator=gen, device="cuda")
             * K ** -0.5).to(torch.bfloat16) for n in ns]


def check_dense(x, ws, out, label: str) -> float:
    """One dense call against ``dense_matmul_ref`` of each weight, within
    W8A16_TOL relative to max |plain|; counts its launches (one per slab
    of 256 rows)."""
    import torch
    from grove_tpu_torch.ops.w8a16 import (dense_matmul, dense_matmul_group,
                                           dense_matmul_ref, slabs)
    before = dense_matmul.launches
    got = dense_matmul_group(x, ws, out)
    torch.cuda.synchronize()
    launched = dense_matmul.launches - before
    dt = str(out)[6:]
    tol = W8A16_TOL[dt]
    err, ok = 0.0, launched == len(slabs(x.shape[0]))
    for g, w in zip(got, ws):
        want = dense_matmul_ref(x, w, out)
        err = max(err, (g.float() - want.float()).abs().max().item())
        bound = tol * want.float().abs().max().item()
        ok = ok and g.dtype == out and bool(torch.isfinite(g).all()) and \
            torch.allclose(g.float(), want.float(), rtol=tol, atol=bound)
    log(f"kernels: dense {label} -> {dt}: max_abs_err={err:.3e} (rtol "
        f"{tol}, atol {tol} x max |plain|), {launched} launch(es) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dense GEMM kernel disagrees at {label}")
    return err


def time_dense(gen, M: int, K: int, ns, out, label: str,
               plain: bool = True) -> dict:
    """Kernel (one launch for the weights ``ns``), plain (with ``plain``)
    and library (``torch.matmul`` of x by each bf16 weight, a bf16 result)
    device ms, each cycling through enough distinct weights that every call
    reads its weights from device memory, not from the 50 MB L2."""
    import itertools
    import torch
    from grove_tpu_torch.ops.w8a16 import (dense_matmul_group,
                                           dense_matmul_ref)
    copies = max(2, -(-ROTATE_BYTES // (2 * K * sum(ns))))
    sets = [bf16_weights(gen, K, ns) for _ in range(copies)]
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    err = check_dense(x, sets[0], out, f"{label} M={M}")
    iters = 2 * copies if copies > 10 else 20

    def cycled(fn):
        it = itertools.cycle(sets)
        return lambda: fn(next(it))

    t = {"ms": time_ms(cycled(lambda ws: dense_matmul_group(x, ws, out)),
                       iters=iters),
         "plain_ms": time_ms(cycled(lambda ws: [dense_matmul_ref(x, w, out)
                                                for w in ws]), iters=iters)
         if plain else 0.0,
         "library_ms": time_ms(cycled(lambda ws: [torch.matmul(x, w)
                                                  for w in ws]),
                               iters=iters)}
    t["bound_ms"], t["bound_by"] = dense_bound_ms(
        M, K, ns, torch.empty((), dtype=out).element_size())
    t["err"] = err
    return t


def dense_rows_and_slabs(gen, K: int, ns, out, label: str) -> None:
    """Bitwise: each dense row at M in ROW_CHECK_M equals the same row at
    M = 256, and each row of a slabbed call at M = SLAB_M equals the same
    row in a call of at most 256 rows; the same slab check for int8
    weights (``w8a16_matmul_group(..., slabbed=True)``)."""
    import torch
    from grove_tpu_torch.ops.w8a16 import (dense_matmul_group,
                                           w8a16_matmul_group)
    ws = bf16_weights(gen, K, ns)
    qs = int8_weights(gen, K, ns)
    x = torch.randn((SLAB_M, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    whole = dense_matmul_group(x[:256], ws, out)
    rows = {M: all(torch.equal(a, w[:M]) for a, w in zip(
        dense_matmul_group(x[:M], ws, out), whole)) for M in ROW_CHECK_M}
    slab = {}
    for kind, call in (
            ("bf16", lambda xx: dense_matmul_group(xx, ws, out)),
            ("int8", lambda xx: w8a16_matmul_group(xx, qs, out,
                                                   slabbed=True))):
        big = call(x)
        slab[kind] = all(
            torch.equal(a, b[r0:r0 + n])
            for r0, n in ((0, 1), (0, 256), (100, 200), (255, 2),
                          (256, 256), (300, 37), (511, 1))
            for a, b in zip(call(x[r0:r0 + n]), big))
    torch.cuda.synchronize()
    log(f"kernels: dense row invariance {label} K={K} N={list(ns)}: rows "
        f"of M in {list(ROW_CHECK_M)} vs the same rows at M=256: "
        + ", ".join(f"{M} {'equal' if v else 'DIFFER'}"
                    for M, v in rows.items())
        + f"; slabs at M={SLAB_M} vs the same rows at M <= 256: bf16 "
        f"weights {'equal' if slab['bf16'] else 'DIFFER'}, int8 weights "
        f"{'equal' if slab['int8'] else 'DIFFER'}")
    if not (all(rows.values()) and all(slab.values())):
        raise AssertionError(f"dense GEMM or slab rows depend on M ({label})")


def dense_build_info() -> None:
    """The dense kernel's builds for one to four token tiles (64 to 256
    rows): registers, spills, shared memory, stages, CTAs per SM and
    clusters of 8 co-resident, beside the int8 build's (a kernel of its
    own, whose registers and spills must not move); the CTAs and split of
    each of llama-1b's five launches (the same at every M <= 256). Fails on
    any spill, or if a build's geometry is not the one ``dense_geometry``
    mirrors."""
    from grove_tpu_torch.ops.w8a16 import dense_geometry, kernel_info
    q = kernel_info("small")
    log(f"kernels: build w8a16 int8 (small, tile {q['tile'][0]} x "
        f"{q['tile'][1]}): {q['registers']} registers, {q['local_bytes']} "
        f"bytes local (spill), {q['smem_bytes']} bytes shared memory, "
        f"{q['per_sm']} CTAs per SM, {q['resident']} clusters of "
        f"{q['cluster']} resident")
    bad = q["local_bytes"] > 0
    for tiles in (1, 2, 3, 4):
        geo = dense_geometry(64 * tiles, 2048, (2048,))
        info = kernel_info(geo["build"])
        log(f"kernels: build {geo['build']} (bf16 weights, wgmma m64n"
            f"{geo['n']}k16, up to {info['tile'][0]} rows x "
            f"{info['tile'][1]} columns): {info['registers']} registers, "
            f"{info['local_bytes']} bytes local (spill) per thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory per CTA, "
            f"{info['stages']} stages, {info['per_sm']} CTAs per SM, "
            f"{info['resident']} clusters of {info['cluster']} resident at "
            f"once")
        bad = bad or info["local_bytes"] > 0
        if (info["tile"], info["smem_bytes"], info["stages"],
                info["per_sm"]) != ((geo["n"], geo["columns"]),
                                    geo["smem_bytes"], geo["stages"],
                                    geo["per_sm"]):
            raise AssertionError(f"{geo['build']}: built geometry {info} is "
                                 f"not dense_geometry's {geo}")
    if bad:
        raise AssertionError("a w8a16 or dense GEMM build spills")
    log("kernels: dense CTAs per launch at every M <= 256 (column tiles x "
        "split): " + ", ".join(
            f"{name} {g['ctas']} (split {g['split']})"
            for name, K, ns, _ in W8A16_LAUNCHES
            for g in (dense_geometry(32, K, ns),)))


def phase_dense_kernels(seed: int, card: str) -> dict:
    """The dense (bf16-weight) GEMM kernel (the engine's default weights):
    its builds' registers, spills and shared memory; against its plain
    version at llama-1b's five launches at every M of DENSE_M (the head
    with an f32 output) and at ragged and f32 shapes; rows bitwise across M
    and across slabs (int8 weights too); times per forward beside the byte
    bound and torch.matmul at each M. Returns its kernel-table row (one
    forward at M = 32; the other M's times beside it)."""
    import torch
    dense_build_info()
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    err = 0.0
    # The tiny draft's shapes (K = 32: one partial k-step; N = 8) at one and
    # three token tiles, ragged columns, slabbed calls, f32 weights (the
    # CUDA-core kernel).
    for M, K, ns, dt, out in (
            (7, 32, (16, 8, 8), torch.bfloat16, torch.bfloat16),
            (130, 32, (16, 8, 8), torch.bfloat16, torch.float32),
            (5, 512, (40, 1408), torch.bfloat16, torch.float32),
            (256, 512, (1408, 1408), torch.bfloat16, torch.bfloat16),
            (300, 2048, (2048, 1024, 1024), torch.bfloat16, torch.bfloat16),
            (9, 64, (256, 32), torch.float32, torch.float32)):
        x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        ws = [w.to(dt) for w in bf16_weights(gen, K, ns)]
        err = max(err, check_dense(x, ws, out, f"{str(dt)[6:]} M={M} K={K} "
                                               f"N={list(ns)}"))
    per_m = {}
    for M in DENSE_M:
        row = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"),
                            0.0)
        for name, K, ns, calls in W8A16_LAUNCHES:
            out = torch.float32 if name == "lm_head" else torch.bfloat16
            t = time_dense(gen, M, K, ns, out, name, plain=M == W8A16_M)
            err = max(err, t["err"])
            log(f"kernels: dense {name} M={M} K={K} N={list(ns)}: ms="
                f"{t['ms']} plain_ms={t['plain_ms']} library_ms="
                f"{t['library_ms']} bound_ms={t['bound_ms']} "
                f"({t['bound_by']}) on {card}")
            for key in row:
                row[key] += calls * t[key]
        log(f"kernels: dense one llama-1b forward at M={M} (65 launches): "
            + ", ".join(f"{k}={v}" for k, v in row.items() if v)
            + f"; {100 * row['bound_ms'] / row['ms']:.1f}% of its bound, "
            f"{row['library_ms'] / row['ms']:.3f}x torch.matmul's speed on "
            f"{card}")
        per_m[M] = row
    dense_rows_and_slabs(gen, 2048, (2048, 1024, 1024), torch.bfloat16,
                         "wq, wk, wv")
    dense_rows_and_slabs(gen, 2048, (32000,), torch.float32, "lm_head")
    row = per_m[W8A16_M]
    return {"name": "dense_matmul", "route": "cuda",
            "source": "grove_tpu_torch/csrc/w8a16_gemm.cu",
            "replaces": "grove_tpu/models/llama.py:157",
            "launches": 0, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
            **{f"ms_m{M}": per_m[M]["ms"] for M in DENSE_M if M != W8A16_M},
            **{f"library_ms_m{M}": per_m[M]["library_ms"]
               for M in DENSE_M if M != W8A16_M},
            "per": f"one llama-1b forward at M={W8A16_M}: 65 launches"}


def check_scatter(gen, card: str) -> None:
    """The write kernel with rope off into pools of the rows' type
    (``paged_scatter``) against its plain version, bitwise on both pools,
    for f32 and bf16 rows: one sequence's chunk running past its table's
    width, the other's padded tail marked invalid (both land in the null
    block, in distinct slots); then timed at the decode step's shape beside
    ``index_put_`` per pool. The paged path runs this kernel with rope on
    (``check_rope_scatter``)."""
    import numpy as np
    import torch
    from grove_tpu_torch.ops.kvquant import paged_scatter, paged_scatter_ref
    n_kv, d, W, c = 8, 128, 4, PAGED_CHUNK
    nb = 1 + 2 * W + 3
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(6))
    tables = (1 + perm[:2 * W]).reshape(2, W).to(torch.int32).cuda()
    steps = torch.arange(c, dtype=torch.int32, device="cuda")
    positions = torch.stack([36 + steps, steps])
    valid = torch.ones((2, c), dtype=torch.bool, device="cuda")
    valid[1, 24:] = False
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        k, v = (torch.randn((2, c, n_kv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        pools = [torch.randn((nb, PAGED_BS, n_kv, d), generator=gen,
                             device="cuda").to(dtype) for _ in range(2)]
        mine = [t.clone() for t in pools]
        before = paged_scatter.launches
        paged_scatter(*mine, k, v, tables, positions, valid)
        torch.cuda.synchronize()
        if paged_scatter.launches != before + 1:
            raise AssertionError("the scatter wrapper did not count its "
                                 "launch")
        paged_scatter_ref(pools[0], k, tables, positions, valid)
        paged_scatter_ref(pools[1], v, tables, positions, valid)
        same = [torch.equal(a, b) for a, b in zip(mine, pools)]
        log(f"kernels: paged_scatter {dt} b=2 c={c} n_kv={n_kv} d={d} W={W} "
            f"(rows past the width and invalid rows in the null block): K "
            f"pool {same[0]}, V pool {same[1]} bitwise equal to the plain "
            f"version")
        if not all(same):
            raise AssertionError(f"the scatter kernel disagrees ({dt})")
    B, Wd, lo, hi = SERVE_DECODE
    lengths = np.random.default_rng(18).integers(lo, hi, size=B)
    kp, vp, tables = paged_pools(gen, lengths + 1, Wd, n_kv, d,
                                 torch.bfloat16)
    k, v = (torch.randn((B, 1, n_kv, d), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    pos = torch.from_numpy(lengths.astype(np.int32)).cuda()[:, None]
    nbytes = 2 * 2 * B * n_kv * d * 2 + 2 * B * 4
    label = f"paged_scatter decode shape B={B} s=1 n_kv={n_kv} d={d} bf16"
    t = time_paged(
        label, lambda: paged_scatter(kp, vp, k, v, tables, pos),
        lambda: (paged_scatter_ref(kp, k, tables, pos),
                 paged_scatter_ref(vp, v, tables, pos)),
        None, (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), card)
    # The library call: one index_put_ per pool at the (block, offset)
    # pairs the table gives these positions (computed outside the timing),
    # first held bitwise to the kernel's write.
    rows = torch.arange(B, device="cuda")
    blocks = tables[rows, pos[:, 0] // PAGED_BS].long()
    offsets = (pos[:, 0] % PAGED_BS).long()
    k2, v2 = k.reshape(B, n_kv, d), v.reshape(B, n_kv, d)
    mine = [kp.clone(), vp.clone()]
    paged_scatter(*mine, k, v, tables, pos)
    kp.index_put_((blocks, offsets), k2)
    vp.index_put_((blocks, offsets), v2)
    torch.cuda.synchronize()
    if not (torch.equal(mine[0], kp) and torch.equal(mine[1], vp)):
        raise AssertionError("index_put_ does not write what the scatter "
                             "kernel writes")
    t["library_ms"] = time_ms(lambda: (kp.index_put_((blocks, offsets), k2),
                                       vp.index_put_((blocks, offsets), v2)))
    log(f"kernels: {label} library_ms={t['library_ms']} (index_put_ per "
        f"pool, bitwise equal to the kernel's write) on {card}; kernel "
        f"{t['library_ms'] / t['ms']:.2f}x its speed")


def rope_scatter_bound_ms(rows: int, h: int, n_kv: int, d: int, elt: int,
                          int8: bool, valid: bool) -> tuple[float, str]:
    """Least time for one fused call: q read and written, k and v read,
    k and v written into the pool (d codes and a 4-byte scale per kv head
    for an int8 pool), each row's cos and sin entries, its position, its
    table entry and its valid flag read once, at the memory rate (a few
    flops per value: bytes bound)."""
    kv_row = d + 4 if int8 else d * elt
    nbytes = rows * (2 * h * d * elt + 2 * n_kv * d * elt + 2 * n_kv * kv_row
                     + d * 4 + 4 + 4 + (1 if valid else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def rope_scatter_cases(gen, dtype, rope_len: int):
    """Inputs of the two bitwise cases at llama-1b's heads: the decode
    shape (B = 32, s = 1, W = 64) with rows 0..3 past the table's width,
    rows 4..7 invalid, rows 8..9 at positions past a rope table of
    ``rope_len`` rows inside the table; and the chunk shape (b = 1, c = 32
    at offset 992) over a table of 63 blocks, so rows 16..31 run past its
    width, rows 24..31 are invalid and rows 8..31 lie past the rope table.
    Every row that lands in the null block takes a slot of its own. Yields
    (label, q, k, v, tables, positions, valid)."""
    import numpy as np
    import torch
    h, n_kv, d = 16, 8, 128
    B, W, lo, _ = SERVE_DECODE
    lengths = np.random.default_rng(19).integers(lo, rope_len, size=B)
    lengths[:4] = W * PAGED_BS + np.arange(4)   # null slots 0..3
    lengths[4:8] = lo + 4 + np.arange(4)        # invalid: null slots 4..7
    lengths[8:10] = (rope_len, rope_len + 9)
    _, _, tables = paged_pools(gen, np.minimum(lengths + 1, W * PAGED_BS), W,
                               1, 8, torch.float32)
    valid = torch.ones((B, 1), dtype=torch.bool, device="cuda")
    valid[4:8] = False
    pos = torch.from_numpy(lengths.astype(np.int32)).cuda()[:, None]
    c, off = PAGED_CHUNK, SERVE_CHUNK_OFFSET
    _, _, ctables = paged_pools(gen, [63 * PAGED_BS], 63, 1, 8, torch.float32)
    cpos = (off + torch.arange(c, dtype=torch.int32, device="cuda"))[None]
    cvalid = (torch.arange(c, device="cuda") < 24)[None]
    for label, b, s, t, p, ok in (
            (f"decode shape B={B} s=1 W={W}", B, 1, tables, pos, valid),
            (f"chunk shape b=1 c={c} offset {off} W=63", 1, c, ctables, cpos,
             cvalid)):
        q = (4 * torch.randn((b, s, h, d), generator=gen,
                             device="cuda")).to(dtype)
        k, v = ((4 * torch.randn((b, s, n_kv, d), generator=gen,
                                 device="cuda")).to(dtype) for _ in range(2))
        k[0, 0, 3] = 0  # an all-zero row takes the floor scale
        yield label, q, k, v, t, p, ok


def check_rope_scatter(gen, card: str) -> list[dict]:
    """The fused rope + KV write (the paged path's write, one launch per
    layer) against its plain version (``apply_rope`` on q and k, then the
    plain scatter of each pool), bitwise on q, both pools and the int8
    scales: f32 and bf16 rows, pools of the rows' type and int8, at the
    decode and chunk shapes of ``rope_scatter_cases`` (rows past the
    table's width, invalid rows, positions past the rope table). Then
    timed at the serving shapes over the model's rope table, beside its
    bound, its plain version and the unfused sequence it replaced (two
    ``apply_rope`` and the write kernel with rope off: a yardstick of the
    launches saved; no PyTorch call computes this). Returns the kernel-
    table rows of the two pools (times at the decode shape)."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, _rope
    from grove_tpu_torch.ops import kvquant
    from grove_tpu_torch.ops.rope import apply_rope, rope_table
    cfg = CONFIGS["llama-1b"]
    h, n_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rope_len = 1000
    short = rope_table(rope_len, d, cfg.rope_theta, device="cuda")

    def pools(nb, dtype, int8):
        if int8:
            return [torch.randint(-127, 128, (nb, PAGED_BS, n_kv, d),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8) for _ in range(2)] + [
                torch.rand((nb, PAGED_BS, n_kv), generator=gen,
                           device="cuda") for _ in range(2)]
        return [torch.randn((nb, PAGED_BS, n_kv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2)]

    def call(int8, ps, *args):
        if int8:
            return kvquant.paged_rope_scatter_q(*ps, *args)
        return kvquant.paged_rope_scatter(*ps, *args)

    def plain(int8, ps, *args):
        scales = ps[2:] if int8 else [None, None]
        return kvquant.paged_rope_scatter_ref(ps[0], ps[1], *scales, *args)

    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for label, q, k, v, t, p, ok in rope_scatter_cases(gen, dtype,
                                                           rope_len):
            nb = int(t.max().item()) + 1
            for int8 in (False, True):
                ref = pools(nb, dtype, int8)
                mine = [x.clone() for x in ref]
                wrapper = (kvquant.paged_rope_scatter_q if int8
                           else kvquant.paged_rope_scatter)
                before = wrapper.launches
                got = call(int8, mine, q, k, v, *short, t, p, ok)
                torch.cuda.synchronize()
                if wrapper.launches != before + 1:
                    raise AssertionError("the fused write did not count its "
                                         "launch")
                want = plain(int8, ref, q, k, v, *short, t, p, ok)
                same = [torch.equal(got, want)] + [
                    torch.equal(a, b) for a, b in zip(mine, ref)]
                names = ["q", "K pool", "V pool"] + (
                    ["K scales", "V scales"] if int8 else [])
                log(f"kernels: {wrapper.__name__} {dt} {label} (rows past "
                    f"the width, invalid rows, positions past a rope table "
                    f"of {rope_len}): "
                    + ", ".join(f"{n} {s}" for n, s in zip(names, same))
                    + " bitwise equal to the plain version")
                if not all(same):
                    raise AssertionError(f"the fused write disagrees ({dt}, "
                                         f"{label}, int8 pool {int8})")
    # The serving shapes, bf16 rows, the model's rope table.
    cos, sin = _rope(cfg.max_seq_len, d, cfg.rope_theta, torch.device("cuda"))
    B, W, lo, hi = SERVE_DECODE
    lengths = np.random.default_rng(20).integers(lo, hi, size=B)
    _, _, tables = paged_pools(gen, lengths + 1, W, 1, 8, torch.float32)
    pos = torch.from_numpy(lengths.astype(np.int32)).cuda()[:, None]
    c, off = PAGED_CHUNK, SERVE_CHUNK_OFFSET
    _, _, ctables = paged_pools(gen, [off + c], W, 1, 8, torch.float32)
    steps = torch.arange(c, dtype=torch.int32, device="cuda")
    cpos = (off + steps)[None]
    cvalid = (steps < c)[None]  # as prefill_chunk_paged passes it
    rows_out = []
    for int8 in (False, True):
        name = "paged_rope_scatter_q" if int8 else "paged_rope_scatter"
        scatter = kvquant.paged_scatter_q if int8 else kvquant.paged_scatter
        info = kvquant.kernel_info(torch.bfloat16, int8)
        row = None
        for shape, b, s, t, p, ok in (("decode", B, 1, tables, pos, None),
                                      ("chunk", 1, c, ctables, cpos, cvalid)):
            q = torch.randn((b, s, h, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((b, s, n_kv, d), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            ps = pools(int(t.max().item()) + 1, torch.bfloat16, int8)

            def unfused():
                qr = apply_rope(q, cos, sin, p)
                scatter(*ps, apply_rope(k, cos, sin, p), v, t, p, ok)
                return qr

            label = (f"{name} {shape} shape b={b} s={s} h={h} n_kv={n_kv} "
                     f"d={d} bf16 rows, {'int8' if int8 else 'bf16'} pool")
            tm = time_paged(
                label, lambda: call(int8, ps, q, k, v, cos, sin, t, p, ok),
                lambda: plain(int8, ps, q, k, v, cos, sin, t, p, ok),
                unfused, rope_scatter_bound_ms(b * s, h, n_kv, d, 2, int8,
                                               ok is not None), card,
                yard_name="the unfused sequence: apply_rope on q and k, "
                          "then the write kernel with rope off")
            if row is None:  # the decode shape
                # What the fusion removed, kernel by kernel: the unfused
                # sequence (the paged path before the fusion) per layer.
                profile_window(
                    f"{name}: the unfused sequence, 10 layers at the decode "
                    f"shape (apply_rope on q and k, then the write alone)",
                    lambda: [unfused() for _ in range(10)],
                    10 * tm["yardstick_ms"], card, ("rope_scatter_kernel",),
                    top=12)
                row = {"name": name, "route": "cuda",
                       "source": "grove_tpu_torch/csrc/kv_quant.cu",
                       "replaces": "grove_tpu/models/llama.py:525"
                       if int8 else "grove_tpu/models/llama.py:482",
                       "launches": 0, "max_abs_err": 0.0, "ms": tm["ms"],
                       "plain_ms": tm["plain_ms"],
                       "bound_ms": tm["bound_ms"],
                       "bound_by": tm["bound_by"], "library_ms": None,
                       "yardstick_ms": tm["yardstick_ms"],
                       "per": f"one layer's rope + K/V write at the decode "
                              f"shape B={B}"}
        log(f"kernels: {name} build: {info['registers']} registers, "
            f"{info['local_bytes']} bytes spill, no shared memory")
        rows_out.append(row)
    return rows_out


RMS_SHAPES = [                            # rows, d, x type, weight type
    (32, 2048, "bfloat16", "bfloat16"),   # a decode step of llama-1b
    (128, 2048, "bfloat16", "bfloat16"),  # its verify chunk at k = 3
    (4096, 2048, "bfloat16", "bfloat16"),  # a lanes prefill, 32 x 128
    (8, 512, "bfloat16", "bfloat16"),     # the tiny draft's width
    (7, 64, "float32", "float32"),        # test-tiny
    (5, 100, "float32", "bfloat16"),      # ragged d, mixed types
    (3, 2048, "bfloat16", "float32"),
]


def check_rms_norm(gen, card: str) -> dict:
    """The rms_norm kernel: its builds' registers and spills, against its
    plain version (f32 1e-5; bf16 one output ulp, 2^-7 relative, after
    another sum order),
    rows bitwise independent of the number of rows (M = 1..256 and 4,096
    against the same rows in one call), then timed at the decode shape
    beside its bound, its plain version and torch's fused
    ``F.rms_norm``. Returns its kernel-table row."""
    import torch
    import torch.nn.functional as F
    from grove_tpu_torch.ops import norms
    for xt in ("float32", "bfloat16"):
        for wt in ("float32", "bfloat16"):
            info = norms.kernel_info(getattr(torch, xt), getattr(torch, wt))
            log(f"kernels: build rms_norm x {xt} weight {wt}: "
                f"{info['registers']} registers, {info['local_bytes']} "
                f"bytes spill, no shared memory beyond 36 bytes")
    err = 0.0
    for rows, d, xt, wt in RMS_SHAPES:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            getattr(torch, xt)) * 3
        w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(
            getattr(torch, wt))
        out, ref = norms.rms_norm(x, w), norms.rms_norm_ref(x, w)
        e = (out.float() - ref.float()).abs().max().item()
        tol = 1e-5 if xt == "float32" else 2 ** -7  # bf16: one ulp
        ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
        log(f"kernels: rms_norm rows={rows} d={d} x {xt} weight {wt} "
            f"max_abs_err={e:.3e} rtol=atol={tol} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("rms_norm kernel disagrees with its plain "
                                 "version")
        err = max(err, e)
    x = torch.randn((4096, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=gen, device="cuda")).to(
        torch.bfloat16)
    whole = norms.rms_norm(x, w)
    base = norms.rms_norm(x[:256], w)
    same = all(torch.equal(norms.rms_norm(x[:m], w), base[:m])
               for m in (1, 2, 3, 4, 8, 12, 16, 31, 32, 64, 128, 256))
    same = same and torch.equal(whole[:256], base)
    # What the kernel replaced: torch's mean splits a row's sum by the
    # number of rows, so the composition's rows may differ across M.
    ref_base = norms.rms_norm_ref(x[:256], w)
    ref_same = sum(torch.equal(norms.rms_norm_ref(x[:m], w), ref_base[:m])
                   for m in (1, 2, 3, 4, 8, 12, 16, 31, 32, 64, 128))
    log(f"kernels: rms_norm rows of M = 1..256 and 4096 against the same "
        f"rows in one call: {'bitwise equal' if same else 'DIFFER'} (the "
        f"plain composition: {ref_same} of 11 row counts bitwise equal to "
        f"M = 256)")
    if not same:
        raise AssertionError("rms_norm rows depend on the number of rows")
    x, w = x[:32].contiguous(), w
    rows, d = x.shape
    bound = (2 * rows * d * 2 + d * 2) / HBM_BYTES_PER_S * 1e3
    t = {"ms": time_ms(lambda: norms.rms_norm(x, w)),
         "plain_ms": time_ms(lambda: norms.rms_norm_ref(x, w)),
         "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-5))}
    for name, value in t.items():
        log(f"kernels: rms_norm decode shape rows={rows} d={d} bf16 "
            f"{name}={value} on {card}")
    log(f"kernels: rms_norm decode shape bound_ms={bound} (bytes; "
        f"{100 * bound / t['ms']:.1f}% of it), {t['library_ms'] / t['ms']:.2f}x "
        f"the speed of F.rms_norm, {t['plain_ms'] / t['ms']:.2f}x the plain "
        f"composition's on {card}")
    for rows_b in (128, 4096):
        xb = torch.randn((rows_b, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        log(f"kernels: rms_norm rows={rows_b} d={d} bf16 ms="
            f"{time_ms(lambda: norms.rms_norm(xb, w))} (plain "
            f"{time_ms(lambda: norms.rms_norm_ref(xb, w))}, F.rms_norm "
            f"{time_ms(lambda: F.rms_norm(xb, (d,), w, 1e-5))}) on {card}")
    return {"name": "rms_norm", "route": "cuda",
            "source": "grove_tpu_torch/csrc/rms_norm.cu",
            "replaces": "grove_tpu/ops/norms.py:10", "launches": 0,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "per": f"one call at the decode shape, {rows} rows of {d}"}


ADD_NORM_ROWS = (32, 128, 4096)           # decode, the k = 3 verify, lanes prefill


def add_norm_bound_ms(rows: int, d: int, elt: int) -> float:
    """Least time for one add_rms_norm call: x and delta read once, s and
    out written once, the weight row read once, at the memory rate."""
    return (4 * rows * d * elt + d * elt) / HBM_BYTES_PER_S * 1e3


def check_add_rms_norm(gen, card: str) -> dict:
    """The residual add fused into rms_norm: its builds' registers and
    spills; against its plain version (s bitwise; out f32 1e-5, bf16 one
    output ulp, 2^-7 relative, after another sum order) and bitwise against
    the kernel's own rms_norm of s; rows bitwise independent of the row
    count (1..256 and 4,096); timed at 32, 128 and 4,096 rows of 2,048
    beside its bound, its plain version and ``x + delta`` then
    ``F.rms_norm`` (a yardstick: no one PyTorch call computes both).
    Returns its kernel-table row (the decode shape)."""
    import torch
    import torch.nn.functional as F
    from grove_tpu_torch.ops import norms
    for xt in ("float32", "bfloat16"):
        info = norms.kernel_info(getattr(torch, xt), getattr(torch, xt),
                                 add=True)
        log(f"kernels: build add_rms_norm x {xt} weight {xt}: "
            f"{info['registers']} registers, {info['local_bytes']} bytes "
            f"spill, no shared memory")
    err = 0.0
    for rows, d, xt, wt in RMS_SHAPES + [(4096, 2048, "bfloat16",
                                          "bfloat16")]:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            getattr(torch, xt)) * 3
        delta = torch.randn((rows, d), generator=gen, device="cuda").to(
            getattr(torch, xt))
        w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(
            getattr(torch, wt))
        s, out = norms.add_rms_norm(x, delta, w)
        ref_s, ref = norms.add_rms_norm_ref(x, delta, w)
        e = (out.float() - ref.float()).abs().max().item()
        tol = 1e-5 if xt == "float32" else 2 ** -7  # bf16: one ulp
        ok = (torch.equal(s, ref_s) and torch.equal(out, norms.rms_norm(s, w))
              and torch.allclose(out.float(), ref.float(), rtol=tol,
                                 atol=tol))
        log(f"kernels: add_rms_norm rows={rows} d={d} x {xt} weight {wt} "
            f"max_abs_err={e:.3e} rtol=atol={tol}, s bitwise, out bitwise "
            f"rms_norm(s): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("add_rms_norm kernel disagrees with its "
                                 "plain version")
        err = max(err, e)
    d = 2048
    x = torch.randn((4096, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    delta = torch.randn((4096, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(
        torch.bfloat16)
    s_all, whole = norms.add_rms_norm(x, delta, w)
    same = all(torch.equal(norms.add_rms_norm(x[:m], delta[:m], w)[1],
                           whole[:m])
               for m in (1, 2, 3, 4, 8, 12, 16, 31, 32, 64, 128, 255, 256))
    log(f"kernels: add_rms_norm rows of M = 1..256 against the same rows "
        f"of one 4,096-row call: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("add_rms_norm rows depend on the number of "
                             "rows")
    times = {}
    for rows in ADD_NORM_ROWS:
        xr, dr = x[:rows].contiguous(), delta[:rows].contiguous()
        t = {"ms": time_ms(lambda: norms.add_rms_norm(xr, dr, w)),
             "plain_ms": time_ms(lambda: norms.add_rms_norm_ref(xr, dr, w)),
             "yardstick_ms": time_ms(
                 lambda: F.rms_norm(xr + dr, (d,), w, 1e-5)),
             "bound_ms": add_norm_bound_ms(rows, d, 2)}
        times[rows] = t
        log(f"kernels: add_rms_norm rows={rows} d={d} bf16: "
            + ", ".join(f"{k}={v}" for k, v in t.items())
            + f" ({100 * t['bound_ms'] / t['ms']:.1f}% of its byte bound, "
            f"{t['yardstick_ms'] / t['ms']:.2f}x the speed of x + delta "
            f"then F.rms_norm, {t['plain_ms'] / t['ms']:.2f}x the plain "
            f"version's) on {card}")
    t = times[ADD_NORM_ROWS[0]]
    return {"name": "add_rms_norm", "route": "cuda",
            "source": "grove_tpu_torch/csrc/rms_norm.cu",
            "replaces": "grove_tpu/models/llama.py:175",
            "launches": 0, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "yardstick_ms": t["yardstick_ms"],
            "per": f"one call at the decode shape, {ADD_NORM_ROWS[0]} rows "
                   f"of {d}"}


def mixed_prompts(rng, cfg, n_requests: int, prompt_lo: int, prompt_hi: int,
                  shared: int) -> list:
    """The mixed serve's traffic: ``n_requests`` prompts of seeded lengths
    in [prompt_lo, prompt_hi], every other one opening with one shared
    ``shared``-token prefix (diverging mid-block)."""
    import numpy as np
    lens = rng.integers(prompt_lo, prompt_hi + 1, size=n_requests)
    prefix = rng.integers(0, cfg.vocab_size, size=shared)
    prompts = []
    for i, n in enumerate(lens):
        if i % 2 == 0:
            tail = rng.integers(0, cfg.vocab_size, size=max(int(n) - shared,
                                                             16))
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rng.integers(0, cfg.vocab_size,
                                        size=int(n)).astype(np.int32))
    return prompts


def paged_launches(cfg, q8: bool, weights: str, steps: int, chunks: int,
                   on_cuda: bool) -> dict[str, int]:
    """The hand-written kernels' launches over ``steps`` decode steps and
    ``chunks`` prefill chunks of the paged path: per forward, one attention
    launch and one fused rope + write per layer (the int8 builds over an
    int8 pool), none of the write alone, 4 GEMM launches per layer and one
    for the head (the W8A16 build for ``weights="int8"``, the dense build
    for ``"bf16"``), one rms_norm and 2 per layer of add_rms_norm. Nothing
    launches on the CPU."""
    n = cfg.n_layers if on_cuda else 0
    fwd = steps + chunks
    gemm = (GEMMS_PER_LAYER * n + 1) * fwd if on_cuda else 0
    return {"paged_decode_attention": 0 if q8 else n * steps,
            "paged_chunk_attention": 0 if q8 else n * chunks,
            "paged_decode_attention_q8": n * steps if q8 else 0,
            "paged_chunk_attention_q8": n * chunks if q8 else 0,
            "paged_rope_scatter_q": n * fwd if q8 else 0,
            "paged_rope_scatter": 0 if q8 else n * fwd,
            "paged_scatter_q": 0, "paged_scatter": 0,
            "w8a16_matmul": gemm if weights == "int8" else 0,
            "dense_matmul": gemm if weights == "bf16" else 0,
            "rms_norm": fwd if on_cuda else 0,
            "add_rms_norm": 2 * n * fwd}


def drive_paged(eng, want: int, max_iters: int = 100_000) -> None:
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        if eng._sched.live:
            eng.step()
    eng.sync()
    if len(eng.completed) < want:
        raise AssertionError(f"{len(eng.completed)} of {want} requests "
                             f"answered")


def phase_paged_parity(seed: int, device: str = "cuda") -> None:
    """test-tiny f32 through the paged engine with the kernels and graphs on
    (the workloads of tests/test_paged_engine.py's parity tests): paged
    against lanes, prefix cache on against off and a tight pool against a
    roomy one, over a model-dtype and an int8 pool; tokens must be equal.
    Then sampling: top_k = 1 equals greedy, one seed twice gives the same
    tokens, two seeds differ, and at a temperature that leaves the noise
    to choose, no request repeats one token (each graph replay draws fresh
    noise)."""
    import dataclasses
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops import kvquant, paged
    from grove_tpu_torch.serving.engine import (DecodeEngine,
                                                PagedDecodeEngine,
                                                SamplerConfig)
    cfg = dataclasses.replace(CONFIGS["test-tiny"], dtype=torch.float32,
                              max_seq_len=64)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    wrappers = (paged.paged_decode_attention, paged.paged_chunk_attention,
                paged.paged_decode_attention_q8,
                paged.paged_chunk_attention_q8, kvquant.paged_rope_scatter_q,
                kvquant.paged_rope_scatter)
    for w in wrappers:
        w.launches = 0
    captured = 0

    def paged_eng(**kw):
        return PagedDecodeEngine(cfg, params, device=device, **kw)

    def finish(eng):
        nonlocal captured
        eng._alloc.check()
        if eng._alloc.used_blocks:
            raise AssertionError("blocks leaked")
        captured += eng.graphs_captured
        return {r.rid: r.generated for r in eng.completed}

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 13, 4, 9)]
    lanes = DecodeEngine(cfg, params, batch=len(prompts), max_len=48,
                         device=device)
    toks = np.zeros((len(prompts), 13), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lanes.admit_prompts(torch.from_numpy(toks).to(device), max_new_tokens=8,
                        lengths=torch.tensor([len(p) for p in prompts],
                                             dtype=torch.int32,
                                             device=device))
    for _ in range(16):
        lanes.step()
    lanes.sync()
    eng = paged_eng(batch=4, max_len=48, block_size=8, prefill_chunk=8,
                    host_sync_interval=4)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    drive_paged(eng, len(prompts))
    got = finish(eng)
    want = {r.prompt_len: r.generated for r in lanes.completed}
    same = all(got[i] == want[len(p)] for i, p in enumerate(prompts))
    log(f"parity: test-tiny f32 paged vs lanes tokens "
        f"{'equal' if same else 'DIFFER'} over {len(prompts)} requests")
    if not same:
        raise AssertionError("paged and lanes tokens differ")

    for kv_quant in ("off", "int8"):
        pool = "int8 KV" if kv_quant == "int8" else "f32 KV"
        rng = np.random.default_rng(41)
        base = rng.integers(0, 256, size=19).astype(np.int32)
        later = [base.copy(),
                 np.concatenate([base[:12], rng.integers(
                     0, 256, size=7).astype(np.int32)]),
                 rng.integers(0, 256, size=7).astype(np.int32), base.copy()]
        runs = {}
        for on in (True, False):
            eng = paged_eng(batch=4, max_len=48, block_size=8, num_blocks=24,
                            prefill_chunk=8, host_sync_interval=4,
                            prefix_cache=on, kv_quant=kv_quant)
            eng.submit(base, max_new_tokens=6)
            drive_paged(eng, 1)
            for p in later:
                eng.submit(p, max_new_tokens=6)
            drive_paged(eng, 1 + len(later))
            runs[on] = (finish(eng), eng.cow_copies)
        same = runs[True][0] == runs[False][0]
        log(f"parity: test-tiny f32 model, {pool}: prefix cache on vs off "
            f"tokens {'equal' if same else 'DIFFER'} ({runs[True][1]} CoW "
            f"copies on)")
        if not same or runs[True][1] < 2:
            raise AssertionError(f"{pool}: prefix cache on/off tokens differ "
                                 f"or no CoW")

        rng = np.random.default_rng(9)
        tight = [rng.integers(0, 256, size=6).astype(np.int32)
                 for _ in range(4)]
        runs = {}
        for nb in (48, 13):
            eng = paged_eng(batch=4, max_len=40, block_size=4, num_blocks=nb,
                            prefill_chunk=4, host_sync_interval=2,
                            kv_quant=kv_quant)
            for p in tight:
                eng.submit(p, max_new_tokens=12)
            drive_paged(eng, len(tight))
            runs[nb] = (finish(eng), eng._sched.preemptions_total)
        same = runs[13][0] == runs[48][0]
        log(f"parity: test-tiny f32 model, {pool}: tight pool ({runs[13][1]} "
            f"preemptions) vs roomy pool tokens "
            f"{'equal' if same else 'DIFFER'}")
        if not same or runs[13][1] == 0:
            raise AssertionError(f"{pool}: tight/roomy tokens differ or no "
                                 f"preemption")

    def sampled(sampler=None, kv_quant="off", new=12):
        eng = paged_eng(batch=4, max_len=48, block_size=8, prefill_chunk=8,
                        host_sync_interval=4, sampler=sampler,
                        kv_quant=kv_quant)
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        drive_paged(eng, len(prompts))
        return finish(eng)

    for kv_quant in ("off", "int8"):
        greedy = sampled(kv_quant=kv_quant)
        top1 = sampled(SamplerConfig(temperature=1.5, top_k=1, seed=7),
                       kv_quant)
        one = sampled(SamplerConfig(temperature=1.5, top_k=8, seed=7),
                      kv_quant)
        again = sampled(SamplerConfig(temperature=1.5, top_k=8, seed=7),
                        kv_quant)
        other = sampled(SamplerConfig(temperature=1.5, top_k=8, seed=8),
                        kv_quant)
        checks = {"top_k=1 equals greedy": top1 == greedy,
                  "seed 7 twice equal": one == again,
                  "seeds 7 and 8 differ": one != other}
        log(f"parity: sampled, {kv_quant} KV: " + ", ".join(
            f"{k}: {v}" for k, v in checks.items()))
        if not all(checks.values()):
            raise AssertionError(f"sampling checks failed ({kv_quant} KV)")
    # Nearly flat logits: the noise picks the token. A replay that reused
    # its noise would repeat one token per slot.
    flat = sampled(SamplerConfig(temperature=1e3, top_k=0, seed=11), new=16)
    distinct = min(len(set(t)) for t in flat.values())
    log(f"parity: sampled at temperature 1e3: at least {distinct} distinct "
        f"tokens in every request's 16")
    if distinct < 8:
        raise AssertionError("graph replays repeat their noise")
    counts = {w.__name__: w.launches for w in wrappers}
    log(f"parity: {captured} graphs captured; launches {counts}")
    if device == "cuda" and not (captured and all(counts.values())):
        raise AssertionError("the parity runs bypassed the graphs or kernels")


def phase_paged_serve(seed: int, card: str, cfg=None, device: str = "cuda",
                      n_requests: int = 64, batch: int = 32,
                      max_len: int = 2048, new_tokens: int = 64,
                      prompt_lo: int = 64, prompt_hi: int = 1024,
                      shared: int = 264, bench_len: int = 512,
                      bench_steps: int = 64,
                      window: tuple[int, int] = (200, 32)) -> dict[str, int]:
    """Serve through the default ``make_engine`` (the paged engine) with
    int8 weights: ``n_requests`` requests with seeded prompt lengths in
    [prompt_lo, prompt_hi], every other one opening with one shared
    ``shared``-token prefix (diverging mid-block, so copy-on-write fires),
    ``new_tokens`` each, after a warmup that captures every decode and
    prefill-chunk graph the traffic uses; ticks [window[0], window[0] +
    window[1]) are timed alone. Then a decode window over a full batch,
    with a profiler pass. Then the same traffic on a pool of a quarter of
    the default size, whose same window of mixed ticks (the same work: the
    pool never fills there) runs under the profiler, then a full batch
    decoding past that pool's capacity, which must preempt. Then the same
    traffic and full-batch decode over int8 KV. Returns the hand-written
    kernels' launch counts: the model-dtype kernels' from the first traffic
    run, the int8 kernels' from the int8 one (zeroed at each start), and
    ``step_device_ms``, the default pool's profiled device ms per decode
    step (None off the card)."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops import kvquant, norms, paged, w8a16
    from grove_tpu_torch.serving.engine import PagedDecodeEngine, make_engine

    cfg = cfg or CONFIGS["llama-1b"]
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wrappers = (paged.paged_decode_attention, paged.paged_chunk_attention,
                paged.paged_decode_attention_q8,
                paged.paged_chunk_attention_q8, kvquant.paged_rope_scatter_q,
                kvquant.paged_rope_scatter, kvquant.paged_scatter_q,
                kvquant.paged_scatter, w8a16.w8a16_matmul,
                w8a16.dense_matmul, norms.rms_norm, norms.add_rms_norm)
    kernels = ("paged_partial", "paged_combine", "rope_scatter_kernel",
               "w8a16", "rms_norm_kernel")
    rng = np.random.default_rng(seed + 11)
    prompts = mixed_prompts(rng, cfg, n_requests, prompt_lo, prompt_hi,
                            shared)
    longest = max(len(p) for p in prompts) + new_tokens
    bench = rng.integers(0, cfg.vocab_size,
                         (batch, bench_len)).astype(np.int32)

    def warm(eng, label, setup_s):
        widths = eng.decode_width_buckets(prompt_lo, longest)
        chunk_widths = eng.decode_width_buckets(1, longest)
        t0 = time.perf_counter()
        built = eng.warmup(widths=widths, prefill_widths=chunk_widths)
        log(f"paged: {label}: {type(eng).__name__}, {cfg.n_layers} layers, "
            f"int8 weights, {eng.kv_quant} KV, batch {batch}, max_len "
            f"{max_len}, block {eng.block_size}, chunk {eng.prefill_chunk}, "
            f"{eng.kv.num_blocks} blocks ({eng.kv.pool_bytes / 2**30:.3f} "
            f"GiB pool, {eng.kv.pool_bytes} bytes), prefix cache "
            f"{'on' if eng._prefix else 'off'}; set-up {setup_s:.2f} s")
        log(f"paged: {label}: warmup built {built} graphs (decode: batches "
            f"{eng._sched.batch_buckets} x widths {widths}; prefill chunks: "
            f"widths {chunk_widths}) in {time.perf_counter() - t0:.2f} s; "
            f"captures {eng.graphs_captured} in {eng.capture_seconds:.2f} s, "
            f"{eng.capture_bytes / 2**20:.1f} MiB of graph memory on {card}")

    def serve(eng, label, window_ms=None):
        """The traffic; returns (launch counts, the window's unprofiled
        wall in ms). With ``window_ms`` the window runs under the profiler
        against that wall."""
        for w in wrappers:
            w.launches = 0
        steps0, chunks0 = eng.steps, eng.chunks
        captured0 = eng.graphs_captured
        start, width = window
        ticks, win = 0, None

        def run_window():
            for _ in range(width):
                eng.admit_from_queue()
                eng.step()

        t = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        for _ in range(100_000):
            eng.admit_from_queue()
            if len(eng.completed) >= n_requests:
                break
            if not eng._sched.live:
                continue
            if ticks == start and on_cuda:
                if window_ms is None:
                    sync()
                    t_w = time.perf_counter()
                    run_window()
                    sync()
                    win = (time.perf_counter() - t_w) * 1e3
                    log(f"paged: {label}: ticks {start}..{start + width - 1} "
                        f"(one prefill chunk and one decode step each): "
                        f"{win:.3f} ms, {win / width:.3f} ms per tick on "
                        f"{card}")
                else:
                    t_w = time.perf_counter()
                    profile_window(f"mixed ticks {start}..{start + width - 1}"
                                   f" ({label})", run_window, window_ms,
                                   card, kernels)
                    log(f"paged: {label}: the profiled window and the "
                        f"profiler's processing took "
                        f"{time.perf_counter() - t_w:.3f} s of this serve's "
                        f"wall")
                ticks += width
                continue
            eng.step()
            ticks += 1
        eng.sync()
        wall = time.perf_counter() - t
        counts = {w.__name__: w.launches for w in wrappers}
        done = {r.rid: r for r in eng.completed}
        if sorted(done) != rids:
            raise AssertionError(f"{label}: {len(done)} of {n_requests} "
                                 f"requests answered")
        bad = [r.rid for r in done.values()
               if len(r.generated) != new_tokens
               or not all(0 <= x < cfg.vocab_size for x in r.generated)]
        if bad:
            raise AssertionError(f"{label}: requests {bad} have the wrong "
                                 f"tokens")
        steps, chunks = eng.steps - steps0, eng.chunks - chunks0
        ttft = np.array([r.first_token_ts - r.enqueue_ts
                         for r in done.values()]) * 1e3
        n_tok = sum(len(r.generated) for r in done.values())
        log(f"paged: {label}: {len(done)} requests, {n_tok} tokens "
            f"generated in {wall:.3f} s ({n_tok / wall:.1f} tokens/s "
            f"overall) over {ticks} ticks, {steps} decode steps and "
            f"{chunks} prefill chunks ({1e3 * wall / max(ticks, 1):.3f} ms "
            f"per tick) on {card}")
        log(f"paged: {label}: TTFT p50 {np.percentile(ttft, 50):.1f} ms, "
            f"p90 {np.percentile(ttft, 90):.1f} ms; prefix hits "
            f"{eng._prefix.hits if eng._prefix else 0}, tokens matched "
            f"{eng._sched.prefix_tokens_skipped_total}, cow_copies "
            f"{eng.cow_copies}, preemptions "
            f"{eng._sched.preemptions_total}; allocator high water "
            f"{eng._alloc.high_water} of {eng._alloc.capacity} blocks")
        want = paged_launches(cfg, eng.kv.quantized, "int8", steps, chunks,
                              on_cuda)
        log(f"paged: {label}: launches {counts} ({cfg.n_layers} per decode "
            f"step and per chunk for each attention kernel and the fused "
            f"rope + write, none of the write alone, "
            f"{GEMMS_PER_LAYER * cfg.n_layers + 1} GEMM launches, one "
            f"rms_norm and {2 * cfg.n_layers} of add_rms_norm: {want}); "
            f"graphs captured during "
            f"traffic: {eng.graphs_captured - captured0}")
        if counts != want:
            raise AssertionError(f"{label}: kernel launches off the path")
        if eng.graphs_captured != captured0:
            raise AssertionError(f"{label}: graphs captured mid-traffic")
        return counts, win

    def decode_bench(eng, label):
        """A full batch decoding: tokens/s, then a profiled window; returns
        the window's kernels and device ms (per 8 decode steps)."""
        eng.admit_prompts(bench, max_new_tokens=4 * bench_steps)
        sync()
        t = time.perf_counter()
        eng.run(bench_steps)
        sync()
        decode_s = time.perf_counter() - t
        log(f"paged: {label}: decode {batch * bench_steps / decode_s:.1f} "
            f"tokens/s (batch {batch}, prompts of {bench_len}, "
            f"run({bench_steps}) in {decode_s * 1e3:.1f} ms, "
            f"{decode_s * 1e3 / bench_steps:.3f} ms per step) on {card}")
        if on_cuda:
            # The trace must hold every step's kernels: one run on the card
            # came back with 77 of 128 attention launches and a third of
            # the device time. Such a trace is logged and taken again (the
            # numbers below are a measurement, not a check of the path).
            want = 8 * cfg.n_layers
            for attempt in range(3):
                ms = profile_window(f"paged decode ({label})",
                                    lambda: eng.run(8),
                                    decode_s * 1e3 / bench_steps * 8, card,
                                    kernels)
                got = ms["launches"]["paged_partial"]
                if got == want:
                    break
                log(f"paged: {label}: INCOMPLETE trace: the profiler traced "
                    f"{got} of {want} attention launches (attempt "
                    f"{attempt + 1} of 3)")
            log(f"paged: {label}: paged attention kernel (pass 1, "
                f"{'int8' if eng.kv_quant == 'int8' else 'model-dtype'} KV) "
                f"{ms['paged_partial']:.3f} ms and its "
                f"combine {ms['paged_combine']:.3f} ms, the fused rope + "
                f"write {ms['rope_scatter_kernel']:.3f} ms, rms_norm and "
                f"add_rms_norm {ms['rms_norm_kernel']:.3f} ms, the GEMM "
                f"{ms['w8a16']:.3f} ms of device time "
                f"per 8 decode steps; kernels per 8 decode steps "
                f"{ms['count']} ({ms['count'] / (8 * cfg.n_layers):.1f} per "
                f"layer and step), device busy {ms['busy_ms']:.3f} ms on "
                f"{card}")
            return ms
        return None

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=device)
    eng = make_engine(cfg, params, batch=batch, max_len=max_len,
                      quant="int8", device=device)
    del params
    if not isinstance(eng, PagedDecodeEngine):
        raise AssertionError(f"make_engine built {type(eng).__name__}")
    warm(eng, "default pool", time.perf_counter() - t0)
    counts, window_ms = serve(eng, "default pool")
    if not (eng._prefix and eng._prefix.hits and eng.cow_copies):
        raise AssertionError("the shared prefix did not hit or copy on "
                             "write")
    profiled = decode_bench(eng, "default pool")
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    log(f"paged: peak torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.3f} GiB on {card}")
    params = eng.params
    num_blocks = eng.kv.num_blocks // 4
    bf16_pool = eng.kv.pool_bytes
    del eng

    t0 = time.perf_counter()
    small = make_engine(cfg, params, batch=batch, max_len=max_len,
                        num_blocks=num_blocks, device=device)
    warm(small, "quarter pool", time.perf_counter() - t0)
    captured = small.graphs_captured
    serve(small, f"quarter pool ({num_blocks} blocks)", window_ms=window_ms)
    # The traffic above prefills one chunk per tick, so few sequences
    # decode at once and it may fit the quarter pool; a full batch
    # decoding past the pool's capacity must preempt (by recompute) and
    # still finish every request.
    fill = (small._alloc.capacity * small.block_size) // batch
    posture_len, posture_new = fill * 3 // 4, fill // 2
    n0 = len(small.completed)
    t = time.perf_counter()
    small.admit_prompts(rng.integers(0, cfg.vocab_size,
                                     (batch, posture_len)).astype(np.int32),
                        max_new_tokens=posture_new)
    drive_paged(small, n0 + batch)
    wall = time.perf_counter() - t
    done = small.completed[n0:]
    log(f"paged: quarter pool, full batch of {batch} x {posture_len} "
        f"prompt tokens decoding {posture_new} each: "
        f"{small._sched.preemptions_total} preemptions, {len(done)} "
        f"requests done in {wall:.3f} s, allocator high water "
        f"{small._alloc.high_water} of {small._alloc.capacity} blocks on "
        f"{card}")
    if small._sched.preemptions_total == 0:
        raise AssertionError("the quarter pool did not preempt")
    if len(done) != batch or any(len(r.generated) != posture_new
                                 for r in done):
        raise AssertionError("the quarter pool lost tokens under "
                             "preemption")
    if small.graphs_captured != captured:
        raise AssertionError("the quarter pool captured graphs after "
                             "warmup")
    del small

    t0 = time.perf_counter()
    q8 = make_engine(cfg, params, batch=batch, max_len=max_len,
                     kv_quant="int8", device=device)
    warm(q8, "int8 KV", time.perf_counter() - t0)
    log(f"paged: int8 KV pool {q8.kv.pool_bytes} bytes against "
        f"{bf16_pool} for the model-dtype pool of as many blocks "
        f"({q8.kv.pool_bytes / bf16_pool:.4f}; d + 4 bytes per row and "
        f"head against d of the model's dtype is "
        f"{(cfg.head_dim + 4) / (cfg.dtype.itemsize * cfg.head_dim):.4f})")
    q8_counts, _ = serve(q8, "int8 KV")
    if not (q8._prefix and q8._prefix.hits and q8.cow_copies):
        raise AssertionError("int8 KV: the shared prefix did not hit or "
                             "copy on write")
    decode_bench(q8, "int8 KV")
    del q8, params
    if on_cuda:
        torch.cuda.empty_cache()

    # The engine's default weights (no quantization): every projection
    # through the GEMM's bf16-weight build. A full batch decoding; its
    # launches are read from this run alone.
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = make_engine(cfg, init_params(cfg, gen, device=device),
                        batch=batch, max_len=max_len, device=device)
    widths = dense.decode_width_buckets(bench_len, bench_len + 5 * bench_steps)
    chunk_widths = dense.decode_width_buckets(1, bench_len)
    built = dense.warmup(widths=widths, prefill_widths=chunk_widths)
    log(f"paged: bf16 weights: default make_engine (quant None), "
        f"{dense.kv_quant} KV; warmup built {built} graphs in "
        f"{time.perf_counter() - t0:.2f} s with set-up")
    for w in wrappers:
        w.launches = 0
    steps0, chunks0, cap0 = dense.steps, dense.chunks, dense.graphs_captured
    decode_bench(dense, "bf16 weights")
    sync()
    dense_counts = {w.__name__: w.launches for w in wrappers}
    forwards = (dense.steps - steps0) + (dense.chunks - chunks0)
    want_dense = (GEMMS_PER_LAYER * cfg.n_layers + 1) * forwards \
        if on_cuda else 0
    log(f"paged: bf16 weights: launches {dense_counts} over {forwards} "
        f"forwards ({dense.steps - steps0} decode steps, "
        f"{dense.chunks - chunks0} prefill chunks; dense_matmul expected "
        f"{want_dense}, w8a16_matmul 0); graphs captured after warmup "
        f"{dense.graphs_captured - cap0}")
    if dense_counts["dense_matmul"] != want_dense or \
            dense_counts["w8a16_matmul"]:
        raise AssertionError("bf16 weights: projections off the dense GEMM")
    del dense
    return {**{k: v for k, v in counts.items() if not k.endswith("_q")
               and not k.endswith("_q8")},
            **{k: v for k, v in q8_counts.items() if k.endswith("_q")
               or k.endswith("_q8")},  # the int8 GEMM's: the first serve's
            "dense_matmul": dense_counts["dense_matmul"],
            # the default pool's profiled decode, per step (phase 12)
            "step_device_ms": profiled["busy_ms"] / 8 if profiled else None}


def phase_paged_model(seed: int, card: str, cfg=None, device: str = "cuda",
                      batch: int = 8, width: int = 64) -> None:
    """llama-1b bf16 ``decode_step_paged`` and ``prefill_chunk_paged``
    logits with int8 weights through the kernels (paged attention, the
    fused rope + write, W8A16) vs their plain versions, on the same pools
    (random K/V) and tables; then, on the card, ``batch_rows`` at a batch
    of 32."""
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops import kvquant, norms, paged, w8a16
    from grove_tpu_torch.serving.quant import quantize_params

    cfg = cfg or CONFIGS["llama-1b"]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    params = quantize_params(init_params(cfg, gen, device=device))
    rng = np.random.default_rng(seed + 2)
    lengths = rng.integers(100, width * PAGED_BS, size=batch).astype(np.int32)
    lengths[0] = SERVE_CHUNK_OFFSET
    nb = 1 + batch * width
    tables = torch.from_numpy((1 + np.arange(batch * width, dtype=np.int32)
                               ).reshape(batch, width)).to(device)
    shape = (cfg.n_layers, nb, PAGED_BS, cfg.n_kv_heads, cfg.head_dim)
    k0 = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    v0 = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 1 + 32))
                              .astype(np.int32)).to(device)
    lens = torch.from_numpy(lengths).to(device)

    def plain_write(kc, vc, q, k, v, cos, sin, t, pos, valid=None):
        return kvquant.paged_rope_scatter_ref(kc, vc, None, None, q, k, v,
                                              cos, sin, t, pos, valid)

    plain_fns = {"paged_decode_attention": paged.paged_decode_attention_ref,
                 "paged_chunk_attention": paged.paged_chunk_attention_ref,
                 "paged_rope_scatter": plain_write,
                 "w8a16_matmul_group": plain_gemm,
                 "rms_norm": norms.rms_norm_ref,
                 "add_rms_norm": norms.add_rms_norm_ref}

    def run(plain: bool):
        saved = {name: getattr(llama, name) for name in plain_fns}
        if plain:
            for name, fn in plain_fns.items():
                setattr(llama, name, fn)
        try:
            k, v = k0.clone(), v0.clone()
            dec = llama.decode_step_paged(cfg, params, tokens[:, 0], k, v,
                                          tables, lens)
            k, v = k0.clone(), v0.clone()
            chunk = llama.prefill_chunk_paged(
                cfg, params, tokens[:1, 1:], k, v, tables[:1],
                SERVE_CHUNK_OFFSET, 31, 32)
            return dec.float(), chunk.float()
        finally:
            for name, fn in saved.items():
                setattr(llama, name, fn)

    kernel, plain = run(False), run(True)
    for name, kl, pl, need in (("decode_step_paged", kernel[0], plain[0],
                                batch - 1),
                               ("prefill_chunk_paged", kernel[1], plain[1],
                                1)):
        if not (torch.isfinite(kl).all() and torch.isfinite(pl).all()):
            raise AssertionError(f"{name}: non-finite logits")
        diff = (kl - pl).abs().max().item()
        bound = 5e-2 * pl.abs().max().item()
        agree = int((kl.argmax(-1) == pl.argmax(-1)).sum().item())
        log(f"model: {cfg.n_layers}-layer bf16 {name} logits (int8 weights), "
            f"kernels vs plain: max abs diff {diff:.4e} (bound {bound:.4e}), "
            f"argmax agrees on {agree}/{kl.shape[0]} rows (need >= {need})")
        if diff > bound or agree < need:
            raise AssertionError(f"{name}: kernels and plain disagree")
    del k0, v0
    if device == "cuda":
        batch_rows(cfg, params, seed, width=width)


def batch_rows(cfg, params, seed: int, batch: int = 32, rows: int = 8,
               width: int = 64, device: str = "cuda") -> None:
    """``decode_step_paged`` over the first ``rows`` of ``batch`` sequences
    alone and inside the whole batch: are their logits bitwise equal, and
    if not, which op (in call order) first gives those rows other bits. A
    finding for speculative decoding (its verify must equal sequential
    decode bitwise), reported and not asserted."""
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama
    traced = ("embed", "rms_norm", "add_rms_norm", "w8a16_matmul_group",
              "paged_rope_scatter", "paged_decode_attention")
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 3)
    lens = torch.from_numpy(rng.integers(100, width * PAGED_BS, size=batch)
                            .astype(np.int32)).to(device)
    tables = torch.from_numpy((1 + np.arange(batch * width, dtype=np.int32)
                               ).reshape(batch, width)).to(device)
    shape = (cfg.n_layers, 1 + batch * width, PAGED_BS, cfg.n_kv_heads,
             cfg.head_dim)
    k0 = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    v0 = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, batch)
                              .astype(np.int32)).to(device)

    def run(n: int):
        calls = []
        saved = {name: getattr(llama, name) for name in traced}

        def record(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                for t in out if isinstance(out, (list, tuple)) else [out]:
                    calls.append((name, t))
                return out
            return call

        for name in traced:
            setattr(llama, name, record(name, saved[name]))
        try:
            k, v = k0.clone(), v0.clone()
            logits = llama.decode_step_paged(cfg, params, tokens[:n], k, v,
                                             tables[:n], lens[:n])
        finally:
            for name, fn in saved.items():
                setattr(llama, name, fn)
        return logits, calls

    whole, whole_calls = run(tokens.shape[0])
    alone, alone_calls = run(rows)
    same = torch.equal(alone, whole[:rows])
    first = None
    seen: dict[str, int] = {}
    for (name, a), (_, w) in zip(alone_calls, whole_calls):
        seen[name] = seen.get(name, 0) + 1
        if first is None and not torch.equal(a, w[:rows]):
            first = (name, seen[name])
    log(f"model: decode_step_paged logits of {rows} sequences alone vs "
        f"inside a batch of {tokens.shape[0]}: "
        f"{'bitwise equal' if same else 'DIFFER'} (max abs diff "
        f"{(alone - whole[:rows]).abs().max().item():.4e}); "
        + ("every traced op's rows equal" if first is None else
           f"first op whose rows differ: {first[0]}, call {first[1]} of it "
           f"(traced in call order: {', '.join(traced)})"))


# ---- speculative decoding on the paged engine ----

SPEC_K = 3                                # draft tokens per dispatch
SPEC_WRAPPERS = ("paged_decode_attention", "paged_chunk_attention",
                 "paged_decode_attention_q8", "paged_chunk_attention_q8",
                 "paged_rope_scatter", "paged_rope_scatter_q",
                 "paged_scatter", "paged_scatter_q", "w8a16_matmul",
                 "dense_matmul", "rms_norm", "add_rms_norm")


def spec_launches(cfg, dcfg, draft, int8_pool: bool, k: int, steps: int,
                  chunks: int) -> dict[str, int]:
    """The hand-written kernels' launches of a serve of ``steps`` decode
    dispatches and ``chunks`` prefill chunks, int8 target weights. Every
    forward runs one rms_norm and 2 n_layers add_rms_norm. Plain
    (``draft`` None): per step and chunk one paged attention and one fused
    write per layer and 4 GEMM launches per layer plus the head. A
    self-draft dispatch: k decode steps and one verify chunk over the
    target's pool, (k + 1) x 65 GEMM launches. A tiny-draft dispatch: k
    draft steps and the chunk's replay (no head) over the draft's
    model-dtype pool, its dense weights through the dense GEMM build, and
    the target's verify chunk; each prefill chunk replays through the draft
    too."""
    L, G = cfg.n_layers, GEMMS_PER_LAYER * cfg.n_layers + 1
    q8, wq = ("_q8", "_q") if int8_pool else ("", "")
    want = dict.fromkeys(SPEC_WRAPPERS, 0)

    def add(name, n):
        want[name] += n

    def forwards(layers, n):
        add("rms_norm", n)
        add("add_rms_norm", 2 * layers * n)

    if draft is None:
        add("paged_decode_attention" + q8, L * steps)
        add("paged_chunk_attention" + q8, L * chunks)
        add("paged_rope_scatter" + wq, L * (steps + chunks))
        add("w8a16_matmul", G * (steps + chunks))
        forwards(L, steps + chunks)
    elif draft == "self":
        add("paged_decode_attention" + q8, k * L * steps)
        add("paged_chunk_attention" + q8, L * (steps + chunks))
        add("paged_rope_scatter" + wq, (k + 1) * L * steps + L * chunks)
        add("w8a16_matmul", (k + 1) * G * steps + G * chunks)
        forwards(L, (k + 1) * steps + chunks)
    else:
        D = dcfg.n_layers
        add("paged_chunk_attention" + q8, L * (steps + chunks))
        add("paged_rope_scatter" + wq, L * (steps + chunks))
        add("paged_decode_attention", k * D * steps)
        add("paged_chunk_attention", D * (steps + chunks))
        add("paged_rope_scatter", (k + 1) * D * steps + D * chunks)
        add("w8a16_matmul", G * (steps + chunks))
        add("dense_matmul", (GEMMS_PER_LAYER * D + 1) * k * steps
            + GEMMS_PER_LAYER * D * (steps + chunks))
        forwards(L, steps + chunks)
        forwards(D, k * steps + steps + chunks)
    return want


def spec_rows(cfg, params, seed: int, batch: int = 32, c: int = SPEC_K + 1,
              width: int = 64, device: str = "cuda") -> bool:
    """The first verify-chunk row of ``batch`` sequences (M = batch * c
    rows through every projection) against a decode step of the same
    sequences (M = batch), from the same pools: are row 0's logits bitwise
    the decode's (returned), and if not, which op (in call order) first
    gives that row other bits."""
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama
    traced = {"embed": "embed", "rms_norm": "rms_norm",
              "add_rms_norm": "add + rms_norm",
              "_projs": "projection", "_proj": "projection",
              "paged_rope_scatter": "rope + write",
              "paged_decode_attention": "attention",
              "paged_chunk_attention": "attention", "_logits": "head"}
    gen = torch.Generator(device=device).manual_seed(seed + 23)
    rng = np.random.default_rng(seed + 23)
    lens = torch.from_numpy(rng.integers(
        1, min(width * PAGED_BS, cfg.max_seq_len) - c,
        size=batch).astype(np.int32)).to(device)
    tables = torch.from_numpy((1 + np.arange(batch * width, dtype=np.int32)
                               ).reshape(batch, width)).to(device)
    shape = (cfg.n_layers, 1 + batch * width, PAGED_BS, cfg.n_kv_heads,
             cfg.head_dim)
    k0 = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    v0 = torch.randn(shape, generator=gen, device=device).to(cfg.dtype)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, c))
                             .astype(np.int32)).to(device)

    def run(verify: bool):
        calls = []
        saved = {name: getattr(llama, name) for name in traced}

        def record(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                for t in out if isinstance(out, (list, tuple)) else [out]:
                    # Each sequence's row 0 ([b, ...]); the decode head's
                    # input is that row already.
                    row = verify or name != "_logits"
                    calls.append((traced[name], t[:, 0] if row else t))
                return out
            return call

        for name in traced:
            setattr(llama, name, record(name, saved[name]))
        try:
            k, v = k0.clone(), v0.clone()
            if verify:
                llama.verify_chunk_paged(cfg, params, chunk, k, v, tables,
                                         lens)
            else:
                llama.decode_step_paged(cfg, params, chunk[:, 0], k, v,
                                        tables, lens)
        finally:
            for name, fn in saved.items():
                setattr(llama, name, fn)
        return calls

    dec, ver = run(False), run(True)
    first = None
    seen: dict[str, int] = {}
    for (name, d), (_, w) in zip(dec, ver):
        seen[name] = seen.get(name, 0) + 1
        if first is None and not torch.equal(d, w):
            first = (name, seen[name])
    same = torch.equal(dec[-1][1], ver[-1][1])
    log(f"spec: verify chunk row 0 (M = {batch * c}) vs a decode step "
        f"(M = {batch}) of {batch} sequences, logits: "
        f"{'bitwise equal' if same else 'DIFFER'} (max abs diff "
        f"{(dec[-1][1] - ver[-1][1]).abs().max().item():.4e}); "
        + ("every traced op's rows equal" if first is None else
           f"first op whose rows differ: {first[0]}, call {first[1]} of it "
           f"(traced in call order: embed, rms_norm, add + rms_norm, "
           f"projections, rope + write, attention, head)"))
    return same


def phase_spec_serve(seed: int, card: str, cfg=None, device: str = "cuda",
                     n_requests: int = 32, batch: int = 32,
                     max_len: int = 2048, new_tokens: int = 64,
                     prompt_lo: int = 64, prompt_hi: int = 1024,
                     bench_len: int = 512, bench_steps: int = 32,
                     short_lo: int = 100, short_hi: int = 300,
                     k: int = SPEC_K) -> dict[str, int]:
    """Speculative serving: llama-1b with int8 weights through
    ``make_engine(spec_decode=True)``, batch 32. (1) ``n_requests``
    requests of prompt_lo..prompt_hi tokens, ``new_tokens`` each, spec off
    and self-draft over a bf16 and an int8 pool, and the tiny draft over a
    bf16 pool: tokens equal spec off's per request; graphs all captured at
    warmup; (3) the kernels' launches of each serve equal ``spec_launches``
    (the counts are zeroed before each serve). (2) A full batch of
    ``bench_len``-token prompts decoding: tokens/s spec against off over
    each pool, a profiled window of 8 dispatches. (4) k = 7 at B = 32 (the
    verify's M = 256): spec == off tokens. (5) bf16 weights (the engine's
    default; the dense GEMM kernel): spec == off tokens at k and at k = 7
    with batch 32, the decode bench of spec off and self-draft at k, and
    ``spec_rows`` equal for bf16 and int8 weights. (6) k = 7 at B = 64
    (the verify's M = 512, in slabs of 256 rows), int8 weights: spec ==
    off tokens. Returns
    the kernels' launches summed over the spec serves of (1) (and the dense
    build's of (5)'s spec serve). With ``device="cpu"`` and a small ``cfg`` the
    same steps rehearse on the CPU (plain versions, eager steps, no launch
    counted, no profile)."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, draft_config, \
        init_params
    from grove_tpu_torch.ops import kvquant, norms, paged, w8a16
    from grove_tpu_torch.serving.engine import make_engine
    from grove_tpu_torch.serving.quant import quantize_params

    cfg = cfg or CONFIGS["llama-1b"]
    dcfg = draft_config(cfg)
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wrappers = [getattr(m, n) for n in SPEC_WRAPPERS
                for m in (paged, kvquant, w8a16, norms) if hasattr(m, n)]
    kernels = ("paged_partial", "paged_combine", "rope_scatter_kernel",
               "w8a16", "rms_norm_kernel")
    rng = np.random.default_rng(seed + 21)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(prompt_lo, prompt_hi + 1,
                                     size=n_requests)]
    bench = rng.integers(0, cfg.vocab_size,
                         (batch, bench_len)).astype(np.int32)
    short_lens = rng.integers(short_lo, short_hi + 1,
                              size=batch).astype(np.int32)
    short = rng.integers(0, cfg.vocab_size,
                         (batch, short_hi)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed + 21)
    dense = init_params(cfg, gen, device=device)
    qparams = quantize_params(dense)

    def build(label, params, lo, hi, **kw):
        t0 = time.perf_counter()
        kw = {"batch": batch, "max_len": max_len, **kw}
        eng = make_engine(cfg, params, device=device, **kw)
        span = eng.spec_k + 1 if eng.spec_decode else 1
        widths = eng.decode_width_buckets(lo, hi + span)
        chunk_widths = eng.decode_width_buckets(1, hi)
        built = eng.warmup(widths=widths, prefill_widths=chunk_widths)
        kind = ("spec off" if not eng.spec_decode else
                f"spec k={eng.spec_k}, " + ("self-draft" if eng._self_draft
                                            else "tiny draft "
                                            f"({dcfg.n_layers} layers, "
                                            f"d_model {dcfg.d_model})"))
        log(f"spec: {label}: {kind}, {eng.kv_quant} KV, batch {eng.batch}; "
            f"warmup built {built} graphs ({'spec' if eng.spec_decode else 'decode'}"
            f": batches {eng._sched.batch_buckets} x widths {widths}; "
            f"chunks: widths {chunk_widths}; plain decode graphs "
            f"{len(eng._steps)}) in {time.perf_counter() - t0:.2f} s, "
            f"{eng.capture_bytes / 2**20:.1f} MiB of graph memory on {card}")
        if eng.spec_decode and eng._steps:
            raise AssertionError(f"{label}: a spec engine built plain steps")
        return eng

    def serve(eng, label, draft):
        """The traffic; returns (tokens in submission order, counts)."""
        for w in wrappers:
            w.launches = 0
        steps0, chunks0, cap0 = eng.steps, eng.chunks, eng.graphs_captured
        n0 = len(eng.completed)
        t = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        drive_paged(eng, n0 + n_requests)
        sync()
        wall = time.perf_counter() - t
        counts = {w.__name__: w.launches for w in wrappers}
        done = {r.rid: list(r.generated) for r in eng.completed[n0:]}
        if sorted(done) != rids or any(
                len(g) != new_tokens or not all(0 <= x < cfg.vocab_size
                                                for x in g)
                for g in done.values()):
            raise AssertionError(f"{label}: wrong requests or tokens")
        steps, chunks = eng.steps - steps0, eng.chunks - chunks0
        st = eng.spec_stats()
        log(f"spec: {label}: {n_requests} requests, "
            f"{n_requests * new_tokens} tokens in {wall:.3f} s over "
            f"{steps} decode dispatches and {chunks} prefill chunks"
            + (f"; accepted per dispatch {st['accepted_per_dispatch']:.4f}, "
               f"acceptance rate {st['acceptance_rate']:.4f}, buckets "
               f"{sorted(st['per_bucket'])}" if st else "")
            + f"; graphs captured during traffic "
            f"{eng.graphs_captured - cap0} on {card}")
        want = spec_launches(cfg, dcfg, draft, eng.kv.quantized, eng.spec_k,
                             steps if on_cuda else 0,
                             chunks if on_cuda else 0)
        log(f"spec: {label}: launches {counts}; want {want}")
        if counts != want:
            raise AssertionError(f"{label}: kernel launches off the path")
        if draft is not None:
            per = spec_launches(cfg, dcfg, draft, eng.kv.quantized,
                                eng.spec_k, 1, 0)
            log(f"spec: {label}: launches per spec dispatch "
                f"{ {n: v for n, v in per.items() if v} }")
        if eng.graphs_captured != cap0:
            raise AssertionError(f"{label}: graphs captured mid-traffic")
        return [done[r] for r in rids], counts

    def decode_bench(eng, label):
        """A full batch decoding: tokens/s, then a profiled window of 8
        dispatches."""
        new = (eng.spec_k + 1) * (bench_steps + 16) + 16
        eng.admit_prompts(bench, max_new_tokens=new)
        eng.run(2)
        sync()
        c0 = eng.spec_stats().get("committed_tokens", 0)
        t = time.perf_counter()
        eng.run(bench_steps)
        sync()
        wall = time.perf_counter() - t
        tokens = (eng.spec_stats()["committed_tokens"] - c0
                  if eng.spec_decode else batch * bench_steps)
        log(f"spec: {label}: decode {tokens / wall:.1f} tokens/s (batch "
            f"{batch}, prompts of {bench_len}, run({bench_steps}) in "
            f"{wall * 1e3:.1f} ms, {wall * 1e3 / bench_steps:.3f} ms per "
            f"dispatch, {tokens} tokens) on {card}")
        if not on_cuda:
            return tokens / wall
        ms = profile_window(f"spec decode ({label})", lambda: eng.run(8),
                            wall * 1e3 / bench_steps * 8, card, kernels)
        log(f"spec: {label}: per dispatch {ms['count'] / 8:.1f} kernels, "
            f"{ms['busy_ms'] / 8:.3f} ms of device time (paged pass 1 "
            f"{ms['paged_partial'] / 8:.3f}, combine "
            f"{ms['paged_combine'] / 8:.3f}, fused write "
            f"{ms['rope_scatter_kernel'] / 8:.3f}, GEMM "
            f"{ms['w8a16'] / 8:.3f} ({100 * ms['w8a16'] / ms['busy_ms']:.1f}"
            f"%), rms_norm {ms['rms_norm_kernel'] / 8:.3f}) on {card}")
        return tokens / wall

    def compare(label, off, on):
        for i, (a, b) in enumerate(zip(off, on)):
            if a != b:
                at = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                return f"{label}: DIFFER, first at request {i}, token {at}"
        return None

    # (1)-(3): token parity and launches; (2) the decode bench per pool.
    def short_run(eng):
        """A full batch at once (admit_prompts prefills every row first):
        ``batch`` prompts of 100..300 tokens, 24 new tokens each."""
        r0 = eng._next_rid
        n0 = len(eng.completed)
        eng.admit_prompts(short, max_new_tokens=short_new,
                          lengths=short_lens)
        drive_paged(eng, n0 + batch)
        return [r.generated for r in sorted(eng.completed[n0:],
                                            key=lambda r: r.rid - r0)]

    short_new = 24
    rates: dict[str, float] = {}  # spec off's decode tokens/s per pool
    launches = dict.fromkeys(SPEC_WRAPPERS, 0)
    hi = prompt_hi + new_tokens
    for pool in ("off", "int8"):
        off = build(f"{pool} KV, spec off", qparams, prompt_lo, hi,
                    kv_quant=pool)
        ref, _ = serve(off, f"{pool} KV, spec off", None)
        if pool == "off":
            ref7 = short_run(off)  # the k = 7 check's reference
        rates[f"{pool} off"] = decode_bench(off, f"{pool} KV, spec off")
        del off
        torch.cuda.empty_cache()
        runs = [("self", {"draft_params": "self"})]
        if pool == "off":
            runs.append(("tiny", {}))
        for draft, kw in runs:
            label = f"{pool} KV, {draft}-draft k={k}"
            eng = build(label, qparams, prompt_lo, hi, kv_quant=pool,
                        spec_decode=True, spec_k=k, **kw)
            got, counts = serve(eng, label, draft)
            bad = compare(label, ref, got)
            log(f"spec: {label}: tokens vs spec off: "
                f"{bad or 'equal for every request'}")
            if bad:
                raise AssertionError(bad)
            for n, v in counts.items():
                launches[n] += v
            rate = decode_bench(eng, label)
            log(f"spec: {pool} KV: decode tokens/s {draft}-draft k={k} "
                f"{rate:.1f} against spec off {rates[f'{pool} off']:.1f}: "
                f"{rate / rates[f'{pool} off']:.3f}x on {card}")
            del eng
            torch.cuda.empty_cache()

    # (4) k = 7 at B = 32: the verify's GEMM at M = 256.
    eng = build("off KV, self-draft k=7", qparams, short_lo,
                short_hi + short_new,
                kv_quant="off", spec_decode=True, spec_k=7,
                draft_params="self")
    got7 = short_run(eng)
    buckets = sorted(eng.spec_stats()["per_bucket"])
    bad = compare("k=7", ref7, got7)
    log(f"spec: off KV, self-draft k=7 at batch {batch} (buckets {buckets}; "
        f"verify M = {batch * 8} at b{batch}): tokens vs spec off: "
        f"{bad or 'equal for every request'}")
    if bad:
        raise AssertionError(bad)
    if not any(b.startswith(f"b{batch},") for b in buckets):
        raise AssertionError(f"k=7: the batch never reached {batch}")
    del eng
    torch.cuda.empty_cache()

    # (5) bf16 weights (the engine's default): every projection through
    # the dense GEMM kernel. Spec off, self-draft at k and at k = 7 (the
    # verify at M = 256: the kernel's four token tiles); the decode bench
    # of spec off and of self-draft at k.
    outs, bf16_rates = [], {}
    for label, kw, bench_it in (
            ("spec off", {}, True),
            (f"self-draft k={k}", dict(spec_decode=True, spec_k=k,
                                       draft_params="self"), True),
            ("self-draft k=7", dict(spec_decode=True, spec_k=7,
                                    draft_params="self"), False)):
        eng = build(f"bf16 weights, {label}", dense, short_lo,
                    hi if bench_it else short_hi + short_new,
                    kv_quant="off", **kw)
        before = w8a16.dense_matmul.launches
        outs.append(short_run(eng))
        if kw.get("spec_k") == k:
            launches["dense_matmul"] += w8a16.dense_matmul.launches - before
        if kw.get("spec_k") == 7:
            buckets = sorted(eng.spec_stats()["per_bucket"])
            if on_cuda and not any(b.startswith(f"b{batch},")
                                   for b in buckets):
                raise AssertionError(f"bf16 weights, k=7: the batch never "
                                     f"reached {batch}")
        if bench_it:
            bf16_rates[label] = decode_bench(eng, f"bf16 weights, {label}")
        del eng
        torch.cuda.empty_cache()
    off_rate = bf16_rates["spec off"]
    log(f"spec: bf16 weights: decode tokens/s self-draft k={k} "
        f"{bf16_rates[f'self-draft k={k}']:.1f} against spec off "
        f"{off_rate:.1f}: {bf16_rates[f'self-draft k={k}'] / off_rate:.3f}x "
        f"on {card}")
    for label, got in ((f"self-draft k={k}", outs[1]),
                       (f"self-draft k=7 at batch {batch} (verify M = "
                        f"{batch * 8})", outs[2])):
        bad = compare(f"bf16 weights, {label}", outs[0], got)
        log(f"spec: bf16 weights (dense projections), {label} vs spec "
            f"off: {bad or 'tokens equal for every request'}")
        if bad:
            raise AssertionError(bad)
    for label, p in (("bf16 weights", dense), ("int8 weights", qparams)):
        if not spec_rows(cfg, p, seed, device=device):
            raise AssertionError(f"{label}: a verify row differs from the "
                                 f"decode row")

    # (6) A verify above 256 rows: batch 2 x 32 at k = 7 (M = 512), int8
    # weights; every projection in slabs of 256 rows.
    big = 2 * batch
    wide_short = np.concatenate([short, short[:, ::-1]])
    wide_lens = np.concatenate([short_lens, short_lens[::-1]])
    outs = []
    for spec in (False, True):
        kw = dict(spec_decode=True, spec_k=7, draft_params="self") \
            if spec else {}
        eng = build(f"batch {big}, {'self-draft k=7' if spec else 'spec off'}",
                    qparams, short_lo, short_hi + short_new, kv_quant="off",
                    batch=big, max_len=min(512, max_len), **kw)
        r0, n0 = eng._next_rid, len(eng.completed)
        eng.admit_prompts(wide_short, max_new_tokens=short_new,
                          lengths=wide_lens)
        drive_paged(eng, n0 + big)
        outs.append([r.generated for r in sorted(
            eng.completed[n0:], key=lambda r: r.rid - r0)])
        if spec:
            buckets = sorted(eng.spec_stats()["per_bucket"])
        del eng
        torch.cuda.empty_cache()
    bad = compare(f"batch {big} k=7", *outs)
    log(f"spec: off KV, self-draft k=7 at batch {big} (buckets {buckets}; "
        f"verify M = {big * 8} at b{big}, {-(-big * 8 // 256)} slabs of "
        f"at most 256 rows per projection): tokens vs spec off: "
        f"{bad or 'equal for every request'}")
    if bad:
        raise AssertionError(bad)
    if on_cuda and not any(b.startswith(f"b{big},") for b in buckets):
        raise AssertionError(f"batch {big}: the batch never reached {big}")
    return launches


def phase_disagg_serve(seed: int, card: str, cfg=None, device: str = "cuda",
                       n_requests: int = 64, batch: int = 32,
                       max_len: int = 2048, new_tokens: int = 64,
                       prompt_lo: int = 64, prompt_hi: int = 1024,
                       shared: int = 264, window: tuple[int, int] = (200, 32),
                       kill_prompts: int = 6,
                       copy_blocks: int = 64) -> dict[str, int]:
    """Disaggregated serving: ``make_engine`` with GROVE_DISAGG=1 (a
    PrefillEngine handing each finished prompt to a PagedDecodeEngine over
    the KV block handoff), batch 32, each tier with its own pool of the mono
    engine's geometry, on phase 7's traffic, beside the mono engine on the
    same traffic: int8 weights over a bf16 pool, then the engine's default
    bf16 weights over an int8 pool (so every paged-path kernel, both GEMM
    builds and both pool kinds, launches on this path). Each pair: warmup
    captures prefill chunks on the prefill tier only, decode steps on the
    decode tier only, and warms the handoff copy; nothing is captured
    during traffic; greedy tokens equal the mono engine's rid for rid; the
    handoff's bytes are its blocks times the block bytes and the shared
    prefix never moves; both allocators pass ``check()`` and hold no
    reference after the drain; launches equal ``paged_launches`` of the
    prefill tier's chunks and the decode tier's steps. Wall, tokens/s, TTFT
    and a window of ticks (device-timeline ms of the prefill tier, the
    pump's copies and the decode tier; of the whole tick for mono) are
    reported beside the mono engine's. On the first pair: the handoff copy
    of a ``copy_blocks``-block payload timed and profiled against its byte
    bound, and the prefill-replica kill (chaos twin): the decode tier holds
    live work, a payload is stranded in the outbox, ``replace_prefill``
    swaps in a fresh tier; the decode allocator is clean right after and
    after the drain, every stranded payload is rescued, and the tokens
    equal the mono engine's. Returns each kernel's launches summed over
    both pairs' serves (zeroed at each start). With ``device="cpu"`` and a
    small ``cfg`` the same steps rehearse on the CPU (no launch counted, no
    timing)."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops import kvquant, norms, paged, w8a16
    from grove_tpu_torch.serving.engine import (DisaggServing,
                                                PagedDecodeEngine,
                                                PrefillEngine, make_engine)
    from grove_tpu_torch.serving.quant import quantize_params

    cfg = cfg or CONFIGS["llama-1b"]
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wrappers = (paged.paged_decode_attention, paged.paged_chunk_attention,
                paged.paged_decode_attention_q8,
                paged.paged_chunk_attention_q8, kvquant.paged_rope_scatter_q,
                kvquant.paged_rope_scatter, kvquant.paged_scatter_q,
                kvquant.paged_scatter, w8a16.w8a16_matmul,
                w8a16.dense_matmul, norms.rms_norm, norms.add_rms_norm)
    prompts = mixed_prompts(np.random.default_rng(seed + 11), cfg,
                            n_requests, prompt_lo, prompt_hi, shared)
    longest = max(len(p) for p in prompts) + new_tokens
    gen = torch.Generator(device=device).manual_seed(seed)
    dense = init_params(cfg, gen, device=device)
    qparams = quantize_params(dense)
    totals = {w.__name__: 0 for w in wrappers}

    def build(params, quant, kv_quant, disagg: bool):
        t0 = time.perf_counter()
        old = os.environ.get("GROVE_DISAGG")
        os.environ["GROVE_DISAGG"] = "1" if disagg else "0"
        try:
            eng = make_engine(cfg, params, batch=batch, max_len=max_len,
                              quant=quant, kv_quant=kv_quant, device=device)
        finally:
            if old is None:
                os.environ.pop("GROVE_DISAGG")
            else:
                os.environ["GROVE_DISAGG"] = old
        if isinstance(eng, DisaggServing) != disagg:
            raise AssertionError(f"make_engine built {type(eng).__name__}")
        tiers = (eng.prefill, eng.decode) if disagg else (eng,)
        ref = tiers[-1]
        widths = ref.decode_width_buckets(prompt_lo, longest)
        chunk_widths = ref.decode_width_buckets(1, longest)
        built = eng.warmup(widths=widths, prefill_widths=chunk_widths)
        n_dec = len(ref._sched.batch_buckets) * len(widths)
        if disagg:
            pre, dec = tiers
            if (pre._steps or sorted(pre._prefills) != chunk_widths
                    or dec._prefills or len(dec._steps) != n_dec
                    or dec._handoff is None):
                raise AssertionError("disagg warmup: a tier built the other "
                                     "tier's steps, or the handoff is cold")
            if on_cuda and (pre.graphs_captured != len(chunk_widths)
                            or dec.graphs_captured != n_dec):
                raise AssertionError(
                    f"disagg warmup captured {pre.graphs_captured} prefill "
                    f"and {dec.graphs_captured} decode graphs")
        log(f"disagg: {'pair' if disagg else 'mono'}: "
            f"{type(eng).__name__}, {cfg.n_layers} layers, "
            f"{quant or 'bf16'} weights, {ref.kv_quant} KV, batch {batch}, "
            f"max_len {max_len}, {ref.kv.num_blocks} blocks per pool "
            f"({ref.kv.pool_bytes / 2**30:.3f} GiB); warmup built {built} "
            f"(graphs captured per tier "
            f"{[t.graphs_captured for t in tiers]}: prefill chunks of widths "
            f"{chunk_widths} on the prefill tier, decode batches "
            f"{ref._sched.batch_buckets} x widths {widths} on the decode "
            f"tier) in {time.perf_counter() - t0:.2f} s with set-up on "
            f"{card}")
        return eng, tiers

    def serve(eng, tiers, label):
        """The traffic; returns (tokens by rid, the report's numbers)."""
        for w in wrappers:
            w.launches = 0
        disagg = len(tiers) == 2
        pre, dec = tiers[0], tiers[-1]
        steps0, chunks0 = dec.steps, pre.chunks
        captured0 = [t.graphs_captured for t in tiers]
        start, width = window
        ticks, split = 0, None

        def timed_window():
            """Device-timeline ms per tick by part, from CUDA events."""
            parts = np.zeros(3)
            marks = []
            for _ in range(width):
                eng.admit_from_queue()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                if disagg:
                    eng.prefill.step()
                    ev[1].record()
                    eng._pump()
                    ev[2].record()
                    eng.decode.step()
                    eng.ticks += 1
                else:
                    eng.step()
                    ev[1].record()
                    ev[2].record()
                ev[3].record()
                marks.append(ev)
            sync()
            for ev in marks:
                parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
            return parts / width

        t = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        for _ in range(100_000):
            eng.admit_from_queue()
            if len(eng.completed) >= n_requests:
                break
            if not eng._active.size:
                continue
            if ticks == start and on_cuda:
                split = timed_window()
                ticks += width
                continue
            eng.step()
            ticks += 1
        eng.sync()
        wall = time.perf_counter() - t
        counts = {w.__name__: w.launches for w in wrappers}
        done = {r.rid: r for r in eng.completed}
        if sorted(done) != rids:
            raise AssertionError(f"{label}: {len(done)} of {n_requests} "
                                 f"requests answered")
        bad = [r.rid for r in done.values()
               if len(r.generated) != new_tokens
               or not all(0 <= x < cfg.vocab_size for x in r.generated)]
        if bad:
            raise AssertionError(f"{label}: requests {bad} have the wrong "
                                 f"tokens")
        steps, chunks = dec.steps - steps0, pre.chunks - chunks0
        ttft = np.array([r.first_token_ts - r.enqueue_ts
                         for r in done.values()]) * 1e3
        n_tok = sum(len(r.generated) for r in done.values())
        out = {"wall_s": wall, "tokens_s": n_tok / wall,
               "ttft_p50_ms": float(np.percentile(ttft, 50)),
               "ttft_p90_ms": float(np.percentile(ttft, 90)),
               "ticks": ticks, "steps": steps, "chunks": chunks}
        log(f"disagg: {label}: {len(done)} requests, {n_tok} tokens in "
            f"{wall:.3f} s ({out['tokens_s']:.1f} tokens/s) over {ticks} "
            f"ticks, {steps} decode steps, {chunks} prefill chunks; TTFT "
            f"p50 {out['ttft_p50_ms']:.1f} ms, p90 {out['ttft_p90_ms']:.1f} "
            f"ms on {card}")
        if split is not None:
            out["window_ms"] = split.tolist()
            what = (f"prefill tier {split[0]:.3f}, handoff pump "
                    f"{split[1]:.3f}, decode tier {split[2]:.3f} ms"
                    if disagg else f"the whole tick {split[0]:.3f} ms")
            log(f"disagg: {label}: ticks {start}..{start + width - 1}, "
                f"device-timeline ms per tick (CUDA events): {what} on "
                f"{card}")
        want = paged_launches(cfg, dec.kv.quantized,
                              "int8" if dec.quant else "bf16", steps,
                              chunks, on_cuda)
        captured = [t.graphs_captured - c for t, c in zip(tiers, captured0)]
        log(f"disagg: {label}: launches {counts} (expected {want}); graphs "
            f"captured during traffic per tier {captured}")
        if counts != want:
            raise AssertionError(f"{label}: kernel launches off the path")
        if any(captured):
            raise AssertionError(f"{label}: graphs captured mid-traffic")
        return {rid: list(r.generated) for rid, r in done.items()}, counts, \
            out

    def check_pair(pair, label):
        hv = pair.handoff_view()
        log(f"disagg: {label}: handoff {hv}; prefill tier produced "
            f"{pair.prefill.handoffs_produced}; decode tier adopted_total "
            f"{pair.decode._alloc.adopted_total}")
        if hv["bytes"] != hv["blocks"] * hv["block_bytes"]:
            raise AssertionError(f"{label}: handoff bytes off its blocks")
        if not hv["shared_blocks"]:
            raise AssertionError(f"{label}: the shared prefix moved")
        if hv["requests"] != n_requests:
            raise AssertionError(f"{label}: {hv['requests']} handoffs")
        for tier in (pair.prefill, pair.decode):
            tier._alloc.check()
            if tier._alloc._refs:
                raise AssertionError(f"{label}: live block references "
                                     f"after the drain")

    def handoff_copy(pair):
        """The padded copy of one payload of ``copy_blocks`` cold blocks:
        distinct free destination blocks, read-only source blocks."""
        dec, pre = pair.decode, pair.prefill
        W, bb = dec.max_blocks_per_seq, dec._block_bytes
        n = min(copy_blocks, W, len(dec._alloc._free))
        ids = np.zeros((2, W), np.int64)
        ids[0, :n] = np.arange(1, n + 1)
        ids[1, :n] = dec._alloc._free[-n:]
        dec._upload(dec._handoff_ids, ids)
        fn = dec._get_handoff()

        def copy():
            fn(pre.kv)

        ms = time_ms(copy, iters=20, warmup=2)
        prof = profile_window(f"handoff copy x10 ({n} cold blocks padded to "
                              f"{W})", lambda: [copy() for _ in range(10)],
                              10 * ms, card, ("ndex",))
        dev_ms = prof["busy_ms"] / 10
        pay = n * bb
        bound = 2 * pay / HBM_BYTES_PER_S * 1e3
        padded = 2 * W * bb / HBM_BYTES_PER_S * 1e3
        log(f"disagg: handoff copy of {n} blocks ({pay} bytes, "
            f"{bb} per block) padded to the table width {W}: {ms:.4f} ms "
            f"(CUDA events), {dev_ms:.4f} ms device time under the profiler "
            f"in {prof['count'] / 10:.0f} kernels per copy; "
            f"{2 * pay / dev_ms / 1e6:.1f} GB/s of the payload's 2 x bytes "
            f"against {HBM_BYTES_PER_S / 1e9:.0f}; byte bound of the "
            f"payload {bound:.4f} ms ({100 * bound / dev_ms:.1f}%), of the "
            f"padded width {padded:.4f} ms ({100 * padded / dev_ms:.1f}%) "
            f"on {card}")

    def replica_kill(pair, params, quant, kv_quant, mono_tokens):
        """The chaos twin: grove_tpu/chaos/scenario.py
        run_prefill_replica_kill's staging on the card."""
        order = sorted(range(n_requests), key=lambda i: len(prompts[i]))
        picks = order[:kill_prompts]         # longest last, as there
        n0 = len(pair.completed)
        first_rid = pair.prefill._next_rid
        for i in picks:
            pair.submit(prompts[i], max_new_tokens=new_tokens)
        guard = 2000
        while not pair.decode._sched.running and guard > 0:
            pair.admit_from_queue()
            pair.step()
            guard -= 1
        if not pair.decode._sched.running:
            raise AssertionError("kill: decode tier never went live")
        guard = 2000
        while not pair.prefill.outbox and guard > 0:
            pair.admit_from_queue()
            pair.prefill.step()
            guard -= 1
        if not pair.prefill.outbox:
            raise AssertionError("kill: never reached a mid-handoff state")
        stranded = len(pair.prefill.outbox)
        in_flight = sum(len(p.blocks) for p in pair.prefill.outbox)
        live = pair.decode._sched.live
        fresh = PrefillEngine(cfg, params, batch=batch, max_len=max_len,
                              quant=quant, kv_quant=kv_quant, device=device)
        fresh.warmup(prefill_widths=sorted(pair.prefill._prefills))
        rescued = pair.replace_prefill(fresh)
        pair.decode._alloc.check()
        if rescued < stranded:
            raise AssertionError("kill: stranded payloads not rescued")
        drive_kill = 0
        while len(pair.completed) < n0 + kill_prompts and drive_kill < 20_000:
            pair.admit_from_queue()
            pair.step()
            drive_kill += 1
        pair.sync()
        for tier in (pair.prefill, pair.decode):
            tier._alloc.check()
            if tier._alloc._refs:
                raise AssertionError("kill: live block references after "
                                     "the drain")
        got = {r.rid: list(r.generated) for r in pair.completed
               if r.rid >= first_rid}
        want = {first_rid + k: mono_tokens[i] for k, i in enumerate(picks)}
        if got != want:
            raise AssertionError("kill: tokens differ from the mono "
                                 "engine's after re-prefill")
        log(f"disagg: prefill-replica kill: {stranded} payloads "
            f"({in_flight} blocks) stranded, {live} sequences live on "
            f"decode; {rescued} requests rescued; decode allocator clean "
            f"after the kill and after the drain; {kill_prompts} requests' "
            f"tokens equal the mono engine's")

    for n_pass, (label, params, quant, kv_quant) in enumerate((
            ("int8 weights, bf16 pool", qparams, "int8", "off"),
            ("bf16 weights, int8 pool", dense, None, "int8"))):
        mono, tiers = build(params, quant, kv_quant, disagg=False)
        if not isinstance(mono, PagedDecodeEngine):
            raise AssertionError("mono: not a PagedDecodeEngine")
        mono_tokens, _, mono_out = serve(mono, tiers, f"mono, {label}")
        del mono, tiers
        pair, tiers = build(params, quant, kv_quant, disagg=True)
        pair_tokens, counts, pair_out = serve(pair, tiers, f"pair, {label}")
        for k, v in counts.items():
            totals[k] += v
        diff = [rid for rid in mono_tokens
                if pair_tokens.get(rid) != mono_tokens[rid]]
        if diff or set(pair_tokens) != set(mono_tokens):
            raise AssertionError(f"{label}: disagg tokens differ from mono "
                                 f"for rids {diff}")
        check_pair(pair, f"pair, {label}")
        log(f"disagg: {label}: pair / mono: wall "
            f"{pair_out['wall_s']:.3f} / {mono_out['wall_s']:.3f} s, "
            f"tokens/s {pair_out['tokens_s']:.1f} / "
            f"{mono_out['tokens_s']:.1f}, TTFT p50 "
            f"{pair_out['ttft_p50_ms']:.1f} / {mono_out['ttft_p50_ms']:.1f} "
            f"ms, p90 {pair_out['ttft_p90_ms']:.1f} / "
            f"{mono_out['ttft_p90_ms']:.1f} ms; the {n_requests} requests' "
            f"tokens equal rid for rid on {card}")
        if n_pass == 0:
            if on_cuda:
                handoff_copy(pair)
            replica_kill(pair, params, quant, kv_quant, mono_tokens)
        del pair, tiers
        if on_cuda:
            torch.cuda.empty_cache()
    return totals


def phase_chunked_prefill(seed: int, card: str, cfg=None,
                          device: str = "cuda", batch: int = 8,
                          max_prompt: int = 1024, chunk: int = 128,
                          n_requests: int = 16,
                          new_tokens: int = 16) -> int:
    """Chunked prefill on the lanes path: llama-1b with int8 weights,
    ``PrefillWorker(batch, max_prompt, prefill_chunk=chunk)`` against the
    one-shot worker on the same ragged prompts: logits within phase 5's
    bf16 bound (max |diff| <= 5e-2 max |logit|), the share of greedy next
    tokens that agree (reported), the flash kernel launched once per layer
    per call (window 0 only), ms per call beside the one-shot prefill and
    the plain attention of the later windows timed alone at their shapes;
    a profiled call; then a lanes ``DecodeEngine`` fed by the chunked
    worker answers every request. Returns the flash launches of one
    chunked call."""
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops.attention import causal_attention
    from grove_tpu_torch.ops.flash import flash_causal_attention
    from grove_tpu_torch.serving.engine import PrefillWorker, make_engine
    from grove_tpu_torch.serving.quant import quantize_params

    cfg = cfg or CONFIGS["llama-1b"]
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(seed + 31)
    params = quantize_params(init_params(cfg, gen, device=device))
    rng = np.random.default_rng(seed + 31)
    lens = rng.integers(chunk // 2, max_prompt + 1, size=batch)
    lens[0] = max_prompt                  # one lane through every window
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    one = PrefillWorker(cfg, params, batch=batch, max_prompt=max_prompt,
                        device=device)
    chunked = PrefillWorker(cfg, params, batch=batch, max_prompt=max_prompt,
                            prefill_chunk=chunk, device=device)
    toks = np.zeros((batch, max_prompt), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks = torch.from_numpy(toks).to(device)
    lengths = torch.from_numpy(lens.astype(np.int32)).to(device)

    def run_one():
        return llama.prefill(cfg, params, toks, one._cache, lengths)[0]

    def run_chunked():
        return llama.prefill_chunked(cfg, params, toks, chunked._cache,
                                     chunk=chunk, lengths=lengths)[0]

    ref = run_one().float()
    f0 = flash_causal_attention.launches
    got = run_chunked().float()
    sync()
    launches = flash_causal_attention.launches - f0
    want = cfg.n_layers if on_cuda else 0
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError("chunked prefill: non-finite logits")
    diff = (got - ref).abs().max().item()
    bound = 5e-2 * ref.abs().max().item()
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum().item())
    log(f"chunked: {cfg.n_layers}-layer prefill of {batch} prompts "
        f"({sorted(lens.tolist())} tokens, padded to {max_prompt}) in "
        f"windows of {chunk}, int8 weights: logits vs one-shot max abs diff "
        f"{diff:.4e} (bound {bound:.4e}); greedy next tokens agree on "
        f"{agree}/{batch} ({100 * agree / batch:.1f}%); flash launches "
        f"{launches} (expected {want}: window 0 only)")
    if diff > bound:
        raise AssertionError("chunked and one-shot prefill disagree")
    if launches != want:
        raise AssertionError(f"flash launched {launches} times on the "
                             f"chunked path, expected {want}")
    r_one, r_chunked = one.prefill(prompts), chunked.prefill(prompts)
    same = sum(a.next_token == b.next_token
               for a, b in zip(r_one, r_chunked))
    log(f"chunked: through PrefillWorker.prefill: next tokens agree on "
        f"{same}/{batch}; lengths {[r.length for r in r_chunked]}")
    if [r.length for r in r_chunked] != lens.tolist():
        raise AssertionError("chunked worker: wrong lengths")
    if on_cuda:
        ms_one = time_ms(run_one, iters=5, warmup=1)
        ms_chunked = time_ms(run_chunked, iters=5, warmup=1)
        # The later windows' plain attention, alone at their shapes, once
        # per layer (the cache holds real rows after the calls above).
        q = torch.randn((batch, chunk, cfg.n_heads, cfg.head_dim),
                        generator=gen, device=device).to(cfg.dtype)
        kc, vc = chunked._cache.k[0], chunked._cache.v[0]
        attn_ms = 0.0
        for off in range(chunk, max_prompt, chunk):
            end = off + chunk
            attn_ms += time_ms(
                lambda: causal_attention(q, kc[:, :end], vc[:, :end],
                                         q_offset=off),
                iters=5, warmup=1) * cfg.n_layers
        # Each call dispatches thousands of small kernels: where the spin
        # does not cover that, the times above hold host time, and the
        # profiles below give each call's device busy time.
        busy = {}
        for name, fn, ms in (("one-shot", run_one, ms_one),
                             ("chunked", run_chunked, ms_chunked)):
            busy[name] = profile_window(
                f"{name} prefill ({batch} x {max_prompt}"
                + (f", windows of {chunk})" if name == "chunked" else ")"),
                fn, ms, card, ("flash_fwd", "w8a16"), top=12)["busy_ms"]
        log(f"chunked: ms per call (CUDA events, host included where the "
            f"spin did not cover the dispatch): chunked {ms_chunked:.3f}, "
            f"one-shot {ms_one:.3f} ({ms_chunked / ms_one:.3f}x); device "
            f"busy per call: chunked {busy['chunked']:.3f}, one-shot "
            f"{busy['one-shot']:.3f} ({busy['chunked'] / busy['one-shot']:.3f}"
            f"x); the later windows' plain attention alone {attn_ms:.3f} ms "
            f"of device time per call ({100 * attn_ms / busy['chunked']:.1f}"
            f"% of the chunked call's device busy) on {card}")
    eng = make_engine(cfg, params, mode="lanes", batch=batch,
                      max_len=max_prompt + new_tokens + 8, quant="int8",
                      host_sync_interval=8, device=device)
    more = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in rng.integers(1, max_prompt + 1, size=n_requests)]
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in more]
    t = time.perf_counter()
    for _ in range(20 * n_requests):
        eng.admit_from_queue(chunked)
        if len(eng.completed) == n_requests:
            break
        eng.run(8)
    sync()
    done = sorted(eng.completed, key=lambda r: r.rid)
    if [r.rid for r in done] != rids or any(
            len(r.generated) != new_tokens
            or not all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in done):
        raise AssertionError("lanes engine fed by the chunked worker: "
                             "requests not all answered")
    log(f"chunked: lanes DecodeEngine fed by the chunked worker answered "
        f"{n_requests} requests of 1..{max_prompt} prompt tokens, "
        f"{new_tokens} new tokens each, in {time.perf_counter() - t:.3f} s "
        f"on {card}")
    return launches


def _observatories_env(on: bool):
    """GROVE_XPROF and GROVE_REQTRACE set for an engine's construction (it
    reads them there), restored afterwards."""
    import contextlib

    @contextlib.contextmanager
    def env():
        keys = ("GROVE_XPROF", "GROVE_REQTRACE")
        old = {k: os.environ.get(k) for k in keys}
        os.environ.update({k: "1" if on else "0" for k in keys})
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return env()


def drive_active(eng, want: int, max_iters: int = 100_000) -> None:
    """Admit and tick while the engine (mono or pair) holds live work or
    undrained tokens, until ``want`` requests are complete."""
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        if eng._active.size:
            eng.step()
    eng.sync()
    if len(eng.completed) < want:
        raise AssertionError(f"{len(eng.completed)} of {want} requests "
                             f"answered")


def bucket_builds(eng) -> int:
    """The bucket executables an engine holds: captured graphs on the card,
    eager steps and chunks on the CPU."""
    return len(eng._steps) + len(eng._specs) + len(eng._prefills)


def phase_observatories(seed: int, card: str, cfg=None, device: str = "cuda",
                        n_requests: int = 64, batch: int = 32,
                        max_len: int = 2048, new_tokens: int = 64,
                        prompt_lo: int = 64, prompt_hi: int = 1024,
                        shared: int = 264, bench_len: int = 512,
                        bench_steps: int = 64, windows: int = 4,
                        turns: int = 2, lanes_prompt: int = 128,
                        lanes_max_len: int = 512,
                        step_device_ms: float | None = None) -> dict:
    """The serving observatories on the main path. Phase 7's serve (the
    default ``make_engine``, int8 weights, bf16 pool; the same 64 requests)
    on two engines, one with GROVE_XPROF/GROVE_REQTRACE on and one with them
    off, in turns (on, off, off, on, ...), each turn the mixed serve and
    ``windows`` timed ``run(bench_steps)`` windows of a full batch of
    ``bench_len``-token prompts: tokens equal rid for rid on and off, no
    graph captured during traffic, the compile table equal to the warmup's
    captures (plus the CoW copy), the kernels' launches of the first serve
    equal to ``paged_launches``, the memory source "device" with
    ``kv_cache_bytes`` the pool's bytes (model-estimate on the CPU), every
    finished rid traced, the device timer's queue never overflowed, and both
    renderers run on the payloads. Reports tokens/s on / off: the serve's
    by turn, the decode windows' best, median and paired, and the flight
    recorder's
    event-timed decode step p50 at the full batch beside
    ``step_device_ms`` (phase 7's profiler device ms per step). Then the
    disaggregated pair once (one trace per rid across the seam, handoff
    series equal to ``handoff_view()``, tokens equal the mono engine's) and
    the lanes engine once (an event-timed "prefill" sample of the flash
    path). With ``device="cpu"`` and a small ``cfg`` it rehearses on the
    CPU."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.ops import kvquant, norms, paged, w8a16
    from grove_tpu_torch.ops.flash import flash_causal_attention
    from grove_tpu_torch.serving import reqtrace, xprof
    from grove_tpu_torch.serving.engine import make_disagg, make_engine
    from grove_tpu_torch.serving.metrics import GLOBAL_METRICS
    from grove_tpu_torch.serving.quant import quantize_params

    cfg = cfg or CONFIGS["llama-1b"]
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wrappers = (paged.paged_decode_attention, paged.paged_chunk_attention,
                paged.paged_decode_attention_q8,
                paged.paged_chunk_attention_q8, kvquant.paged_rope_scatter_q,
                kvquant.paged_rope_scatter, kvquant.paged_scatter_q,
                kvquant.paged_scatter, w8a16.w8a16_matmul,
                w8a16.dense_matmul, norms.rms_norm, norms.add_rms_norm)
    rng = np.random.default_rng(seed + 11)   # phase 7's traffic
    prompts = mixed_prompts(rng, cfg, n_requests, prompt_lo, prompt_hi,
                            shared)
    longest = max(len(p) for p in prompts) + new_tokens
    bench = rng.integers(0, cfg.vocab_size,
                         (batch, bench_len)).astype(np.int32)
    bench_new = windows * bench_steps + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    params = quantize_params(init_params(cfg, gen, device=device))

    def build(on: bool):
        t0 = time.perf_counter()
        with _observatories_env(on):
            eng = make_engine(cfg, params, batch=batch, max_len=max_len,
                              quant="int8", device=device)
        if (eng.xprof is not None, eng.reqtrace is not None) != (on, on):
            raise AssertionError(f"observatories on={on} not honoured")
        widths = eng.decode_width_buckets(prompt_lo,
                                          max(longest, bench_len + bench_new))
        built = eng.warmup(widths=widths, prefill_widths=eng.
                           decode_width_buckets(1, longest))
        log(f"observatories: {'on' if on else 'off'}: warmup built {built} "
            f"graphs in {time.perf_counter() - t0:.2f} s with set-up")
        return eng

    def serve(eng, label):
        """Phase 7's traffic; returns (tokens by rid, generated tokens,
        wall s, launches)."""
        for w in wrappers:
            w.launches = 0
        steps0, chunks0 = eng.steps, eng.chunks
        captured0, builds0 = eng.graphs_captured, bucket_builds(eng)
        sync()
        t = time.perf_counter()
        want = len(eng.completed) + n_requests
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        drive_active(eng, want)
        wall = time.perf_counter() - t
        mine = set(rids)
        done = {r.rid: list(r.generated) for r in eng.completed
                if r.rid in mine}
        if sorted(done) != rids or any(len(g) != new_tokens
                                       for g in done.values()):
            raise AssertionError(f"observatories: {label}: requests lost")
        if eng.graphs_captured != captured0 or \
                bucket_builds(eng) != builds0:
            raise AssertionError(f"observatories: {label}: a graph was "
                                 f"built during traffic")
        counts = {w.__name__: w.launches for w in wrappers}
        want = paged_launches(cfg, False, "int8", eng.steps - steps0,
                              eng.chunks - chunks0, on_cuda)
        n_tok = sum(len(g) for g in done.values())
        return [done[r] for r in rids], n_tok, wall, counts == want

    def decode_windows(order):
        """A full batch decoding on both engines: ``windows`` timed
        run(bench_steps) each, the engines alternating window by window (so
        each pair of windows decodes at the same context length)."""
        for on in order:
            engines[on].admit_prompts(bench, max_new_tokens=bench_new)
        tps = {True: [], False: []}
        for w in range(windows):
            for on in (order if w % 2 == 0 else order[::-1]):
                sync()
                t = time.perf_counter()
                engines[on].run(bench_steps)
                tps[on].append(batch * bench_steps / (time.perf_counter() - t))
        for on in order:
            done = engines[on].completed[-batch:]
            if any(len(r.generated) != bench_new for r in done):
                raise AssertionError("observatories: decode windows lost "
                                     "tokens")
        return tps

    engines = {True: build(True), False: build(False)}
    on_eng = engines[True]
    table0 = on_eng.xprof.compile.counts()
    tokens = {True: [], False: []}
    serve_tps = {True: [], False: []}
    decode_tps = {True: [], False: []}
    launches_ok = None
    for turn in range(turns):   # on, off, then off, on, ...
        order = (True, False) if turn % 2 == 0 else (False, True)
        for on in order:
            toks, n_tok, wall, ok = serve(engines[on], "on" if on else "off")
            if on and launches_ok is None:
                launches_ok = ok
            tokens[on].append(toks)
            serve_tps[on].append(n_tok / wall)
            log(f"observatories: turn {turn}: {'on ' if on else 'off'} serve "
                f"{n_tok / wall:.1f} tokens/s ({wall:.3f} s) on {card}")
        tps = decode_windows(order)
        for on in order:
            decode_tps[on] += tps[on]
            log(f"observatories: turn {turn}: {'on ' if on else 'off'} "
                f"decode windows {', '.join(f'{x:.1f}' for x in tps[on])} "
                f"tokens/s on {card}")
    if tokens[True] != tokens[False]:
        raise AssertionError("observatories: tokens differ on vs off")
    if not launches_ok:
        raise AssertionError("observatories: kernel launches off the path")

    def ratios(tps):
        return (max(tps[True]) / max(tps[False]),
                float(np.median(tps[True]) / np.median(tps[False])))

    # Serve k of one engine is serve k of the other: the first finds a cold
    # prefix cache, a later one every prompt cached (host-bound).
    serve_r = [a / b for a, b in zip(serve_tps[True], serve_tps[False])]
    d_best, d_med = ratios(decode_tps)
    paired = np.array(decode_tps[True]) / np.array(decode_tps[False])
    log(f"observatories: tokens/s on / off: mixed serve by turn "
        f"{', '.join(f'{r:.4f}' for r in serve_r)} (turn 0: cold prefix "
        f"cache); decode best {d_best:.4f}, median {d_med:.4f}, window "
        f"pairs min {paired.min():.4f} median {float(np.median(paired)):.4f} "
        f"({turns * windows} windows of run({bench_steps}) at batch {batch} "
        f"each) on {card}")

    # What the "on" engine saw.
    x, rt = on_eng.xprof, on_eng.reqtrace
    table = x.compile.counts()
    if table != table0:
        raise AssertionError(f"observatories: builds during traffic "
                             f"{table} vs warmup {table0}")
    graphs = sum(n for f, n in table.items() if not f.endswith("_copy"))
    want = on_eng.graphs_captured if on_cuda else bucket_builds(on_eng)
    if graphs != want or table.get("paged_cow_copy") != 1:
        raise AssertionError(f"observatories: compile table {table} vs "
                             f"{want} captures")
    x._last_memory_ts = 0.0
    x.observe_memory(on_eng)
    mem = x._last_memory
    if mem["source"] != ("device" if on_cuda else "model-estimate") or \
            mem["kv_cache_bytes"] != on_eng.kv.pool_bytes:
        raise AssertionError(f"observatories: memory {mem}")
    finished = [r.rid for r in on_eng.completed]
    missing = [r for r in finished if rt.find(r) is None]
    if missing or on_eng._timer.dropped or len(on_eng._timer):
        raise AssertionError(f"observatories: rids without a trace "
                             f"{missing[:8]}, timer dropped "
                             f"{on_eng._timer.dropped}, pending "
                             f"{len(on_eng._timer)}")
    payload = x.payload()
    for line in xprof.render_engine_profile(payload):
        log(f"observatories: profile: {line}")
    rpay = rt.payload()
    worst = rpay["slowest"][0]["rid"]
    for line in reqtrace.render_request_trace(rpay, worst):
        log(f"observatories: trace: {line}")
    steps = sorted(s.seconds for s in x.recorder.snapshot()
                   if s.phase == "step" and s.tokens == batch)
    p50 = steps[len(steps) // 2] * 1e3 if steps else float("nan")
    log(f"observatories: memory {mem}; compile table {len(table)} fns, "
        f"{graphs} graphs = {want} captures; {len(finished)} finished, "
        f"{rpay['ring']['len']} traces; timer resolved "
        f"{on_eng._timer.resolved} pairs, dropped 0")
    profiled = ("not measured" if step_device_ms is None
                else f"{step_device_ms:.4f} device ms per step")
    log(f"observatories: flight recorder decode step at batch {batch}: "
        f"p50 {p50:.4f} ms over {len(steps)} event-timed samples; phase 7's "
        f"profiler (the same batch and prompts): {profiled} on {card}")
    mono_tokens = tokens[True][0]
    del engines, on_eng
    if on_cuda:
        torch.cuda.empty_cache()

    # The disaggregated pair, once, observatories on.
    with _observatories_env(True):
        pair = make_disagg(cfg, params, batch=batch, max_len=max_len,
                           quant="int8", device=device)
    pair.warmup(widths=pair.decode.decode_width_buckets(prompt_lo, longest),
                prefill_widths=pair.prefill.decode_width_buckets(1, longest))
    before = {k: GLOBAL_METRICS.counter_total(f"grove_handoff_{k}_total")
              for k in ("blocks", "bytes")}
    secs0 = GLOBAL_METRICS.hist_totals("grove_handoff_seconds")
    rids = [pair.submit(p, max_new_tokens=new_tokens) for p in prompts]
    drive_active(pair, n_requests)
    done = {r.rid: list(r.generated) for r in pair.completed}
    if [done[r] for r in rids] != mono_tokens:
        raise AssertionError("observatories: the pair's tokens differ")
    hv = pair.handoff_view()
    moved = {k: GLOBAL_METRICS.counter_total(f"grove_handoff_{k}_total")
             - before[k] for k in before}
    secs = GLOBAL_METRICS.hist_totals("grove_handoff_seconds")
    n_timed = secs[1] - secs0[1]
    if moved != {"blocks": hv["blocks"], "bytes": hv["bytes"]} or \
            not n_timed:
        raise AssertionError(f"observatories: handoff series {moved} vs "
                             f"{hv}, {n_timed} timed copies")
    prec = pair.reqtrace.payload()
    traced = {t["rid"]: [s["phase"] for s in t["spans"]]
              for t in prec["traces"]}
    bad = [r for r in rids if r not in traced or not (
        traced[r].index("prefill") < traced[r].index("handoff")
        < traced[r].index("decode"))]
    if bad or pair.prefill.reqtrace is not pair.reqtrace:
        raise AssertionError(f"observatories: traces across the seam: "
                             f"{bad[:8]}")
    log(f"observatories: pair: {len(traced)} traces across the seam, "
        f"handoff {moved['blocks']} blocks / {moved['bytes']} bytes = "
        f"handoff_view; {n_timed:.0f} event-timed copies, mean "
        f"{(secs[0] - secs0[0]) / n_timed * 1e3:.4f} ms (host wall of the "
        f"dispatch {hv['ms_per_request']:.4f} ms per request) on {card}")
    del pair
    if on_cuda:
        torch.cuda.empty_cache()

    # The lanes engine, once: an event-timed prefill of the flash path.
    with _observatories_env(True):
        lanes = make_engine(cfg, params, mode="lanes", batch=batch,
                            max_len=lanes_max_len, quant="int8",
                            device=device)
    lp = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        batch, lanes_prompt)).astype(np.int32)).to(device)
    lanes.admit_prompts(lp)                    # the build: not sampled
    flash_causal_attention.launches = 0
    lanes.admit_prompts(lp, max_new_tokens=17)
    flash = flash_causal_attention.launches
    lanes.run(16)
    stats = lanes.xprof.recorder.phase_stats()
    if stats.get("prefill", {}).get("count") != 1 or \
            flash != (cfg.n_layers if on_cuda else 0):
        raise AssertionError(f"observatories: lanes prefill samples "
                             f"{stats.get('prefill')}, flash {flash}")
    log(f"observatories: lanes: prefill {batch} x {lanes_prompt} "
        f"{stats['prefill']['p50_ms']:.4f} ms (CUDA events; flash launched "
        f"{flash} times); compile table {lanes.xprof.compile.counts()} on "
        f"{card}")
    return {"serve_ratio": serve_r, "decode_ratio": (d_best, d_med),
            "step_p50_ms": p50}


# ---- training and checkpoints ----

# The hand-written kernels, by wrapper module, whose counts phase 13 reads:
# the training path must launch none, the warm-restart serves each of
# RESTART_KERNELS.
KERNEL_WRAPPERS = SPEC_WRAPPERS + ("flash_causal_attention",)
RESTART_KERNELS = ("flash_causal_attention", "paged_decode_attention",
                   "paged_chunk_attention", "paged_rope_scatter",
                   "w8a16_matmul", "dense_matmul", "rms_norm",
                   "add_rms_norm")


def kernel_wrappers() -> dict:
    from grove_tpu_torch.ops import flash, kvquant, norms, paged, w8a16
    return {n: getattr(m, n) for n in KERNEL_WRAPPERS
            for m in (paged, kvquant, w8a16, norms, flash) if hasattr(m, n)}


def emit(check: str, **fields) -> None:
    """One phase-13 result as a JSON line."""
    print(json.dumps({"phase": 13, "check": check, **fields}), flush=True)


def _leaves(tree):
    """(path, tensor) of every leaf of a params dict, int8 leaves as their
    q and scale (``quant.flatten_params``)."""
    from grove_tpu_torch.serving.quant import flatten_params
    return flatten_params(tree)[0].items()


def train_parity(family: str, mod, cfg, seed: int, device: str,
                 steps: int = 3) -> dict:
    """The port's training step at ``cfg`` (f32) on ``device`` against the
    CPU: the same params (one numpy tree through ``params_from_numpy``) and
    tokens. The loss to 1e-5 relative, every gradient leaf to 1e-4 of its
    max norm, every param after ``steps`` AdamW steps to 1e-4, but for
    elements whose first gradient is rounding noise around zero on both
    sides (at most 1e-7 of the leaf's max norm, not exactly zero): Adam's
    first update there is g / (|g| + 1e-8), so they are held to 2 lr,
    counted, and capped at max(1, size // 1000) per leaf, as the CPU
    test caps them."""
    import numpy as np
    import torch
    from grove_tpu_torch import train
    from grove_tpu_torch.convert import params_from_numpy

    gen = torch.Generator().manual_seed(seed)
    host = mod.init_params(cfg, gen, device="cpu")
    tree = {k: ({n: w.numpy() for n, w in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in host.items()}
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    out = {}
    for dev in (device, "cpu"):
        params = params_from_numpy(tree, device=dev)
        opt = train.make_optimizer(params)
        tokens = torch.from_numpy(toks).to(dev)
        losses, first = [], None
        for i in range(steps):
            losses.append(train.train_step(cfg, params, opt, tokens,
                                           loss=mod.loss_fn))
            if i == 0:
                first = {k: t.grad.detach().cpu().clone()
                         for k, t in _leaves(params)}
        out[dev] = (float(losses[0]), first,
                    {k: t.detach().cpu() for k, t in _leaves(params)})
    (l_dev, g_dev, p_dev), (l_cpu, g_cpu, p_cpu) = out[device], out["cpu"]
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    grad_rel = max(((g_dev[k] - g).abs().max()
                    / g.abs().max().clamp_min(1e-30)).item()
                   for k, g in g_cpu.items())
    param_err, noise_err, noise, over_cap = 0.0, 0.0, 0, []
    for k, p in p_cpu.items():
        ga, gb = g_cpu[k].abs(), g_dev[k].abs()
        thr = 1e-7 * ga.max()
        mask = (ga <= thr) & (gb <= thr) & ((ga > 0) | (gb > 0))
        err = (p_dev[k] - p).abs()
        if (~mask).any():
            param_err = max(param_err, err[~mask].max().item())
        if mask.any():
            n = int(mask.sum())
            noise += n
            noise_err = max(noise_err, err[mask].max().item())
            if n > max(1, p.numel() // 1000):
                over_cap.append(k)
    fields = {"family": family, "device": device, "dtype": "float32",
              "loss_device": l_dev, "loss_cpu": l_cpu,
              "loss_rel_diff": loss_rel, "loss_tol": 1e-5,
              "grad_max_rel_diff": grad_rel, "grad_tol": 1e-4,
              "adamw_steps": steps, "param_max_abs_diff": param_err,
              "param_tol": 1e-4, "noise_elements": noise,
              "noise_cap": "max(1, leaf size // 1000) per leaf",
              "noise_over_cap": over_cap,
              "noise_max_abs_diff": noise_err, "noise_tol": 2e-3}
    emit("train_parity", **fields)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and param_err <= 1e-4
            and noise_err <= 2e-3 and not over_cap):
        raise AssertionError(f"training parity {family}: {fields}")
    return fields


def train_full(cfg, seed: int, device: str, batch: int, seq: int,
               card: str, steps: int = 3):
    """``steps`` train steps of ``cfg`` (bf16) on one fixed batch of
    ``batch`` x ``seq`` tokens: the loss finite and falling from the first
    step to the last, every gradient leaf finite and one non-zero; the step
    time from CUDA events over the steps after the first, tokens/s, the
    peak device memory and 6 N tokens / step time / 989e12; on the card
    one more step under the profiler, its device time by kernel family.
    Returns the trained params. The batch falls back to 1 (said so) if
    ``batch`` does not fit; the sequence is never shortened."""
    import numpy as np
    import torch
    from grove_tpu_torch import train
    from grove_tpu_torch.models import llama

    on_cuda = device == "cuda"
    note = None
    while True:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llama.init_params(cfg, gen, device=device)
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(device)
        opt = train.make_optimizer(params)
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            losses = [train.train_step(cfg, params, opt, toks)]
            first_s = None
            if on_cuda:
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            for _ in range(steps - 1):
                losses.append(train.train_step(cfg, params, opt, toks))
            if on_cuda:
                ev[1].record()
                torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            note = (f"batch {batch} x {seq} did not fit in device memory; "
                    f"batch 1 x {seq} instead")
            log(f"train: {note}")
            del params, opt
            torch.cuda.empty_cache()
            batch = 1
    vals = [float(v) for v in losses]
    grads = [p.grad for p in train.param_leaves(params)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = any(bool((g != 0).any()) for g in grads)
    n_params = sum(p.numel() for p in train.param_leaves(params))
    tokens = batch * seq
    fields = {"model": "llama-1b", "dtype": str(cfg.dtype),
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "batch": batch, "seq": seq, "tokens_per_step": tokens,
              "losses": vals, "grads_finite": finite,
              "grads_nonzero": nonzero, "params": n_params, "card": card}
    if note:
        fields["note"] = note
    if on_cuda:
        step_ms = ev[0].elapsed_time(ev[1]) / (steps - 1)
        fields.update(
            first_step_s=first_s, step_ms=step_ms,
            tokens_per_s=tokens / (step_ms / 1e3),
            peak_bytes=torch.cuda.max_memory_allocated(),
            model_flop_share=6 * n_params * tokens / (step_ms / 1e3)
            / PEAK_OPS_PER_S["torch.bfloat16"])
        # Where a step's device time goes, by kernel family (one more
        # step, under the profiler): kernels named "gemm" (the f32
        # products: the scores and the LM head), cuBLAS's "nvjet" kernels
        # (the bf16 projections), elementwise and reductions, softmax, the
        # optimizer's foreach kernels, gathers.
        families = ("gemm", "nvjet", "elementwise", "reduce", "SoftMax",
                    "multi_tensor_apply", "index")
        prof = profile_window(
            f"llama-1b train step ({batch} x {seq})",
            lambda: train.train_step(cfg, params, opt, toks), step_ms,
            card, families, top=15)
        fields["profile"] = {"busy_ms": prof["busy_ms"],
                             "kernels": prof["count"],
                             **{f"{f}_ms": prof[f] for f in families}}
    emit("train_llama", **fields)
    if not (all(np.isfinite(vals)) and vals[-1] < vals[0] and finite
            and nonzero):
        raise AssertionError(f"llama training: {fields}")
    return params


def train_moe(cfg, seed: int, device: str, seq: int, card: str,
              reduced: dict) -> None:
    """One train step of the dense MoE path at ``cfg`` (bf16), batch 1 x
    ``seq``: the loss and every gradient finite, every expert picked by a
    token in layer 0; the step's time and the peak device memory."""
    import numpy as np
    import torch
    from grove_tpu_torch import train
    from grove_tpu_torch.models import llama, moe
    from grove_tpu_torch.ops.attention import causal_attention
    from grove_tpu_torch.ops.norms import rms_norm_ref

    on_cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe.init_params(cfg, gen, device=device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, seq)).astype(np.int32)).to(device)
    with torch.no_grad():                 # layer 0's routing
        x = llama.embed(cfg, params, toks)
        cos, sin = llama._rope(cfg.max_seq_len, cfg.head_dim,
                               cfg.rope_theta, toks.device)
        pos = torch.arange(seq, device=device).expand(1, seq)
        lp = llama.layer_params(params["layers"], 0)
        q, k, v = llama.qkv(cfg, x, lp, cos, sin, pos)
        x = llama.attn_out(x, causal_attention(q, k, v), lp)
        hm = rms_norm_ref(x, lp["mlp_norm"], cfg.norm_eps)
        logits = hm.float() @ lp["router"].float()
        picks = torch.topk(logits, cfg.experts_per_token, dim=-1)[1]
        per_expert = torch.bincount(picks.reshape(-1),
                                    minlength=cfg.n_experts).tolist()
    opt = train.make_optimizer(params)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(train.train_step(cfg, params, opt, toks, loss=moe.loss_fn))
    step_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in train.param_leaves(params))
    fields = {"model": "mixtral-8x7b", "dtype": str(cfg.dtype),
              "reduced": reduced, "batch": 1, "seq": seq, "loss": loss,
              "grads_finite": finite, "layer0_tokens_per_expert": per_expert,
              "params": sum(p.numel() for p in train.param_leaves(params)),
              "step_s": step_s, "card": card}
    if on_cuda:
        fields["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit("train_moe", **fields)
    if not (np.isfinite(loss) and finite and min(per_expert) > 0):
        raise AssertionError(f"MoE training: {fields}")


# Phase 13's one-card save and load rates, printed beside phase 14's.
ROUNDTRIP_GB_PER_S: dict = {}


def checkpoint_roundtrip(params, device: str, card: str) -> None:
    """``save_params`` then ``load_params(like=)`` of ``params`` in a fresh
    temporary directory: every leaf back bitwise on ``device``; the bytes,
    both seconds and GB/s."""
    import shutil
    import tempfile
    import torch
    from grove_tpu_torch.serving import checkpoint as ckpt
    from grove_tpu_torch.serving.quant import params_bytes

    d = tempfile.mkdtemp(prefix="grove-ckpt-")
    try:
        nbytes = params_bytes(params)
        t0 = time.perf_counter()
        ckpt.save_params(d, params, step=0)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.load_params(d, 0, like=params)
        if device == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs = list(zip(_leaves(params), _leaves(back)))
        same = all(ka == kb and b.device == a.device and b.dtype == a.dtype
                   and torch.equal(a.detach(), b)
                   for (ka, a), (kb, b) in pairs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    fields = {"leaves": len(pairs), "bytes": nbytes, "bitwise": same,
              "save_s": save_s, "load_s": load_s,
              "save_gb_per_s": nbytes / save_s / 1e9,
              "load_gb_per_s": nbytes / load_s / 1e9,
              "device": str(back["lm_head"].device), "card": card}
    ROUNDTRIP_GB_PER_S.update(save=fields["save_gb_per_s"],
                              load=fields["load_gb_per_s"])
    emit("checkpoint_roundtrip", **fields)
    if not same:
        raise AssertionError(f"checkpoint round trip not bitwise: {fields}")


def restart_case(label: str, cfg, a, b, device: str, card: str, rng,
                 kw: dict, root: str, n_requests: int, prompt_lo: int,
                 prompt_hi: int, new_tokens: int, lanes_prompt: int = 128,
                 barrier: bool = False) -> dict:
    """A -> B -> A into one live engine: an engine on params ``a`` serves
    the traffic (tokens T_A); B's checkpoint is copied in place by
    ``warm_restart`` and the engine serves the tokens of a fresh engine on
    ``b`` (T_B); A's step 0 restored, T_A again, bitwise. No build after
    the first warmup: the graph count and the observatory's compile table
    stay put. The checkpoints live under ``root``, one pair per kind of
    weights (dense or int8), each written by ``save_engine`` (step 0) from
    the first engine of its kind and restored into the later ones. With
    ``barrier``, the responder's duck-typed call moves ``latest_step`` of
    A's directory from 0 to 1. Returns the fields of the result line, which
    the caller prints; raises with them if a check fails."""
    import numpy as np
    import torch
    from grove_tpu_torch.serving import checkpoint as ckpt
    from grove_tpu_torch.serving.engine import DecodeEngine, make_engine

    lanes = kw.get("mode") == "lanes"
    if lanes:
        batch = kw["batch"]
        traffic = rng.integers(0, cfg.vocab_size,
                               (batch, lanes_prompt)).astype(np.int32)
    else:
        traffic = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(
            np.int32) for n in rng.integers(prompt_lo, prompt_hi + 1,
                                            size=n_requests)]

    def build(params):
        eng = make_engine(cfg, params, device=device, **kw)
        if not lanes:
            span = eng.spec_k + 1 if eng.spec_decode else 1
            longest = prompt_hi + new_tokens
            eng.warmup(widths=eng.decode_width_buckets(prompt_lo,
                                                       longest + span),
                       prefill_widths=eng.decode_width_buckets(1, longest))
        return eng

    def serve(eng) -> list[list[int]]:
        n0 = len(eng.completed)
        if isinstance(eng, DecodeEngine):
            eng.admit_prompts(torch.from_numpy(traffic).to(device),
                              max_new_tokens=new_tokens)
            for _ in range(new_tokens):
                if len(eng.completed) >= n0 + len(traffic):
                    break
                eng.run(eng.host_sync_interval)
            eng.sync()
            if len(eng.completed) < n0 + len(traffic):
                raise AssertionError(f"{label}: lanes not all answered")
        else:
            for p in traffic:
                eng.submit(p, max_new_tokens=new_tokens)
            drive_paged(eng, n0 + len(traffic))
        return [list(r.generated)
                for r in sorted(eng.completed[n0:], key=lambda r: r.rid)]

    def builds(eng) -> dict:
        return {"graphs": getattr(eng, "graphs_captured", 0),
                "compile_table": sum(eng.xprof.compile.counts().values())
                if eng.xprof is not None else None}

    kind = "int8" if kw.get("quant") == "int8" else "dense"
    path_a, path_b = (os.path.join(root, kind, x) for x in ("a", "b"))
    fresh = build(b)
    tok_b = serve(fresh)
    if ckpt.latest_step(path_b) is None:
        ckpt.save_engine(path_b, fresh)
    del fresh
    live = build(a)
    warm = builds(live)
    held = [t for _, t in _leaves(live.params)]
    tree = live.params
    t0 = time.perf_counter()
    tok_a = serve(live)
    serve_s = time.perf_counter() - t0
    # The lanes engine captures each graph at its first dispatch: its
    # builds are the first serve's.
    built = builds(live)
    if lanes and device == "cuda" and not built["graphs"]:
        raise AssertionError(f"{label}: the lanes decode captured no graph")
    if ckpt.latest_step(path_a) is None:
        ckpt.save_engine(path_a, live)                     # step 0
    t0 = time.perf_counter()
    ckpt.warm_restart(path_b, live)
    if device == "cuda":
        torch.cuda.synchronize()
    restart_s = time.perf_counter() - t0
    got_b = serve(live)
    ckpt.warm_restart(path_a, live, step=0)
    got_a = serve(live)
    kept = live.params is tree and all(
        t is u for t, (_, u) in zip(held, _leaves(live.params)))
    after = builds(live)
    steps = None
    if barrier:
        respond = ckpt.engine_responder(live, path_a)
        before_step = ckpt.latest_step(path_a)
        respond(None)                 # what a registered barrier calls
        steps = [before_step, ckpt.latest_step(path_a)]
    fields = {"engine": label, "requests": len(traffic),
              "new_tokens": new_tokens,
              "b_differs_from_a": tok_b != tok_a,
              "restored_b_equals_fresh_b": got_b == tok_b,
              "restored_a_equals_a": got_a == tok_a,
              "params_kept_in_place": kept,
              "builds_after_warmup": warm,
              "builds_after_first_serve": built, "builds_after": after,
              "warm_restart_s": restart_s, "serve_s": serve_s,
              "card": card}
    if steps is not None:
        fields["barrier_latest_step"] = steps
    if not (tok_b != tok_a and got_b == tok_b and got_a == tok_a
            and kept and after == built and (lanes or warm == built)
            and (steps is None or steps == [0, 1])):
        raise AssertionError(f"warm restart ({label}): {fields}")
    return fields


def phase_train_checkpoint(seed: int, card: str, cfg=None, moe_cfg=None,
                           tiny=None, moe_tiny=None, device: str = "cuda",
                           batch: int = 2, seq: int = 2048,
                           moe_layers: int = 2, moe_seq: int = 1024,
                           n_requests: int = 8, prompt_lo: int = 64,
                           prompt_hi: int = 256, new_tokens: int = 16,
                           restart_max_len: int = 512,
                           lanes_prompt: int = 128) -> dict[str, int]:
    """Training and checkpoints. (1) test-tiny and moe-test-tiny in f32:
    the card against the CPU (``train_parity``). (2) llama-1b at full width
    and depth, bf16, ``batch`` x ``seq`` tokens, three train steps on one
    batch (``train_full``). (3) Mixtral-8x7B's widths at ``moe_layers``
    layers (32 layers of bf16 weights, about 94 GB, do not fit one 80 GB
    card), batch 1 x ``moe_seq``, one train step (``train_moe``). The
    training steps launch no hand-written kernel (counts read around them).
    (4) the trained llama-1b params through ``save_params`` /
    ``load_params(like=)`` bitwise (``checkpoint_roundtrip``). (5) A -> B
    -> A warm restarts into live llama-1b engines (``restart_case``): the
    paged engine with bf16 weights, with int8 weights, with self-draft
    speculation, and the lanes engine with ``lanes_prompt``-token prompts
    (its prefill through the flash kernel; then the barrier's responder).
    Returns the kernels' launches over (5), the counts zeroed before it.
    With ``device="cpu"`` and small configs the same steps rehearse on the
    CPU (plain versions, no launch, no timing)."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama, moe

    on_cuda = device == "cuda"
    cfg = cfg or llama.CONFIGS["llama-1b"]
    moe_cfg = moe_cfg or moe.MOE_CONFIGS["mixtral-8x7b"]
    tiny = tiny or llama.CONFIGS["test-tiny"]
    moe_tiny = moe_tiny or moe.MOE_CONFIGS["moe-test-tiny"]
    wrappers = kernel_wrappers()
    emit("numerics", allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 products must not take TF32")

    # (1)-(3): training; no kernel may launch.
    for w in wrappers.values():
        w.launches = 0
    for family, mod, c in (("llama", llama, tiny), ("moe", moe, moe_tiny)):
        train_parity(family, mod, dataclasses.replace(c, dtype=torch.float32),
                     seed + 41, device)
    trained = train_full(cfg, seed + 42, device, batch, seq, card)
    reduced = {"n_layers": f"{moe_cfg.n_layers} -> {moe_layers}"}
    train_moe(dataclasses.replace(moe_cfg, n_layers=moe_layers), seed + 43,
              device, moe_seq, card, reduced)
    launched = {n: w.launches for n, w in wrappers.items() if w.launches}
    emit("train_kernel_launches", launches=launched)
    if launched:
        raise AssertionError(f"the training path launched kernels: "
                             f"{launched}")
    # (4) the checkpoint round trip of the trained params.
    checkpoint_roundtrip(trained, device, card)
    del trained
    if on_cuda:
        torch.cuda.empty_cache()
    # (5) warm restarts into live engines.
    root = tempfile.mkdtemp(prefix="grove-restart-")
    gen = torch.Generator(device=device).manual_seed(seed + 44)
    a = llama.init_params(cfg, gen, device=device)
    b = llama.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(seed + 44)
    paged = dict(mode="paged", batch=8, max_len=restart_max_len)
    traffic = dict(n_requests=n_requests, prompt_lo=prompt_lo,
                   prompt_hi=prompt_hi, new_tokens=new_tokens)
    for w in wrappers.values():
        w.launches = 0
    try:
        emit("warm_restart", **restart_case(
            "paged, bf16 weights", cfg, a, b, device, card, rng, paged,
            root, **traffic))
        emit("warm_restart", **restart_case(
            "paged, int8 weights", cfg, a, b, device, card, rng,
            dict(paged, quant="int8"), root, **traffic))
        emit("warm_restart", **restart_case(
            "paged, self-draft spec", cfg, a, b, device, card, rng,
            dict(paged, spec_decode=True, spec_k=3, draft_params="self"),
            root, **traffic))
        emit("warm_restart", **restart_case(
            "lanes, flash prefill", cfg, a, b, device, card, rng,
            dict(mode="lanes", batch=8,
                 max_len=lanes_prompt + new_tokens + 8), root,
            lanes_prompt=lanes_prompt, barrier=True, **traffic))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {n: w.launches for n, w in wrappers.items()}
    emit("restart_kernel_launches", launches=launches)
    missing = [n for n in RESTART_KERNELS if on_cuda and not launches[n]]
    if missing:
        raise AssertionError(f"the warm-restart serves never launched "
                             f"{missing}")
    return launches


# ---- tensor-parallel serving (phase 14) ----

# The per-rank widths phase 14 runs the paged path's kernels at: llama-1b
# at tp = 2, 4 and 8 and llama-70b at tp = 8 (one layer's weights).
TP_SHARDS = (("llama-1b", 2), ("llama-1b", 4), ("llama-1b", 8),
             ("llama-70b", 8))


def emit14(check: str, **fields) -> None:
    """One phase-14 result as a JSON line."""
    print(json.dumps({"phase": 14, "check": check, **fields}), flush=True)


def one_rank_group(device: str):
    """A process group of this process alone (``file://`` rendezvous in a
    fresh temporary directory): NCCL on the card, gloo for the CPU
    rehearsal. Returns its directory, which the caller removes after
    ``destroy_process_group``."""
    import tempfile
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("a process group is already initialised")
    path = tempfile.mkdtemp(prefix="grove-tp-")
    kw = {}
    if device == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(path, 'pg')}",
                            world_size=1, rank=0, **kw)
    return path


def phase_tp_serve(seed: int, card: str, cfg=None, device: str = "cuda",
                   n_requests: int = 16, batch: int = 16,
                   max_len: int = 1024, new_tokens: int = 32,
                   prompt_lo: int = 64, prompt_hi: int = 512,
                   shared: int = 96, bench_len: int = 256,
                   bench_steps: int = 32) -> dict[str, int]:
    """Tensor-parallel serving over a one-rank group: ``build_mesh(
    MeshPlan())`` over NCCL (gloo on the CPU), the paged engine with
    ``mesh=`` at llama-1b's full width and depth (int8 weights, bf16 pool)
    on ``n_requests`` requests of [prompt_lo, prompt_hi] prompt tokens
    (every other one opening with one shared prefix), ``new_tokens`` each,
    against the same engine and traffic with ``mesh=None``: tokens equal
    rid for rid, bitwise; then the same for bf16 weights over an int8 pool;
    spec self-draft under the mesh equal to greedy under the mesh; the
    disaggregated pair under the mesh equal to the mono engine under it.
    Every mesh run's graphs are captured at warmup, none during traffic,
    with the group's collectives inside them: 2 n_layers + 2 per forward,
    from the group's own host count. A full batch decoding with and
    without the mesh: tokens/s and device ms per 8 decode steps, and the
    communication kernels the profiler sees in the replayed graphs.
    Returns the kernels' launches summed over the mesh runs (each run's
    counts zeroed just before it and read just after)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from grove_tpu_torch.serving.engine import (DisaggServing,
                                                PagedDecodeEngine,
                                                make_disagg, make_engine)

    cfg = cfg or CONFIGS["llama-1b"]
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wrappers = kernel_wrappers()
    per_forward = 2 * cfg.n_layers + 2
    rng = np.random.default_rng(seed + 23)
    prompts = mixed_prompts(rng, cfg, n_requests, prompt_lo, prompt_hi,
                            shared)
    longest = max(len(p) for p in prompts) + new_tokens
    bench = rng.integers(0, cfg.vocab_size,
                         (batch, bench_len)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed + 23)
    params = init_params(cfg, gen, device=device)
    path = one_rank_group(device)
    try:
        mesh = build_mesh(MeshPlan())
        comm = mesh.comm("tp")
        log(f"tp: a one-rank {dist.get_backend()} group, mesh "
            f"{mesh.shape}; the tp axis's group has {comm.size} rank(s)")
        total = dict.fromkeys(SPEC_WRAPPERS, 0)

        def build(label, mesh_, **kw):
            t0 = time.perf_counter()
            maker = make_disagg if kw.pop("pair", False) else make_engine
            eng = maker(cfg, params, batch=batch, max_len=max_len,
                        mesh=mesh_, device=device, **kw)
            tiers = ([eng.prefill, eng.decode]
                     if isinstance(eng, DisaggServing) else [eng])
            if not all(isinstance(t, PagedDecodeEngine) for t in tiers):
                raise AssertionError(f"{label}: built {type(eng).__name__}")
            widths = tiers[-1].decode_width_buckets(prompt_lo, longest)
            built = eng.warmup(widths=widths, prefill_widths=tiers[
                0].decode_width_buckets(1, longest))
            captured = sum(t.graphs_captured for t in tiers)
            log(f"tp: {label}: {type(eng).__name__}, "
                f"{'mesh ' + str(mesh_.shape) if mesh_ else 'no mesh'}, "
                f"{tiers[-1].kv_quant} KV ({tuple(tiers[-1].kv.k.shape)} "
                f"per pool), warmup built {built} graphs in "
                f"{time.perf_counter() - t0:.2f} s with set-up ({captured} "
                f"captured) on {card}")
            return eng, tiers

        def serve(label, eng, tiers, want=None):
            """The traffic; checks the launches against ``want(steps,
            chunks)`` and, under the mesh, the collectives per forward."""
            for w in wrappers.values():
                w.launches = 0
            comm.launches = 0
            steps0 = tiers[-1].steps
            chunks0 = tiers[0].chunks
            cap0 = sum(t.graphs_captured for t in tiers)
            t = time.perf_counter()
            rids = [eng.submit(p, max_new_tokens=new_tokens)
                    for p in prompts]
            drive_active(eng, n_requests)
            wall = time.perf_counter() - t
            counts = {n: wrappers[n].launches for n in SPEC_WRAPPERS}
            calls = comm.launches
            steps = tiers[-1].steps - steps0
            chunks = tiers[0].chunks - chunks0
            done = {r.rid: list(r.generated) for r in eng.completed}
            if sorted(done) != rids or any(len(g) != new_tokens
                                           for g in done.values()):
                raise AssertionError(f"{label}: requests lost or short")
            n_tok = sum(len(g) for g in done.values())
            log(f"tp: {label}: {n_requests} requests, {n_tok} tokens in "
                f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s overall), "
                f"{steps} decode dispatches, {chunks} prefill chunks; "
                f"launches {counts} on {card}")
            if sum(t.graphs_captured for t in tiers) != cap0:
                raise AssertionError(f"{label}: graphs captured mid-traffic")
            if want is not None:
                expect = want(steps, chunks)
                if counts != expect:
                    raise AssertionError(f"{label}: launches {counts}, "
                                         f"expected {expect}")
            return done, counts, calls, steps, chunks

        def mesh_serve(label, eng, tiers, forwards, want=None):
            done, counts, calls, steps, chunks = serve(label, eng, tiers,
                                                       want)
            fwd = forwards(steps, chunks)
            log(f"tp: {label}: the tp group ran {calls} collectives over "
                f"{fwd} forwards: {calls / fwd:.2f} per forward (2 n_layers "
                f"+ 2 = {per_forward}: the embedding's sum, the attention "
                f"output's and the MLP's sums per layer, the logits' "
                f"gather)")
            if calls != per_forward * fwd:
                raise AssertionError(f"{label}: {calls} collectives for "
                                     f"{fwd} forwards")
            for n, v in counts.items():
                total[n] += v
            return done

        def decode_bench(label, eng):
            """A full batch decoding: tokens/s, then device ms per 8 decode
            steps under the profiler, and its communication kernels."""
            eng.admit_prompts(bench, max_new_tokens=4 * bench_steps)
            sync()
            t = time.perf_counter()
            eng.run(bench_steps)
            sync()
            s = time.perf_counter() - t
            tps = batch * bench_steps / s
            log(f"tp: {label}: decode {tps:.1f} tokens/s (batch {batch}, "
                f"prompts of {bench_len}, run({bench_steps}) in "
                f"{s * 1e3:.1f} ms) on {card}")
            out = {"tokens_per_s": tps, "ms_per_step": s * 1e3 / bench_steps}
            if on_cuda:
                ms = profile_window(f"tp decode ({label})", lambda: eng.run(8),
                                    s * 1e3 / bench_steps * 8, card,
                                    ("paged_partial", "w8a16", "nccl",
                                     "Memcpy", "memcpy"))
                out.update(device_ms_per_8=ms["busy_ms"],
                           kernels_per_8=ms["count"],
                           nccl=ms["launches"]["nccl"],
                           memcpy=ms["launches"]["Memcpy"]
                           + ms["launches"]["memcpy"])
                log(f"tp: {label}: device {ms['busy_ms']:.3f} ms per 8 "
                    f"decode steps in {ms['count']} kernels; kernels named "
                    f"nccl: {out['nccl']}, memory copies: {out['memcpy']} "
                    f"on {card}")
            return out

        # int8 weights over a bf16 pool (phase 7's defaults), with and
        # without the mesh; the decode windows of both.
        eng, tiers = build("int8 weights, mesh", mesh, quant="int8")
        greedy = mesh_serve(
            "int8 weights, mesh", eng, tiers, lambda s, c: s + c,
            lambda s, c: paged_launches(cfg, False, "int8", s, c, on_cuda))
        with_mesh = decode_bench("int8 weights, mesh", eng)
        del eng, tiers
        eng, tiers = build("int8 weights, no mesh", None, quant="int8")
        plain, *_ = serve("int8 weights, no mesh", eng, tiers)
        without = decode_bench("int8 weights, no mesh", eng)
        del eng, tiers
        if greedy != plain:
            bad = [r for r in greedy if greedy[r] != plain[r]]
            raise AssertionError(f"mesh and no mesh differ at rids {bad}")
        log(f"tp: int8 weights: the mesh engine's tokens equal mesh=None's "
            f"rid for rid, bitwise ({n_requests} requests)")
        log(f"tp: decode with the mesh / without: "
            f"{with_mesh['tokens_per_s']:.1f} / "
            f"{without['tokens_per_s']:.1f} tokens/s"
            + (f", device {with_mesh['device_ms_per_8']:.3f} / "
               f"{without['device_ms_per_8']:.3f} ms per 8 steps, memory "
               f"copies per 8 steps {with_mesh['memcpy']} / "
               f"{without['memcpy']}" if on_cuda else "") + f" on {card}")
        emit14("decode", with_mesh=with_mesh, without_mesh=without,
               card=card)

        # The engine's default bf16 weights over an int8 pool.
        eng, tiers = build("bf16 weights, int8 KV, mesh", mesh,
                           kv_quant="int8")
        q8 = mesh_serve(
            "bf16 weights, int8 KV, mesh", eng, tiers, lambda s, c: s + c,
            lambda s, c: paged_launches(cfg, True, "bf16", s, c, on_cuda))
        del eng, tiers
        eng, tiers = build("bf16 weights, int8 KV, no mesh", None,
                           kv_quant="int8")
        q8_plain, *_ = serve("bf16 weights, int8 KV, no mesh", eng, tiers)
        del eng, tiers
        if q8 != q8_plain:
            raise AssertionError("int8 KV: mesh and no mesh differ")
        log("tp: bf16 weights, int8 KV: the mesh engine's tokens equal "
            "mesh=None's rid for rid, bitwise")

        # Spec self-draft and the disaggregated pair under the mesh.
        k = SPEC_K
        eng, tiers = build("spec self-draft, mesh", mesh, quant="int8",
                           spec_decode=True, spec_k=k, draft_params="self")
        spec = mesh_serve(
            "spec self-draft, mesh", eng, tiers,
            lambda s, c: (k + 1) * s + c,
            lambda s, c: spec_launches(cfg, None, "self", False, k, s, c)
            if on_cuda else dict.fromkeys(SPEC_WRAPPERS, 0))
        stats = eng.spec_stats()
        del eng, tiers
        if spec != greedy:
            raise AssertionError("spec self-draft under the mesh differs "
                                 "from greedy under it")
        log(f"tp: spec self-draft (k = {k}) under the mesh equals greedy "
            f"under the mesh rid for rid; {stats['accepted_per_dispatch']:.2f}"
            f" tokens per row and dispatch")
        eng, tiers = build("disaggregated pair, mesh", mesh, quant="int8",
                           pair=True)
        pair = mesh_serve(
            "disaggregated pair, mesh", eng, tiers, lambda s, c: s + c,
            lambda s, c: paged_launches(cfg, False, "int8", s, c, on_cuda))
        pre_w, dec_w = (t.params["layers"]["wq"] for t in tiers)
        if pre_w.q.data_ptr() != dec_w.q.data_ptr():
            raise AssertionError("the pair's tiers hold two weight copies")
        del eng, tiers
        if pair != greedy:
            raise AssertionError("the pair under the mesh differs from mono "
                                 "under it")
        log("tp: the disaggregated pair under the mesh equals the mono "
            "engine under it rid for rid")
        emit14("mesh_serve", requests=n_requests, tokens_equal=True,
               collectives_per_forward=per_forward, launches=total,
               card=card)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(path, ignore_errors=True)
    return total


def shard_widths(model: str, tp: int) -> dict:
    """One rank's widths of ``model`` under ``tp``: heads, kv heads, d_ff
    and vocab divided, d_model and head_dim whole."""
    from grove_tpu_torch.models.llama import CONFIGS
    cfg = CONFIGS[model]
    for n in (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size):
        if n % tp:
            raise AssertionError(f"{model}: {n} does not divide over {tp}")
    return {"h": cfg.n_heads // tp, "n_kv": cfg.n_kv_heads // tp,
            "ff": cfg.d_ff // tp, "vocab": cfg.vocab_size // tp,
            "d": cfg.d_model, "hd": cfg.head_dim,
            "max_seq_len": cfg.max_seq_len, "rope_theta": cfg.rope_theta}


def bf16_ulps(got, want) -> float:
    """The largest |got - want| over the values, in units of one bf16 ulp
    of ``want``'s value: 2^(e - 7) for |want| in [2^e, 2^(e + 1)), the
    ulp of the smallest normal below that."""
    import torch
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)            # want = m * 2^e, |m| in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(want), e.clamp(min=-125) - 8)
    return ((got - want).abs() / ulp).max().item()


# Draws of the inputs of each norm check at shard widths: the bound of one
# output ulp per value has to hold on every one.
TP_NORM_DRAWS = 4


def phase_tp_kernels(seed: int, card: str) -> list[dict]:
    """Each kernel of the paged path at one rank's widths of TP_SHARDS,
    against its plain version at phase 3's tolerances, timed beside its
    bound: paged decode and chunk attention over bf16 and int8 pools at
    phase 3's serving shapes, the fused rope + KV write into both pools
    (bitwise), the GEMM's int8 and bf16-weight builds at the five
    launches of a forward at M = 32 with their rows bitwise across M (and
    slabs), and rms_norm / add_rms_norm where d differs from phase 3's
    (llama-70b's 8,192), within one bf16 ulp of each value over
    TP_NORM_DRAWS draws. Returns the JSON records."""
    import numpy as np
    import torch
    from grove_tpu_torch.models.llama import CONFIGS, _rope
    from grove_tpu_torch.ops import kvquant, norms
    from grove_tpu_torch.ops.paged import (paged_chunk_attention,
                                           paged_chunk_attention_q8,
                                           paged_chunk_attention_ref,
                                           paged_decode_attention,
                                           paged_decode_attention_q8,
                                           paged_decode_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    rng = np.random.default_rng(seed + 29)
    records = []

    def record(model, tp, kernel, shape, err, t):
        rec = {"model": model, "tp": tp, "kernel": kernel, "shape": shape,
               "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "card": card}
        records.append(rec)
        emit14("shard_kernel", **rec)

    for model, tp in TP_SHARDS:
        w = shard_widths(model, tp)
        h, n_kv, hd, d = w["h"], w["n_kv"], w["hd"], w["d"]
        tag = (f"{model} tp={tp} (h {h}, n_kv {n_kv}, d_ff {w['ff']}, "
               f"vocab {w['vocab']}, group {h // n_kv})")
        dtype = torch.bfloat16
        # Attention, decode and chunk, bf16 and int8 pools.
        B, W, lo, hi = SERVE_DECODE
        lengths = rng.integers(lo, hi + 1, size=B).astype(np.int32)
        lens = torch.from_numpy(lengths).cuda()
        total = int(lengths.sum())
        q = torch.randn((B, 1, h, hd), generator=gen, device="cuda").to(dtype)
        off, c = SERVE_CHUNK_OFFSET, PAGED_CHUNK
        qc = torch.randn((1, c, h, hd), generator=gen, device="cuda").to(dtype)
        offs = torch.full((1,), off, dtype=torch.int32, device="cuda")
        pairs = h * sum(off + i + 1 for i in range(c))
        for int8 in (False, True):
            kind = "int8" if int8 else "bf16"
            if int8:
                kq, vq, ks, vs, tables = int8_pools(gen, lengths, W, n_kv, hd)
                dec = (lambda: paged_decode_attention_q8(
                    q, kq, vq, ks, vs, tables, lens))
                dec_ref = (lambda: paged_decode_attention_ref(
                    q, kq, vq, tables, lens, ks, vs))
            else:
                k, v, tables = paged_pools(gen, lengths, W, n_kv, hd, dtype)
                dec = lambda: paged_decode_attention(q, k, v, tables, lens)
                dec_ref = (lambda: paged_decode_attention_ref(
                    q, k, v, tables, lens))
            label = (f"tp shard {tag}: paged decode B={B} W={W} {kind} pool")
            err = check_paged(dec(), dec_ref(), label, "bfloat16")
            t = time_paged(label, dec, dec_ref, None, paged_bound_ms(
                total, B, h * total, n_kv, h, hd, dtype, int8), card)
            record(model, tp, "paged_decode_attention" + ("_q8" if int8
                                                           else ""),
                   f"B={B} W={W} lengths {lo}..{hi} h={h} n_kv={n_kv}",
                   err, t)
            if int8:
                kq, vq, ks, vs, ctab = int8_pools(gen, [off + c], W, n_kv, hd)
                ch = (lambda: paged_chunk_attention_q8(
                    qc, kq, vq, ks, vs, ctab, offs))
                ch_ref = (lambda: paged_chunk_attention_ref(
                    qc, kq, vq, ctab, offs, ks, vs))
            else:
                k, v, ctab = paged_pools(gen, [off + c], W, n_kv, hd, dtype)
                ch = lambda: paged_chunk_attention(qc, k, v, ctab, offs)
                ch_ref = (lambda: paged_chunk_attention_ref(
                    qc, k, v, ctab, offs))
            label = (f"tp shard {tag}: paged chunk b=1 c={c} offset={off} "
                     f"W={W} {kind} pool")
            err = check_paged(ch(), ch_ref(), label, "bfloat16")
            t = time_paged(label, ch, ch_ref, None, paged_bound_ms(
                off + c, c, pairs, n_kv, h, hd, dtype, int8), card)
            record(model, tp, "paged_chunk_attention" + ("_q8" if int8
                                                          else ""),
                   f"b=1 c={c} offset={off} h={h} n_kv={n_kv}", err, t)
        # The fused rope + KV write, decode and chunk shapes, both pools:
        # bitwise against its plain version.
        cos, sin = _rope(w["max_seq_len"], hd, w["rope_theta"],
                         torch.device("cuda"))
        _, _, dtab = paged_pools(gen, lengths + 1, W, 1, 8, torch.float32)
        pos = lens[:, None]
        _, _, ctab = paged_pools(gen, [off + c], W, 1, 8, torch.float32)
        steps = torch.arange(c, dtype=torch.int32, device="cuda")
        for shape, b, s, tab, p, ok in (
                ("decode", B, 1, dtab, pos, None),
                ("chunk", 1, c, ctab, (off + steps)[None],
                 (steps < c)[None])):
            nb = int(tab.max().item()) + 1
            qr = torch.randn((b, s, h, hd), generator=gen,
                             device="cuda").to(dtype)
            kr, vr = (torch.randn((b, s, n_kv, hd), generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            for int8 in (False, True):
                if int8:
                    ps = [torch.randint(-127, 128, (nb, PAGED_BS, n_kv, hd),
                                        generator=gen, device="cuda",
                                        dtype=torch.int8) for _ in range(2)]
                    ps += [torch.rand((nb, PAGED_BS, n_kv), generator=gen,
                                      device="cuda") for _ in range(2)]
                    call = kvquant.paged_rope_scatter_q
                    scales = ps[2:]
                else:
                    ps = [torch.randn((nb, PAGED_BS, n_kv, hd), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(2)]
                    call = kvquant.paged_rope_scatter
                    scales = [None, None]
                ref = [x.clone() for x in ps]
                got = call(*ps, qr, kr, vr, cos, sin, tab, p, ok)
                want = kvquant.paged_rope_scatter_ref(
                    ref[0], ref[1], *(ref[2:] if int8 else scales), qr, kr,
                    vr, cos, sin, tab, p, ok)
                torch.cuda.synchronize()
                same = torch.equal(got, want) and all(
                    torch.equal(a, b_) for a, b_ in zip(ps, ref))
                label = (f"tp shard {tag}: {call.__name__} {shape} b={b} "
                         f"s={s}")
                log(f"kernels: {label}: q, pools"
                    f"{' and scales' if int8 else ''} "
                    f"{'bitwise equal' if same else 'DIFFER'} to the plain "
                    f"version")
                if not same:
                    raise AssertionError(f"{label} disagrees")
                t = time_paged(
                    label, lambda: call(*ps, qr, kr, vr, cos, sin, tab, p,
                                        ok),
                    lambda: kvquant.paged_rope_scatter_ref(
                        ps[0], ps[1], *(ps[2:] if int8 else scales), qr, kr,
                        vr, cos, sin, tab, p, ok), None,
                    rope_scatter_bound_ms(b * s, h, n_kv, hd, 2, int8,
                                          ok is not None), card)
                record(model, tp, call.__name__,
                       f"{shape} b={b} s={s} h={h} n_kv={n_kv}", 0.0, t)
        # The GEMMs: the five launches of a forward at one rank's widths.
        launches = (("wq, wk, wv", d, (h * hd, n_kv * hd, n_kv * hd),
                     torch.bfloat16),
                    ("wo", h * hd, (d,), torch.bfloat16),
                    ("w_gate, w_up", d, (w["ff"], w["ff"]), torch.bfloat16),
                    ("w_down", w["ff"], (d,), torch.bfloat16),
                    ("lm_head", d, (w["vocab"],), torch.float32))
        forward = {"w8a16_matmul": 0.0, "dense_matmul": 0.0}
        for name, K, ns, out in launches:
            label = f"tp shard {tag}: {name}"
            per = 1 if name == "lm_head" else CONFIGS[model].n_layers
            t = time_w8a16(gen, W8A16_M, K, ns, out, label, card)
            record(model, tp, "w8a16_matmul", f"{name} M={W8A16_M} K={K} "
                   f"N={list(ns)}", t["err"], t)
            forward["w8a16_matmul"] += per * t["ms"]
            check_w8a16_rows(gen, K, ns, out, label)
            t = time_dense(gen, W8A16_M, K, ns, out, label)
            forward["dense_matmul"] += per * t["ms"]
            log(f"kernels: dense {label} M={W8A16_M} K={K} N={list(ns)}: "
                f"ms={t['ms']} plain_ms={t['plain_ms']} library_ms="
                f"{t['library_ms']} bound_ms={t['bound_ms']} "
                f"({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.1f}% "
                f"of it) on {card}")
            record(model, tp, "dense_matmul", f"{name} M={W8A16_M} K={K} "
                   f"N={list(ns)}", t["err"], t)
            dense_rows_and_slabs(gen, K, ns, out, label)
        log(f"kernels: tp shard {tag}: the GEMM's launches of one forward "
            f"({CONFIGS[model].n_layers} layers' four and the head) at "
            f"M={W8A16_M}: int8 weights {forward['w8a16_matmul']:.4f} ms, "
            f"bf16 weights {forward['dense_matmul']:.4f} ms on {card}")
        emit14("shard_forward", model=model, tp=tp, m=W8A16_M,
               layers=CONFIGS[model].n_layers, **forward, card=card)
        if d != 2048:  # llama-1b's d: phase 3 holds the norms there
            # bf16 out: the kernel and its plain version both round an f32
            # result summed in another order, so each value may be one
            # output ulp apart and no more.
            def draw():
                return ((torch.randn((W8A16_M, d), generator=gen,
                                     device="cuda") * 3).to(dtype),
                        torch.randn((W8A16_M, d), generator=gen,
                                    device="cuda").to(dtype),
                        (1 + 0.1 * torch.randn((d,), generator=gen,
                                               device="cuda")).to(dtype))

            draws = [draw() for _ in range(TP_NORM_DRAWS)]
            for kernel, fn, ref, bound in (
                    ("rms_norm", lambda x, dl, wt: norms.rms_norm(x, wt),
                     lambda x, dl, wt: norms.rms_norm_ref(x, wt),
                     (2 * W8A16_M * d * 2 + d * 2) / HBM_BYTES_PER_S * 1e3),
                    ("add_rms_norm",
                     lambda x, dl, wt: norms.add_rms_norm(x, dl, wt)[1],
                     lambda x, dl, wt: norms.add_rms_norm_ref(x, dl, wt)[1],
                     add_norm_bound_ms(W8A16_M, d, 2))):
                err = ulps = 0.0
                for args in draws:
                    got, want = fn(*args), ref(*args)
                    err = max(err, (got.float() - want.float()).abs()
                              .max().item())
                    ulps = max(ulps, bf16_ulps(got, want))
                ok = ulps <= 1.0
                log(f"kernels: tp shard {tag}: {kernel} rows={W8A16_M} d={d} "
                    f"over {TP_NORM_DRAWS} draws: max_abs_err={err:.3e}, "
                    f"at most {ulps:.3f} bf16 ulp of a value (bound 1) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kernel} disagrees at d={d}")
                t = {"ms": time_ms(lambda: fn(*draws[0])),
                     "plain_ms": time_ms(lambda: ref(*draws[0])),
                     "bound_ms": bound, "bound_by": "bytes"}
                record(model, tp, kernel, f"rows={W8A16_M} d={d}", err, t)
        torch.cuda.empty_cache()
    return records


def phase_tp_lanes(seed: int, card: str, cfg=None, device: str = "cuda",
                   batch: int = 8, prompt_len: int = 128,
                   steps: int = 16) -> int:
    """The lanes model functions under tp over a one-rank group (NCCL on
    the card, gloo for the CPU rehearsal): llama-1b's ``llama.prefill`` of
    ``batch`` ragged prompts right-padded to ``prompt_len`` (the flash path
    at 128) and ``steps`` greedy ``decode_step``s with ``tp=`` the group's
    tp comm, against ``tp=None`` on the same params and prompts: every
    logit and token bitwise, 2 n_layers + 2 collectives per forward by the
    group's count. Returns the flash launches of the tp run (zeroed just
    before it, read just after)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.ops.flash import flash_causal_attention
    from grove_tpu_torch.ops.kvcache import KVCache
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh

    cfg = cfg or llama.CONFIGS["llama-1b"]
    on_cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed + 41)
    params = llama.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(seed + 41)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    lengths = torch.from_numpy(rng.integers(
        prompt_len // 2, prompt_len + 1, batch).astype(np.int32)).to(device)

    def run(tp):
        with torch.no_grad():
            cache = KVCache.create(cfg.n_layers, batch, prompt_len + steps,
                                   cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                                   device)
            logits, cache = llama.prefill(cfg, params, prompts, cache,
                                          lengths, tp=tp)
            outs, toks = [logits], []
            for _ in range(steps):
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(tok)
                logits, cache = llama.decode_step(cfg, params, tok, cache,
                                                  tp=tp)
                outs.append(logits)
        return torch.stack(outs), torch.stack(toks)

    path = one_rank_group(device)
    try:
        mesh = build_mesh(MeshPlan())
        comm = mesh.comm("tp")
        want_logits, want_toks = run(None)
        flash_causal_attention.launches = 0
        comm.launches = 0
        t0 = time.perf_counter()
        got_logits, got_toks = run(comm)
        if on_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flash = flash_causal_attention.launches
        calls = comm.launches
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(path, ignore_errors=True)
    per_forward = 2 * cfg.n_layers + 2
    same = (torch.equal(got_logits, want_logits)
            and torch.equal(got_toks, want_toks))
    want_flash = cfg.n_layers if on_cuda else 0
    log(f"tp: lanes prefill ({batch} x {prompt_len}, ragged) + {steps} "
        f"decode steps with tp= the one-rank {backend} group: logits and "
        f"tokens bitwise tp=None's {same}; {calls} collectives over "
        f"{steps + 1} forwards (expected {per_forward * (steps + 1)}); flash "
        f"launches {flash} (expected {want_flash}); {wall:.3f} s on {card}")
    emit14("lanes_tp", batch=batch, prompt_len=prompt_len, steps=steps,
           bitwise=same, collectives=calls, flash_launches=flash,
           seconds=wall, card=card)
    if not same or calls != per_forward * (steps + 1) or flash != want_flash:
        raise AssertionError("the lanes functions under tp failed a check")
    return flash


# One rank's head counts of llama-1b's flash prefill: tp = 2, 4 and 8 at
# b = 32 and s = 128 (the serving shape) and 2,048.
TP_FLASH = (2, 4, 8)
TP_FLASH_SEQ = (128, 2048)


def phase_tp_flash(seed: int, card: str, b: int = 32) -> list[dict]:
    """The flash kernel at one rank's head counts of llama-1b under tp
    (h / n_kv = 8 / 4, 4 / 2, 2 / 1), against its plain version, timed
    beside its bound and ``scaled_dot_product_attention``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    records = []
    for tp in TP_FLASH:
        w = shard_widths("llama-1b", tp)
        for s in TP_FLASH_SEQ:
            q, k, v = qkv(gen, b, s, w["h"], w["n_kv"], w["hd"],
                          torch.bfloat16)
            label = (f"llama-1b tp={tp} b={b} s={s} h={w['h']} "
                     f"n_kv={w['n_kv']} d={w['hd']}")
            err = check_flash(q, k, v, label, "bfloat16")
            t = time_flash(q, k, v, f"flash {label}", card)
            rec = {"model": "llama-1b", "tp": tp, "kernel": "flash",
                   "shape": [b, s, w["h"], w["n_kv"], w["hd"]],
                   "max_abs_err": err, **t, "card": card}
            records.append(rec)
            emit14("shard_flash", **rec)
            del q, k, v
            torch.cuda.empty_cache()
    return records


def check_worker_twin(card: str) -> None:
    """samples/workloads/allreduce_worker_torch.py as a world of one on the
    card: NCCL, result 1.0, published atomically."""
    import shutil
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tempfile.mkdtemp(prefix="grove-worker-")
    try:
        env = dict(os.environ, TPU_WORKER_ID="0",
                   TPU_WORKER_HOSTNAMES="localhost",
                   GROVE_COORD_HOST="127.0.0.1", GROVE_COORD_PORT=str(port),
                   GROVE_OUT_DIR=out, GROVE_HOLD_SECONDS="0")
        worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "samples", "workloads",
                              "allreduce_worker_torch.py")
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, worker], env=env,
                              capture_output=True, text=True, timeout=180)
        wall = time.perf_counter() - t
        result = None
        path = os.path.join(out, "result-0.txt")
        if os.path.exists(path):
            with open(path) as f:
                result = f.read().strip()
        log(f"tp: worker twin: rc {proc.returncode}, result {result}, "
            f"{wall:.1f} s; stdout: {proc.stdout.strip()[-200:]}")
        if proc.returncode != 0 or result != "1.0" or \
                "(nccl): all_reduce = 1.0" not in proc.stdout:
            raise AssertionError(f"the worker twin failed: "
                                 f"{proc.stderr.strip()[-2000:]}")
        emit14("worker_twin", backend="nccl", result=float(result),
               seconds=wall, card=card)
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ---- checkpoints of a tensor-parallel engine (phase 14) ----

# The kernels a restored int8-weight paged engine over a bf16 pool serves
# through.
TP_RESTART_KERNELS = ("paged_decode_attention", "paged_chunk_attention",
                      "paged_rope_scatter", "w8a16_matmul", "rms_norm",
                      "add_rms_norm")

def tp_save_rank(rank: int, world: int, root: str, seed: int,
                 model: str) -> None:
    """One rank of the CPU gloo world that writes phase 14's tp step: the
    model's params from a CPU generator seeded with ``seed``, a paged
    engine on them with int8 weights under ``MeshPlan(tp=world)`` on the
    CPU, and ``save_engine`` into ``root/ckpt``, collectively. Prints one
    JSON line: the rank's save seconds and the bytes of its slices."""
    import datetime

    import torch
    import torch.distributed as dist
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from grove_tpu_torch.serving import checkpoint as ckpt
    from grove_tpu_torch.serving.engine import PagedDecodeEngine
    from grove_tpu_torch.serving.quant import params_bytes

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (world + 1)))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(root, 'pg')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=600))
    try:
        mesh = build_mesh(MeshPlan(tp=world))
        cfg = CONFIGS[model]
        params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        eng = PagedDecodeEngine(cfg, params, mesh=mesh, quant="int8",
                                device="cpu", batch=1, max_len=256,
                                xprof=False, reqtrace=False)
        del params
        t0 = time.perf_counter()
        step = ckpt.save_engine(os.path.join(root, "ckpt"), eng)
        print(json.dumps({"rank": rank, "step": step,
                          "save_s": time.perf_counter() - t0,
                          "bytes": params_bytes(eng.params)}), flush=True)
        dist.barrier()      # no rank tears the group down under another
    finally:
        dist.destroy_process_group()


def tp_save_world(root: str, world: int, seed: int, model: str):
    """Start ``tp_save_rank``'s ranks as processes on the CPU (no card
    visible to them); returns a function that waits for them and returns
    their JSON lines, raising with their errors if any rank failed."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    for r in range(world):
        out = open(os.path.join(root, f"rank{r}.out"), "w+")
        err = open(os.path.join(root, f"rank{r}.err"), "w+")
        code = (f"import chip_smoke; chip_smoke.tp_save_rank({r}, {world}, "
                f"{root!r}, {seed}, {model!r})")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       cwd=here, env=env, stdout=out,
                                       stderr=err), out, err))

    def wait(timeout: float = 600.0) -> list[dict]:
        deadline = time.perf_counter() + timeout
        lines, failed = [], []
        try:
            for r, (p, out, err) in enumerate(procs):
                try:
                    rc = p.wait(max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                out.seek(0)
                err.seek(0)
                text = out.read()
                if rc != 0 or not text.strip():
                    failed.append(f"rank {r}: rc {rc}\n"
                                  f"{err.read()[-3000:]}")
                else:
                    lines.append(json.loads(text.strip().splitlines()[-1]))
        finally:
            for p, out, err in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
                out.close()
                err.close()
        if failed:
            raise AssertionError("the CPU gloo world's save failed:\n"
                                 + "\n".join(failed))
        return lines

    return wait


def phase_tp_checkpoint(seed: int, card: str, cfg=None, model: str =
                        "llama-1b", device: str = "cuda", world: int = 2,
                        n_requests: int = 8, prompt_lo: int = 32,
                        prompt_hi: int = 128, new_tokens: int = 16,
                        max_len: int = 256) -> dict[str, int]:
    """Checkpoints of a tensor-parallel engine. (1) A ``world``-rank gloo
    world on the CPU (``tp_save_world``) writes an int8-weight step of
    ``model`` (CPU-seeded weights) with ``save_engine``: ``rank{r}.pt`` per
    rank. Meanwhile an engine is built here on the same weights, quantized
    on the CPU as the ranks quantize them (the reference). The step's whole
    tree (``load_params`` without ``like``) is bitwise the reference's
    params, and restores (``warm_restart``) into a plain engine and a
    one-rank mesh engine (NCCL) on other weights, whose tokens are then
    the reference's, bitwise. (2) A -> B -> A into a live one-rank mesh
    engine (``restart_case``). The save and load rates are printed beside
    phase 13's. Returns the kernels' launches over the restored engines'
    serves, the counts zeroed just before them."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from grove_tpu_torch.serving import checkpoint as ckpt
    from grove_tpu_torch.serving.engine import make_engine
    from grove_tpu_torch.serving.quant import params_bytes

    cfg = cfg or CONFIGS[model]
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wrappers = kernel_wrappers()
    root = tempfile.mkdtemp(prefix="grove-tpckpt-")
    t0 = time.perf_counter()
    wait = tp_save_world(root, world, seed + 61, model)
    rng = np.random.default_rng(seed + 61)
    traffic = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(prompt_lo, prompt_hi + 1,
                                     size=n_requests)]
    kw = dict(mode="paged", batch=8, max_len=max_len, quant="int8",
              device=device)

    def serve(eng) -> list[list[int]]:
        n0 = len(eng.completed)
        for p in traffic:
            eng.submit(p, max_new_tokens=new_tokens)
        drive_paged(eng, n0 + len(traffic))
        return [list(r.generated)
                for r in sorted(eng.completed[n0:], key=lambda r: r.rid)]

    try:
        host = init_params(cfg, torch.Generator().manual_seed(seed + 61),
                           "cpu")
        ref = make_engine(cfg, host, **kw)
        del host
        want = serve(ref)
        ref_leaves = dict(_leaves(ref.params))
        del ref
        ranks = wait()
        world_s = time.perf_counter() - t0
        step_dir = ranks[0]["step"]
        path, step = os.path.dirname(step_dir), int(os.path.basename(
            step_dir))
        files = sorted(os.listdir(step_dir))
        nbytes = sum(r["bytes"] for r in ranks)
        save_s = max(r["save_s"] for r in ranks)
        t = time.perf_counter()
        whole = ckpt.load_params(path, step, device=device)
        sync()
        load_s = time.perf_counter() - t
        got = dict(_leaves(whole))
        del whole
        bitwise = list(got) == list(ref_leaves) and all(
            got[k].dtype == v.dtype and torch.equal(got[k], v)
            for k, v in ref_leaves.items())
        del got
        if not bitwise or files != sorted(
                ["manifest.json"] + [f"rank{r}.pt" for r in range(world)]):
            raise AssertionError(f"the tp step {step_dir} ({files}) is not "
                                 "the reference's params bitwise")
        other = init_params(cfg, torch.Generator(device).manual_seed(
            seed + 62), device)
        for w in wrappers.values():
            w.launches = 0
        restored, restart_s = {}, {}
        eng = make_engine(cfg, other, **kw)
        t = time.perf_counter()
        ckpt.warm_restart(path, eng, step=step)
        sync()
        restart_s["plain"] = time.perf_counter() - t
        restored["plain"] = serve(eng)
        del eng
        group = one_rank_group(device)
        try:
            mesh = build_mesh(MeshPlan())
            eng = make_engine(cfg, other, mesh=mesh, **kw)
            t = time.perf_counter()
            ckpt.warm_restart(path, eng, step=step)
            sync()
            restart_s["mesh"] = time.perf_counter() - t
            restored["mesh"] = serve(eng)
            del eng
            launches = {n: w.launches for n, w in wrappers.items()}
            # A -> B -> A into a live mesh engine.
            a = init_params(cfg, torch.Generator(device).manual_seed(
                seed + 63), device)
            emit14("warm_restart", **restart_case(
                "paged, int8 weights, one-rank mesh", cfg, a, other, device,
                card, rng, {k: v for k, v in kw.items() if k != "device"}
                | {"mesh": mesh}, os.path.join(root, "aba"), n_requests,
                prompt_lo, prompt_hi, new_tokens))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(group, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fields = {"model": model, "world": world, "files": files,
              "bytes": nbytes, "whole_tree_bitwise": bitwise,
              "world_wall_s": world_s, "save_s": save_s,
              "save_gb_per_s": nbytes / save_s / 1e9,
              "load_whole_s": load_s,
              "load_whole_gb_per_s": nbytes / load_s / 1e9,
              "warm_restart_s": restart_s,
              "warm_restart_gb_per_s": {k: nbytes / v / 1e9
                                        for k, v in restart_s.items()},
              "phase13_gb_per_s": dict(ROUNDTRIP_GB_PER_S),
              "restored_equals_reference": {k: v == want
                                            for k, v in restored.items()},
              "card": card}
    emit14("tp_checkpoint", **fields)
    log(f"tp checkpoint: {world}-rank CPU save of {nbytes / 1e9:.3f} GB "
        f"int8 {model} at {fields['save_gb_per_s']:.3f} GB/s (slowest "
        f"rank), whole-tree load to {device} at "
        f"{fields['load_whole_gb_per_s']:.3f} GB/s, warm restarts "
        + ", ".join(f"{k} {v:.3f} GB/s" for k, v in
                    fields["warm_restart_gb_per_s"].items())
        + f"; phase 13's one-card save / load: "
        + (f"{ROUNDTRIP_GB_PER_S['save']:.3f} / "
           f"{ROUNDTRIP_GB_PER_S['load']:.3f} GB/s"
           if ROUNDTRIP_GB_PER_S else "not run") + f" on {card}")
    if not all(fields["restored_equals_reference"].values()):
        raise AssertionError(f"a restored engine's tokens differ from the "
                             f"reference's: {fields}")
    missing = [n for n in TP_RESTART_KERNELS if on_cuda and not launches[n]]
    if missing:
        raise AssertionError(f"the restored engines never launched "
                             f"{missing}")
    return launches


# ---- the in-pod serving worker twin (phase 16) ----

WARM_LINE = "engine warm (llama-1b), signalling ready"


def phase_serving_worker(card: str, model: str = "llama-1b",
                         seconds: float = 5.0, poll_s: float = 0.05,
                         slack_s: float = 1.0) -> None:
    """samples/workloads/serving_worker_torch.py as a subprocess on the card
    (``GROVE_SERVE_MODEL=model``, ``GROVE_SERVE_SECONDS=seconds``): the
    ready file is absent at every poll until ``slack_s`` before the warm
    line is read (the line reaches this process through a pipe and a
    thread; the worker writes the file right after printing it), and it
    appears after; ``served N decode steps`` with N > 0; the graphs
    captured before ready equal those after serving (2: the single step and
    the block), so nothing was captured in traffic."""
    import queue
    import re
    import shutil
    import tempfile
    import threading
    out = tempfile.mkdtemp(prefix="grove-serve-")
    ready = os.path.join(out, "ready")
    env = dict(os.environ, GROVE_SERVE_MODEL=model,
               GROVE_SERVE_SECONDS=str(seconds), GROVE_READY_FILE=ready,
               GROVE_POD_NAME="phase16")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "samples", "workloads", "serving_worker_torch.py")
    lines: queue.Queue = queue.Queue()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, worker], env=env, cwd=out,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def read() -> None:
        for line in proc.stdout:
            lines.put((time.perf_counter(), line.rstrip("\n")))
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        got, polls, seen, warm_t, ready_t = [], 0, None, None, None
        deadline = t0 + 300
        while time.perf_counter() < deadline:
            now, exists = time.perf_counter(), os.path.exists(ready)
            if warm_t is None:
                polls += 1
                if exists and seen is None:
                    seen = now
            elif exists and ready_t is None:
                ready_t = now
            try:
                item = lines.get(timeout=poll_s)
            except queue.Empty:
                continue
            if item is None:
                break
            got.append(item[1])
            if warm_t is None and WARM_LINE in item[1]:
                warm_t = item[0]
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        reader.join(10)
    try:
        if ready_t is None and os.path.exists(ready):
            ready_t = time.perf_counter()
        if seen is not None and ready_t is None:
            ready_t = seen
        early = warm_t is not None and seen is not None and \
            seen < warm_t - slack_s
        wall = time.perf_counter() - t0
        text = "\n".join(got)
        served = re.search(r"^served (\d+) decode steps$", text, re.M)
        before = re.search(r"(\d+) graphs captured before ready", text)
        after = re.search(r"(\d+) graphs captured after serving", text)
        n = int(served.group(1)) if served else 0
        fields = {"rc": rc, "warm_after_s": None if warm_t is None
                  else warm_t - t0, "polls_before_warm": polls,
                  "ready_early": early,
                  "ready_after_warm_s": None if None in (warm_t, ready_t)
                  else ready_t - warm_t, "served_steps": n,
                  "graphs_before_ready": before and int(before.group(1)),
                  "graphs_after_serving": after and int(after.group(1)),
                  "seconds": wall, "card": card}
        print(json.dumps({"phase": 16, "check": "serving_worker", **fields}),
              flush=True)
        log(f"worker: stdout: {text[-600:]}")
        if rc != 0 or warm_t is None or early or ready_t is None or n <= 0 \
                or fields["graphs_before_ready"] != 2 \
                or fields["graphs_after_serving"] != 2:
            raise AssertionError(f"the serving worker twin failed: {fields}"
                                 f"\n{err.strip()[-2000:]}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ---- the data-plane gates over the port (phase 17) ----

# The kernels phase 17's engines must launch between them: the paged
# path's attention and fused write (over both pools), the dense GEMM and
# the norms. (Their prompts, of at most 19 tokens, never take the flash
# kernel, which prefills lengths that are multiples of 128.)
GATE_KERNELS = ("paged_decode_attention", "paged_chunk_attention",
                "paged_decode_attention_q8", "paged_chunk_attention_q8",
                "paged_rope_scatter", "paged_rope_scatter_q",
                "dense_matmul", "rms_norm", "add_rms_norm")


def emit17(check: str, **fields) -> None:
    print(json.dumps({"phase": 17, "check": check, **fields}), flush=True)


def phase_gates(seed: int, card: str, model: str = "llama-1b",
                device: str = "cuda") -> dict[str, int]:
    """The data-plane gates that tools/decode_smoke.py and
    tools/chaos_soak.py hold the JAX engines to, over the port's engines
    at ``model``'s widths (64-token context), as the twins
    tools/decode_smoke_torch.py and tools/chaos_soak_torch.py run them,
    without the control plane:

    - the decode gate's four paged engines (prefix cache off and on,
      self-draft spec, int8 KV) and the lanes engine in f32, the JAX
      gate's precision (``decode_gate.run_mono``): the pinned build sets,
      every bucket a CUDA graph captured once, none in the steady state,
      greedy tokens equal to the lanes engine's, clean allocators;
    - the disaggregated pair in the model's dtype
      (``decode_gate.run_disagg``): each tier's pinned builds, tokens
      bitwise the mono engine's;
    - the prefill-replica kill (``chaos.run_prefill_replica_kill``): the
      decode tier's allocator clean through the kill, the rescued requests
      bitwise the mono engine's.

    Every kernel wrapper's count is zeroed just before and read just
    after. Returns the launches; raises if a kernel of ``GATE_KERNELS``
    launched in none of them (on the card)."""
    import dataclasses

    import torch

    from grove_tpu_torch.chaos import run_prefill_replica_kill
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.serving import decode_gate

    dev = torch.device(device)
    base = dataclasses.replace(llama.CONFIGS[model], max_seq_len=64)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    for run, dtype in ((decode_gate.run_mono, torch.float32),
                       (decode_gate.run_disagg, base.dtype)):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = llama.init_params(
            cfg, torch.Generator(dev).manual_seed(seed), dev)
        t0 = time.perf_counter()
        numbers = run(cfg, params, dev)
        emit17(run.__name__, model=model, dtype=str(dtype),
               seconds=time.perf_counter() - t0, card=card, **numbers)
        del params
    t0 = time.perf_counter()
    report = run_prefill_replica_kill(seed=seed, model=model, device=device)
    emit17("prefill_replica_kill", model=model,
           seconds=time.perf_counter() - t0, card=card, **report)
    launches = {n: w.launches for n, w in wrappers.items()}
    emit17("gate_launches", launches={n: v for n, v in launches.items()
                                      if v}, card=card)
    missing = [n for n in GATE_KERNELS
               if device == "cuda" and not launches.get(n)]
    if missing:
        raise AssertionError(f"the gates never launched {missing}")
    return launches


# ---- parallel training at one rank (phase 15) ----

# The training strategies phase 15 runs over the one-rank group: llama's
# loss_fn(mesh=) plain, with the ring and with Ulysses, and the pipeline at
# pp = 1 with two microbatches.
STRATEGIES = ("plain", "ring", "ulysses", "pipeline")


def emit15(check: str, **fields) -> None:
    """One phase-15 result as a JSON line."""
    print(json.dumps({"phase": 15, "check": check, **fields}), flush=True)


def gloo_mesh():
    """A mesh of this one process whose every axis runs over a gloo group
    beside the default group: the strategies' collectives on CPU tensors,
    the CPU side of the card-against-CPU checks."""
    import torch.distributed as dist
    from grove_tpu_torch.parallel.mesh import (MESH_AXES, AxisComm, Mesh,
                                               MeshPlan)
    group = dist.new_group([0], backend="gloo")
    return Mesh(MeshPlan(), 0, {a: AxisComm(group, 1, 0, [0])
                                for a in MESH_AXES})


def strategy_loss(strategy: str, mesh):
    """(params for the strategy, loss(cfg, params, tokens)): llama's
    ``loss_fn`` under ``mesh`` with the strategy's ``sp``, or the next-token
    loss of ``pipeline_forward`` (two microbatches) over the vocab-sharded
    logits."""
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                   stage_params)
    from grove_tpu_torch.parallel.sharding import shard_params
    if strategy == "pipeline":
        def loss(cfg, p, t):
            return llama.next_token_loss(
                pipeline_forward(cfg, p, t, mesh, n_microbatches=2), t,
                tp=mesh.comm("tp"))
        return (lambda p: stage_params(mesh, p)), loss
    sp = None if strategy == "plain" else strategy

    def loss(cfg, p, t):
        return llama.loss_fn(cfg, p, t, mesh=mesh, sp=sp)
    return (lambda p: shard_params(mesh, p)), loss


def ep_loss(ep, capacity_factor: float, kept: list | None = None):
    """The MoE loss through ``_ep_moe_block`` over the ep group ``ep`` (one
    rank: ``ep_forward`` asserts ep > 1, as JAX's does), with the
    load-balance auxiliary at 0.01."""
    from grove_tpu_torch.models import llama, moe

    def loss(cfg, p, t):
        logits, aux = moe._decoder_stack(
            cfg, p, t, lambda x, lp: moe._ep_moe_block(
                cfg, x, lp, capacity_factor, ep, kept), 0.0)
        return llama.next_token_loss(logits, t) + 0.01 * aux
    return loss


def grad_error(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-leaf error relative to the leaf's max norm, and its
    leaf."""
    worst, where = 0.0, ""
    for k, g in want.items():
        err = ((got[k].float() - g.float()).abs().max()
               / g.float().abs().max().clamp_min(1e-30)).item()
        if err >= worst:
            worst, where = err, k
    return worst, where


def parallel_parity(seed: int, device: str, dev_mesh, cpu_mesh) -> None:
    """test-tiny and moe-test-tiny in f32: each strategy on ``device`` over
    ``dev_mesh`` against the same strategy on the CPU over ``cpu_mesh``, on
    one numpy tree and one batch: the loss to 1e-5 relative, every
    gradient leaf to 1e-4 of its max norm (phase 13's f32 bounds)."""
    import dataclasses
    import numpy as np
    import torch
    from grove_tpu_torch.convert import params_from_numpy
    from grove_tpu_torch.models import llama, moe
    from grove_tpu_torch.serving.quant import flatten_params

    cases = []
    for strategy in STRATEGIES:
        cases.append(("llama", strategy, llama.CONFIGS["test-tiny"], llama,
                      lambda m, s=strategy: strategy_loss(s, m)))
    cases.append(("moe", "ep_block", moe.MOE_CONFIGS["moe-test-tiny"], moe,
                  lambda m: ((lambda p: p),
                             ep_loss(m.comm("ep"), 1.25))))
    for family, strategy, cfg, mod, make in cases:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        host = mod.init_params(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")
        tree = {k: ({n: w.numpy() for n, w in v.items()}
                    if isinstance(v, dict) else v.numpy())
                for k, v in host.items()}
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32)
        out = {}
        for dev, mesh in ((device, dev_mesh), ("cpu", cpu_mesh)):
            shard, loss = make(mesh)
            params = shard(params_from_numpy(tree, device=dev))
            leaves = flatten_params(params)[0]
            for t in leaves.values():
                t.requires_grad_(True)
            value = loss(cfg, params, torch.from_numpy(toks).to(dev))
            value.backward()
            out[dev] = (float(value.detach()),
                        {k: t.grad.detach().cpu() for k, t in leaves.items()})
        (l_dev, g_dev), (l_cpu, g_cpu) = out[device], out["cpu"]
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        grad_rel, leaf = grad_error(g_dev, g_cpu)
        fields = {"family": family, "strategy": strategy, "device": device,
                  "dtype": "float32", "loss_device": l_dev,
                  "loss_cpu": l_cpu, "loss_rel_diff": loss_rel,
                  "loss_tol": 1e-5, "grad_max_rel_diff": grad_rel,
                  "grad_worst_leaf": leaf, "grad_tol": 1e-4}
        emit15("parallel_parity", **fields)
        if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
            raise AssertionError(f"parallel parity {family} {strategy}: "
                                 f"{fields}")


def nccl_ms(label: str, fn, wall_ms: float, card: str) -> dict:
    """One more step under the profiler: the device ms and kernels of NCCL
    (all of them, and the send/recv ones alone), and the memory copies (at
    one rank NCCL moves data by copies, where it moves any)."""
    prof = profile_window(label, fn, wall_ms, card,
                          ("nccl", "SendRecv", "Memcpy"), top=6)
    return {"busy_ms": prof["busy_ms"], "kernels": prof["count"],
            "nccl_ms": prof["nccl"], "nccl_kernels": prof["launches"]["nccl"],
            "sendrecv_ms": prof["SendRecv"],
            "sendrecv_kernels": prof["launches"]["SendRecv"],
            "memcpy_ms": prof["Memcpy"],
            "memcpys": prof["launches"]["Memcpy"]}


def parallel_step(cfg, base: dict, toks, strategy: str, mesh, card: str,
                  on_cuda: bool, ref=None) -> dict:
    """One strategy's steps from a copy of ``base`` (see ``parallel_full``):
    its fields, and with ``ref`` None its loss and gradients under
    ``"ref"``."""
    import numpy as np
    import torch
    from grove_tpu_torch import train
    from grove_tpu_torch.models import llama

    if strategy == "mesh=None":
        shard, loss = (lambda p: p), llama.loss_fn
    else:
        shard, loss = strategy_loss(strategy, mesh)
    params = shard({k: ({n: w.clone() for n, w in v.items()}
                        if isinstance(v, dict) else v.clone())
                    for k, v in base.items()})
    opt = train.make_optimizer(params)
    before = {a: c.launches for a, c in mesh.comms.items()}
    loss0 = float(train.train_step(cfg, params, opt, toks, loss=loss))
    fields = {"strategy": strategy, "loss": loss0,
              "collectives": {a: c.launches - before[a]
                              for a, c in mesh.comms.items()
                              if c.launches != before[a]}}
    grads = {k: t.grad for k, t in _leaves(params)}
    fields["finite"] = bool(np.isfinite(loss0)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    if ref is None:
        fields["ref"] = (loss0, {k: g.clone() for k, g in grads.items()})
    else:
        err, leaf = grad_error(grads, ref[1])
        fields.update(loss_rel_diff=abs(loss0 - ref[0]) / abs(ref[0]),
                      loss_tol=1e-2, grad_max_rel_diff=err,
                      grad_worst_leaf=leaf, grad_tol=5e-2)
    del grads
    if on_cuda:
        tokens = toks.numel()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        train.train_step(cfg, params, opt, toks, loss=loss)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1])
        fields.update(
            step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
            peak_bytes=torch.cuda.max_memory_allocated(),
            profile=nccl_ms(f"llama-1b train step, {strategy}",
                            lambda: train.train_step(cfg, params, opt, toks,
                                                     loss=loss),
                            step_ms, card))
    return fields


def parallel_full(cfg, seed: int, device: str, batch: int, seq: int,
                  card: str, mesh) -> None:
    """llama-1b (bf16) at full width and depth: one train step (AdamW) of
    each strategy over the one-rank group and of ``mesh=None``, from the
    same params on one batch of ``batch`` x ``seq`` tokens. Each strategy's
    loss and first-step gradients against ``mesh=None``'s (the loss to
    1e-2 relative and each leaf to 5e-2 of its max norm: bf16 products in
    another order), the collectives of its first step by axis
    (``AxisComm.launches``), a second step's ms from CUDA events, tokens/s
    and peak memory, and on the card a third step under the profiler (its
    NCCL kernels' device time; the ring's hop at sp = 1 is a local copy,
    so no NCCL send/recv may run there). If the batch does not fit, every
    strategy runs again at half of it, and the lines say so."""
    import numpy as np
    import torch
    from grove_tpu_torch.models import llama

    on_cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    base = llama.init_params(cfg, gen, device=device)
    toks_all = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(device)
    note = None
    while True:
        rows, ref = [], None
        try:
            for strategy in ("mesh=None",) + STRATEGIES:
                row = parallel_step(cfg, base, toks_all[:batch], strategy,
                                    mesh, card, on_cuda, ref)
                ref = row.pop("ref", ref)
                rows.append(row)
            break
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            torch.cuda.empty_cache()
            note = (f"batch {toks_all.shape[0]} x {seq} did not fit in "
                    f"device memory; batch {batch // 2} x {seq} instead")
            log(f"parallel: {note}")
            batch //= 2
    for row in rows:
        row.update(model="llama-1b", dtype=str(cfg.dtype),
                   n_layers=cfg.n_layers, batch=batch, seq=seq, card=card)
        if note:
            row["note"] = note
        if row["strategy"] == "ring" and on_cuda:
            row["ring_hop"] = (
                "at sp = 1 the ring's hop is a local copy: "
                f"{row['profile']['sendrecv_kernels']} NCCL send/recv "
                "kernels traced")
        emit15("train_llama", **row)
    for row in rows:
        bad = not row["finite"] or (
            "loss_rel_diff" in row
            and not (row["loss_rel_diff"] <= 1e-2
                     and row["grad_max_rel_diff"] <= 5e-2)) or (
            row["strategy"] == "ring" and on_cuda
            and row["profile"]["sendrecv_kernels"])
        if bad:
            raise AssertionError(f"parallel llama training: {row}")


def routed(cfg, fn, picks: list):
    """``fn`` as a ``_decoder_stack`` MoE function that first records each
    layer's top-k experts per token in ``picks`` ([b, s, k], sorted), the
    router's f32 logits taken as ``moe._moe_block`` takes them."""
    import torch
    from grove_tpu_torch.ops.norms import rms_norm_ref

    def moe_fn(x, lp):
        hm = rms_norm_ref(x, lp["mlp_norm"], cfg.norm_eps)
        logits = torch.einsum("bsd,de->bse", hm.to(torch.float32),
                              lp["router"].to(torch.float32))
        top = torch.topk(logits, cfg.experts_per_token, dim=-1)[1]
        picks.append(top.sort(dim=-1).values)
        return fn(x, lp)
    return moe_fn


def parallel_moe(cfg, seed: int, device: str, seq: int, card: str,
                 reduced: dict, mesh) -> None:
    """The MoE at ``cfg`` (bf16), batch 1 x ``seq``, through the
    expert-parallel layer over the one-rank ep group at a capacity factor
    of n_experts (no assignment drops), against the dense path. Every
    layer: the ep block's output, on the ep path's own input, within
    bf16's 2e-2 of the largest MoE contribution of the dense block on the
    same input. The logits: within the model-level bound (5e-2 max
    |logit|) at every position whose top-k picks agree between the two
    paths in all layers; a bf16 rounding in one layer can flip a later
    layer's pick for a token whose two best experts are near tied, so the
    positions over the bound must be a subset of the flipped ones. Layer
    0 sees the same input on both paths, so it never flips, and the flips
    of the last layer reach only their own token. The next-token loss
    within 1e-2. The share of assignments dropped at the default 1.25;
    one train step through the ep layer (AdamW): the loss and every
    gradient finite, its time and the peak device memory."""
    import numpy as np
    import torch
    from grove_tpu_torch import train
    from grove_tpu_torch.models import llama, moe

    on_cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe.init_params(cfg, gen, device=device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, seq)).astype(np.int32)).to(device)
    ep = mesh.comm("ep")
    roomy = float(cfg.n_experts)
    block_diffs, block_bounds = [], []
    picks_dense, picks_ep, kept_roomy, kept_default = [], [], [], []

    def ep_checked(x, lp):
        y, aux = moe._ep_moe_block(cfg, x, lp, roomy, ep, kept_roomy)
        y_dense = moe._moe_block(cfg, x, lp)
        block_diffs.append((y - y_dense).abs().max().item())
        block_bounds.append(2e-2 * (y_dense - x).abs().max().item())
        return y, aux

    with torch.no_grad():
        # The whole model, each path's routing recorded.
        dense, _ = moe._decoder_stack(
            cfg, params, toks,
            routed(cfg, lambda x, lp: (moe._moe_block(cfg, x, lp), 0.0),
                   picks_dense), 0.0)
        ep_logits, _ = moe._decoder_stack(
            cfg, params, toks, routed(cfg, ep_checked, picks_ep), 0.0)
        moe._decoder_stack(cfg, params, toks, lambda x, lp: moe._ep_moe_block(
            cfg, x, lp, 1.25, ep, kept_default), 0.0)
        flipped = torch.stack([(a != b).any(dim=-1)
                               for a, b in zip(picks_dense, picks_ep)])
        flips = [int(f.sum()) for f in flipped]
        diff = (ep_logits - dense).abs().amax(dim=-1)
        bound = 5e-2 * dense.abs().max().item()
        over = diff > bound
        over_unflipped = int((over & ~flipped.any(dim=0)).sum())
        l_dense = float(llama.next_token_loss(dense, toks))
        l_ep = float(llama.next_token_loss(ep_logits, toks))
        dropped_roomy = sum(int((~k).sum()) for k in kept_roomy)
        dropped = sum(int((~k).sum()) for k in kept_default)
        assigned = sum(k.numel() for k in kept_default)
    del dense, ep_logits
    opt = train.make_optimizer(params)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(train.train_step(cfg, params, opt, toks,
                                  loss=ep_loss(ep, roomy)))
    step_s = time.perf_counter() - t0
    finite = np.isfinite(loss) and all(
        bool(torch.isfinite(p.grad).all()) for p in train.param_leaves(params))
    fields = {"model": "mixtral-8x7b", "dtype": str(cfg.dtype),
              "reduced": reduced, "batch": 1, "seq": seq,
              "capacity_factor": roomy,
              "block_max_abs_diff_by_layer": block_diffs,
              "block_bound_by_layer": block_bounds,
              "loss_dense": l_dense, "loss_ep": l_ep,
              "logits_max_abs_diff": diff.max().item(),
              "logits_max_abs_diff_unflipped": diff.masked_fill(
                  flipped.any(dim=0), 0).max().item(),
              "logits_model_bound": bound,
              "positions_over_model_bound": int(over.sum()),
              "positions_over_bound_unflipped": over_unflipped,
              "positions": int(diff.numel()),
              "routing_flips_by_layer": flips,
              "dropped_at_capacity_factor": dropped_roomy,
              "dropped_share_at_1.25": dropped / assigned,
              "assignments": assigned, "step_loss": loss,
              "grads_finite": finite, "step_s": step_s,
              "ep_group_size": ep.size, "card": card}
    if on_cuda:
        fields["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit15("train_moe_ep", **fields)
    del params, opt
    if on_cuda:
        torch.cuda.empty_cache()
    if not (all(d <= b for d, b in zip(block_diffs, block_bounds))
            and len(block_diffs) == cfg.n_layers
            and over_unflipped == 0 and flips[0] == 0
            and abs(l_ep - l_dense) <= 1e-2 * abs(l_dense)
            and dropped_roomy == 0 and finite):
        raise AssertionError(f"expert-parallel MoE: {fields}")


def phase_parallel_train(seed: int, card: str, cfg=None, moe_cfg=None,
                         device: str = "cuda", batch: int = 2,
                         seq: int = 2048, moe_layers: int = 2,
                         moe_seq: int = 1024) -> None:
    """Parallel training at one rank, over a one-rank group (NCCL on the
    card, gloo for the CPU rehearsal) and ``build_mesh(MeshPlan())``, whose
    every axis runs its collectives over the default group. (1) test-tiny
    and moe-test-tiny in f32, each strategy on the card against the same
    strategy on the CPU over a gloo group (``parallel_parity``): llama's
    ``loss_fn(mesh=)`` plain, ring and Ulysses, ``pipeline_forward`` at pp
    = 1 with 2 microbatches, the MoE through ``_ep_moe_block``. (2)
    llama-1b in bf16 at full width and depth, ``batch`` x ``seq`` tokens,
    one train step of each strategy against ``mesh=None``
    (``parallel_full``). (3) The MoE at Mixtral-8x7B's widths with
    ``moe_layers`` of its 32 layers through the expert-parallel layer
    (``parallel_moe``). (4) ``train.dryrun_multichip`` as a world of one:
    its plain section, and its ok line. No hand-written kernel may launch
    (counts read around the phase)."""
    import dataclasses
    import shutil
    import torch.distributed as dist
    from grove_tpu_torch import train
    from grove_tpu_torch.models import llama, moe
    from grove_tpu_torch.parallel.mesh import MeshPlan, build_mesh

    cfg = cfg or llama.CONFIGS["llama-1b"]
    moe_cfg = moe_cfg or moe.MOE_CONFIGS["mixtral-8x7b"]
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    path = one_rank_group(device)
    try:
        mesh = build_mesh(MeshPlan())
        emit15("group", backend=dist.get_backend(),
               axes={a: c.size for a, c in mesh.comms.items()}, card=card)
        parallel_parity(seed + 51, device, mesh, gloo_mesh())
        parallel_full(cfg, seed + 52, device, batch, seq, card, mesh)
        reduced = {"n_layers": f"{moe_cfg.n_layers} -> {moe_layers}"}
        parallel_moe(dataclasses.replace(moe_cfg, n_layers=moe_layers),
                     seed + 53, device, moe_seq, card, reduced, mesh)
        t0 = time.perf_counter()
        line = train.dryrun_multichip(device)
        emit15("dryrun_multichip", line=line, backend=dist.get_backend(),
               seconds=time.perf_counter() - t0, card=card)
        # n < 8: the disaggregated section is skipped, as in JAX.
        if not line.startswith("dryrun_multichip ok: n=1 plan=(dp=1, sp=1, "
                               "tp=1) ring=False loss=") or "disagg" in line:
            raise AssertionError(f"dryrun_multichip: {line}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(path, ignore_errors=True)
    launched = {n: w.launches for n, w in wrappers.items() if w.launches}
    emit15("train_kernel_launches", launches=launched)
    if launched:
        raise AssertionError(f"the parallel training path launched kernels: "
                             f"{launched}")


def decode_only(seed: int, card: str, batch: int = 32, bench_len: int = 512,
                steps: int = 64, spec_k: int = 3,
                spec_steps: int = 16) -> None:
    """llama-1b with the engine's default weights (bf16, no quantization)
    through the default ``make_engine``: a full batch of ``bench_len``-token
    prompts decoding, tokens/s over three windows of ``run(steps)`` after a
    warm ``run(16)``, and a profiled window of 8 steps (kernels and device
    ms); then the same batch through a self-draft spec engine at ``spec_k``
    (full acceptance): committed tokens/s over three windows of
    ``run(spec_steps)`` dispatches, its ratio to spec off's, and a profiled
    window of 8 dispatches (kernels, device ms and the GEMM's). Prints one
    JSON line. Run from two checkouts in turn (``--root``), it compares two
    commits in one call."""
    import numpy as np
    import torch
    import grove_tpu_torch
    from grove_tpu_torch.models.llama import CONFIGS, init_params
    from grove_tpu_torch.serving.engine import make_engine
    cfg = CONFIGS["llama-1b"]
    log(f"decode-only: grove_tpu_torch from {grove_tpu_torch.__file__}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    bench = np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, (batch, bench_len)).astype(np.int32)
    kernels = ("paged_partial", "w8a16", "rms_norm_kernel", "nvjet",
               "direct_copy")

    def windows(eng, n, committed):
        walls, tokens = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            c0 = committed()
            t = time.perf_counter()
            eng.run(n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            tokens.append(committed() - c0)
        return [tk / w for tk, w in zip(tokens, walls)], float(
            np.median(walls))

    eng = make_engine(cfg, params, batch=batch, max_len=2048, device="cuda")
    eng.warmup(widths=eng.decode_width_buckets(bench_len,
                                               bench_len + 5 * steps),
               prefill_widths=eng.decode_width_buckets(1, bench_len))
    eng.admit_prompts(bench, max_new_tokens=4 * steps)
    eng.run(16)

    def decoded():
        return batch * eng.steps

    rates, wall = windows(eng, steps, decoded)
    ms = profile_window("decode-only (bf16 weights)", lambda: eng.run(8),
                        wall * 1e3 / steps * 8, card, kernels)
    del eng
    torch.cuda.empty_cache()
    new = (spec_k + 1) * (3 * spec_steps + 16) + 16
    spec = make_engine(cfg, params, batch=batch, max_len=2048, device="cuda",
                       spec_decode=True, spec_k=spec_k, draft_params="self")
    spec.warmup(widths=spec.decode_width_buckets(bench_len,
                                                 bench_len + new + spec_k + 1),
                prefill_widths=spec.decode_width_buckets(1, bench_len))
    spec.admit_prompts(bench, max_new_tokens=new)
    spec.run(2)
    spec_rates, spec_wall = windows(
        spec, spec_steps, lambda: spec.spec_stats()["committed_tokens"])
    sms = profile_window(f"decode-only (bf16 weights, self-draft "
                         f"k={spec_k})", lambda: spec.run(8),
                         spec_wall * 1e3 / spec_steps * 8, card, kernels)
    ratio = float(np.median(spec_rates) / np.median(rates))
    log(f"decode-only: self-draft k={spec_k} {np.median(spec_rates):.1f} "
        f"against spec off {np.median(rates):.1f} tokens/s: {ratio:.3f}x; "
        f"per dispatch {sms['busy_ms'] / 8:.3f} ms of device time, GEMM "
        f"{sms['w8a16'] / 8:.3f} ms ({100 * sms['w8a16'] / sms['busy_ms']:.1f}"
        f"%) on {card}")
    print(json.dumps({"decode_tokens_s": rates,
                      "ms_per_step": wall * 1e3 / steps,
                      "kernels_per_8_steps": ms["count"],
                      "device_ms_per_8_steps": ms["busy_ms"],
                      "gemm_ms_per_8_steps": ms["w8a16"],
                      "spec_tokens_s": spec_rates, "spec_ratio": ratio,
                      "spec_kernels_per_dispatch": sms["count"] / 8,
                      "spec_device_ms_per_dispatch": sms["busy_ms"] / 8,
                      "spec_gemm_ms_per_dispatch": sms["w8a16"] / 8,
                      "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-only", action="store_true",
                    help="only the bf16-weight paged decode (decode_only)")
    ap.add_argument("--root", default=None,
                    help="with --decode-only: import grove_tpu_torch from "
                         "this checkout")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.decode_only:
        if args.root:
            sys.path.insert(0, os.path.abspath(args.root))
        decode_only(args.seed, card_line())
        return 0
    from grove_tpu_torch.ops import _build

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"device: nvidia-smi name, power.limit: {card}")

    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"time: {name} {now - t_phase[0]:.1f} s (total "
            f"{now - t_start:.1f} s)")
        t_phase[0] = now

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

    phase_done("phases 1-2 (device, build)")
    # 3. kernels vs plain
    flash_row = phase_kernels(args.seed, card)
    paged_rows = phase_paged_kernels(args.seed, card)
    paged_rows += phase_int8_kernels(args.seed, card)
    write_gen = torch.Generator(device="cuda").manual_seed(args.seed + 15)
    check_scatter(write_gen, card)
    paged_rows += check_rope_scatter(write_gen, card)
    paged_rows.append(check_rms_norm(write_gen, card))
    paged_rows.append(check_add_rms_norm(write_gen, card))
    paged_rows.append(phase_w8a16_kernels(args.seed, card))
    paged_rows.append(phase_dense_kernels(args.seed, card))
    phase_done("phase 3 (kernels)")
    # 4. the lanes path; 5. the flash and W8A16 kernels through the model
    lanes = phase_serve(args.seed, card)
    flash_row["launches"] = lanes["flash_causal_attention"]
    if not lanes["w8a16_matmul"]:
        raise AssertionError("w8a16_matmul never launched on the lanes path")
    phase_done("phase 4 (lanes serve)")
    phase_model(args.seed, card)
    phase_done("phase 5 (model)")
    # 6. paged parity; 7. the paged path (the default make_engine);
    # 8. the paged kernels through the model
    phase_paged_parity(args.seed)
    phase_done("phase 6 (paged parity)")
    launches = phase_paged_serve(args.seed, card)
    for row in paged_rows:
        row["launches"] = launches[row["name"]]
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on the "
                                 f"paged path")
    phase_done("phase 7 (paged serve)")
    phase_paged_model(args.seed, card)
    phase_done("phase 8 (paged model)")
    # 9. speculative decoding on the paged engine
    spec = phase_spec_serve(args.seed, card)
    for row in paged_rows:
        row["spec_launches"] = spec[row["name"]]
        if not row["spec_launches"]:
            raise AssertionError(f"{row['name']} never launched on the "
                                 f"spec path")
    phase_done("phase 9 (speculative serve)")
    # 10. disaggregated serving; 11. chunked prefill on the lanes worker
    disagg = phase_disagg_serve(args.seed, card)
    for row in paged_rows:
        row["disagg_launches"] = disagg[row["name"]]
        if not row["disagg_launches"]:
            raise AssertionError(f"{row['name']} never launched on the "
                                 f"disaggregated path")
    phase_done("phase 10 (disaggregated serve)")
    flash_row["chunked_launches"] = phase_chunked_prefill(args.seed, card)
    phase_done("phase 11 (chunked lanes prefill)")
    # 12. the observatories on the main path
    phase_observatories(args.seed, card,
                        step_device_ms=launches["step_device_ms"])
    phase_done("phase 12 (observatories)")
    # 13. training and checkpoints (warm restarts into live engines)
    restart = phase_train_checkpoint(args.seed, card)
    for row in [flash_row, *paged_rows]:
        row["restart_launches"] = restart[row["name"]]
    phase_done("phase 13 (training and checkpoints)")
    # 14. tensor-parallel serving: the mesh path over a one-rank NCCL group,
    # the paged path's kernels at shard widths, the worker twin
    tp = phase_tp_serve(args.seed, card)
    for row in paged_rows:
        row["tp_launches"] = tp[row["name"]]
        if not row["tp_launches"]:
            raise AssertionError(f"{row['name']} never launched on the "
                                 f"tensor-parallel path")
    phase_tp_kernels(args.seed, card)
    # The lanes functions under tp: each rank's flash at its head counts,
    # then the path itself, its counts zeroed just before it.
    phase_tp_flash(args.seed, card)
    flash_row["tp_launches"] = phase_tp_lanes(args.seed, card)
    check_worker_twin(card)
    # Checkpoints of a tp engine: a two-rank CPU step restored on the card,
    # the restored engines' serves counted from zero.
    tp_ckpt = phase_tp_checkpoint(args.seed, card)
    for row in paged_rows:
        row["tp_restart_launches"] = tp_ckpt[row["name"]]
    phase_done("phase 14 (tensor-parallel serving)")
    # 15. parallel training at one rank: every strategy over a one-rank NCCL
    # group, the dry-run twin
    phase_parallel_train(args.seed, card)
    phase_done("phase 15 (parallel training at one rank)")
    # 16. the in-pod serving worker twin on the card
    phase_serving_worker(card)
    phase_done("phase 16 (serving worker twin)")
    # 17. the data-plane gates over the port, counted from zero
    gates = phase_gates(args.seed, card)
    for row in [flash_row, *paged_rows]:
        row["gate_launches"] = gates.get(row["name"], 0)
    phase_done("phase 17 (data-plane gates)")

    print(json.dumps({"kernels": [flash_row, *paged_rows]}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
