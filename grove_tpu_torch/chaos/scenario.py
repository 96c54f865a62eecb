"""The data-plane chaos scenario over the port's engines: the JAX package's
``grove_tpu/chaos/scenario.py`` ``run_prefill_replica_kill``, with its
name, arguments, invariants and report keys, over ``grove_tpu_torch``'s
disaggregated pair (``tools/chaos_soak_torch.py --scenario
prefill-replica-kill`` runs it). The control-plane scenarios of that
module drive no engine and have no port."""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from grove_tpu_torch.device import resolve_device


def run_prefill_replica_kill(prompts: int = 6, max_new: int = 8,
                             seed: int = 0, *, model: str = "test-tiny",
                             device: str | torch.device | None = None
                             ) -> dict:
    """Kill the prefill tier of a disaggregated pair at the worst moment,
    BETWEEN chunk completion and decode adoption, with finished payloads
    sitting unshipped in the outbox, and prove the two invariants:

    * **No leaked or double-freed blocks.** The decode tier's allocator
      passes ``check()`` right after the kill and again after the
      recovered run drains: the dead tier's in-flight payload blocks died
      with its pool (a killed replica's device memory is gone; nothing on
      the decode side referenced them), and recovery must not free them
      into anyone's list.
    * **Bitwise-identical tokens.** Every request re-prefills on the
      replacement tier and completes with exactly the token stream a mono
      ``PagedDecodeEngine`` produces for the same prompts: greedy
      re-prefill is deterministic, so a rid-keyed compare is exact.

    The kill point is staged: the pair runs until the decode tier holds
    live adopted sequences (so recovery also carries in-flight decode work
    through the swap), then the prefill tier ticks WITHOUT the outbox pump
    until a payload is stranded mid-handoff. ``replace_prefill`` is the
    recovery path under test: it may read the dead engine's host-side
    request metadata (the router's request log in a deployment) but never
    its allocator.

    ``model`` is the served model (test-tiny in f32, as the JAX scenario
    serves it; another in its own dtype, at the same 64-token context),
    with random weights from seed 0, on ``device`` (None: the card)."""
    from grove_tpu_torch.models import llama
    from grove_tpu_torch.serving.engine import (PagedDecodeEngine,
                                                PrefillEngine, make_disagg)

    log = logging.getLogger("grove_tpu_torch.chaos.prefill-replica-kill")
    dev = resolve_device(device)
    cfg = dataclasses.replace(llama.CONFIGS[model], max_seq_len=64)
    if model == "test-tiny":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    geom = dict(batch=4, block_size=8, prefill_chunk=8,
                host_sync_interval=4, device=dev)
    rng = np.random.default_rng(seed)
    # Longest prompts last: they are still queued (prefill slots = 4) when
    # the early ones reach the decode tier, so live prefill work is
    # stranded at the kill point.
    lens = sorted(rng.integers(3, 28, size=prompts).tolist())
    toks = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]

    def _drain(eng, want: int, budget: int = 600) -> None:
        while len(eng.completed) < want and budget > 0:
            eng.admit_from_queue()
            eng.step()
            budget -= 1
        eng.sync()
        assert len(eng.completed) >= want, \
            f"stalled: {len(eng.completed)}/{want} done within budget"

    # Reference: the mono engine on the same prompts (same submit order =>
    # same rids on both sides).
    mono = PagedDecodeEngine(cfg, params, **geom)
    for t in toks:
        mono.submit(t, max_new_tokens=max_new)
    _drain(mono, prompts)
    expect = {r.rid: list(r.generated) for r in mono.completed}

    dis = make_disagg(cfg, params, **geom)
    for t in toks:
        dis.submit(t, max_new_tokens=max_new)
    # Phase A: run the pair normally until decode holds live work.
    guard = 200
    while not dis.decode._sched.running and guard > 0:
        dis.admit_from_queue()
        dis.step()
        guard -= 1
    assert dis.decode._sched.running, "decode tier never went live"
    # Phase B: tick ONLY the prefill tier (no outbox pump) until a finished
    # prefill is stranded mid-handoff.
    guard = 200
    while not dis.prefill.outbox and guard > 0:
        dis.admit_from_queue()
        dis.prefill.step()
        guard -= 1
    assert dis.prefill.outbox, "never reached a mid-handoff state"
    report: dict = {
        "prompts": prompts, "max_new": max_new, "seed": seed,
        "outbox_at_kill": len(dis.prefill.outbox),
        "blocks_in_flight": sum(len(p.blocks) for p in dis.prefill.outbox),
        "prefilling_at_kill": len(dis.prefill._sched.prefilling),
        "decode_live_at_kill": dis.decode._sched.live,
    }
    log.info("killing prefill tier: %d payload(s) mid-handoff, "
             "%d block(s) in flight, %d seq(s) live on decode",
             report["outbox_at_kill"], report["blocks_in_flight"],
             report["prefilling_at_kill"] + report["decode_live_at_kill"])

    # The kill + recovery: the old engine (pool, allocator, outbox
    # payloads) is dropped wholesale; nothing releases its blocks, as with
    # a killed replica. Decode must be clean BEFORE any recovery runs:
    # adoption is all-or-nothing per payload.
    replacement = PrefillEngine(cfg, params, **geom)
    rescued = dis.replace_prefill(replacement)
    dis.decode._alloc.check()
    report["rescued"] = rescued
    assert rescued >= report["outbox_at_kill"], \
        "mid-handoff payloads were not rescued"

    _drain(dis, prompts)
    dis.decode._alloc.check()
    dis.prefill._alloc.check()
    assert not dis.decode._alloc._refs and not dis.prefill._alloc._refs, \
        "live block refs after drain: leaked handoff blocks"
    got = {r.rid: list(r.generated) for r in dis.completed}
    assert set(got) == set(expect), \
        f"rid sets diverged: {sorted(got)} vs {sorted(expect)}"
    mismatched = [rid for rid in expect if got[rid] != expect[rid]]
    assert not mismatched, \
        f"token streams diverged after re-prefill for rids {mismatched}"
    report.update({
        "completed": len(got),
        "tokens_bitwise_identical": True,
        "decode_allocator": dis.decode._alloc.payload(),
        "handoff": dis.handoff_view(),
        "ok": True,
    })
    log.info("prefill-replica-kill OK: %d rescued, %d/%d requests "
             "bitwise-identical to mono, allocators clean",
             rescued, len(got), prompts)
    return report
