"""The decode smoke's contracts over the port's paged engines: what
tools/decode_smoke.py holds the JAX engines to, with its workload and its
pinned build sets (copied here; tools/decode_smoke_torch.py, the twin that
runs these on the command line, checks that the copies equal the JAX
tool's).

On tools/decode_smoke.py's seeded mixed-length workload and geometry:

1. **Exact builds, zero rebuilds.** Every dispatch shape comes off the
   fixed bucket ladders, and the compile tracker (``serving/xprof.py``)
   shows EXACTLY the pinned set, every count 1. A build is a CUDA graph
   capture on the card (each bucket's capture is counted by
   ``graphs_captured`` too) and the first call of an eager bucket on the
   CPU. A second identical workload (the steady state) must add NOTHING:
   no build, no capture, no rebuild.
2. **Token parity vs the lanes engine.** Same params, same prompts,
   greedy: the paged path must give the SAME tokens as the lanes engine.
3. **Lifecycle + allocator hygiene.** Every request completes with ordered
   stamps, the allocator ends empty and passes ``check()``, and continuous
   admission interleaved.

``run_mono`` runs four paged engines: prefix cache off and on (the one
addition on is the copy-on-write block copy, built at construction, before
traffic; the second pass's full-block prompts must hit), self-draft
speculative decoding (only ``paged_spec`` builds, acceptance 1.0, tokens
equal to cache-off) and int8 KV (the same ladder under ``_q8`` names).
``run_disagg`` runs the prefill -> decode pair instead: each tier pins its
half of the builds (the decode tier adds the one handoff copy), nothing
is built in the steady state, and the tokens are bitwise the mono
engine's. Each returns its numbers; a broken contract raises
``AssertionError``. The engines need their compile tracker (the default;
not ``GROVE_XPROF=0``).
"""

from __future__ import annotations

import numpy as np
import torch

from grove_tpu_torch.serving.engine import (DecodeEngine, PagedDecodeEngine,
                                            make_disagg)

PROMPT_LENS = (5, 19, 3, 11, 7)
MAX_NEW = 6

# batch 4 slots, max_len 48, block 8, chunk 8: the geometry the pins hold.
GEOM = dict(batch=4, max_len=48, block_size=8, prefill_chunk=8,
            host_sync_interval=4)

EXPECTED_LOWERINGS = {
    "paged_prefill[c8,w1]": 1,
    "paged_prefill[c8,w2]": 1,
    "paged_prefill[c8,w4]": 1,
    "paged_step[b1,w1]": 1,
    "paged_step[b1,w2]": 1,
    "paged_step[b2,w2]": 1,
    "paged_step[b2,w4]": 1,
    "paged_step[b4,w2]": 1,
    "paged_step[b4,w4]": 1,
}
EXPECTED_WITH_PREFIX = dict(EXPECTED_LOWERINGS, **{"paged_cow_copy": 1})
EXPECTED_SPEC = {
    "paged_prefill[c8,w1]": 1,
    "paged_prefill[c8,w2]": 1,
    "paged_prefill[c8,w4]": 1,
    "paged_spec[b1,w2,k3]": 1,
    "paged_spec[b1,w4,k3]": 1,
    "paged_spec[b2,w4,k3]": 1,
}
EXPECTED_QUANT = {name.replace("[", "_q8["): 1
                  for name in EXPECTED_LOWERINGS}
EXPECTED_DISAGG_PREFILL = {
    "paged_prefill[c8,w1]": 1,
    "paged_prefill[c8,w2]": 1,
    "paged_prefill[c8,w4]": 1,
}
EXPECTED_DISAGG_DECODE = {
    "paged_handoff_copy": 1,
    "paged_step[b1,w1]": 1,
    "paged_step[b1,w2]": 1,
    "paged_step[b2,w2]": 1,
    "paged_step[b2,w4]": 1,
    "paged_step[b4,w2]": 1,
    "paged_step[b4,w4]": 1,
}

PINS = {"PROMPT_LENS": PROMPT_LENS, "MAX_NEW": MAX_NEW,
        "EXPECTED_LOWERINGS": EXPECTED_LOWERINGS,
        "EXPECTED_WITH_PREFIX": EXPECTED_WITH_PREFIX,
        "EXPECTED_SPEC": EXPECTED_SPEC, "EXPECTED_QUANT": EXPECTED_QUANT,
        "EXPECTED_DISAGG_PREFILL": EXPECTED_DISAGG_PREFILL,
        "EXPECTED_DISAGG_DECODE": EXPECTED_DISAGG_DECODE}


def prompts(vocab_size: int) -> list[np.ndarray]:
    """The seeded mixed-length workload, one prompt per ``PROMPT_LENS``."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab_size, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def drive(engine, want: int) -> None:
    for _ in range(600):
        engine.admit_from_queue()
        if len(engine.completed) >= want:
            break
        if engine._sched.live:
            engine.step()
    engine.sync()
    assert len(engine.completed) >= want, (len(engine.completed), want)


def exercise(eng, prompts, expected: dict) -> None:
    """Warm + steady pass against one pinned build set."""
    assert eng.xprof is not None, "the compile tracker is off (GROVE_XPROF)"
    # ---- warm pass: mixed lengths through admit/prefill/decode ----
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    drive(eng, len(prompts))
    counts = eng.xprof.compile.counts()
    assert counts == expected, (
        f"build set drifted:\n  got      {counts}\n  expected {expected}")
    assert eng.xprof.compile.recompile_count() == 0, \
        eng.xprof.compile.payload()
    if eng.device.type == "cuda":
        # One capture per bucket graph (the CoW copy is not a graph).
        graphs = sum(1 for n in counts if n != "paged_cow_copy")
        assert eng.graphs_captured == graphs, (eng.graphs_captured, counts)

    # ---- steady state: the SAME workload must build NOTHING ----
    before, captured = dict(counts), eng.graphs_captured
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    drive(eng, 2 * len(prompts))
    after = eng.xprof.compile.counts()
    assert after == before, (
        f"steady state built: {set(after) - set(before)} / counts moved")
    assert eng.graphs_captured == captured, \
        (eng.graphs_captured, captured)
    assert eng.xprof.compile.recompile_count() == 0
    assert eng.xprof.compile.storms == 0

    # ---- lifecycle + allocator hygiene ----
    for req in eng.completed:
        assert len(req.generated) == MAX_NEW, req.rid
        assert req.enqueue_ts <= req.admit_ts <= req.first_token_ts \
            <= req.done_ts, req.rid
    eng._alloc.check()
    assert eng._alloc.used_blocks == 0, eng._alloc.payload()
    assert eng._sched.admitted_total >= 2 * len(prompts)


def lanes_tokens(cfg, params, prompts, dev) -> dict[int, list[int]]:
    """The lanes engine's greedy tokens for ``prompts``, by prompt length."""
    lanes = DecodeEngine(cfg, params, batch=len(prompts),
                         max_len=GEOM["max_len"], device=dev)
    pad = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), pad), np.int32)
    lens = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        lens[i] = len(p)
    lanes.admit_prompts(torch.from_numpy(toks).to(dev),
                        max_new_tokens=MAX_NEW,
                        lengths=torch.from_numpy(lens).to(dev))
    for _ in range(MAX_NEW + 8):
        lanes.step()
    lanes.sync()
    assert len(lanes.completed) == len(prompts)
    return {r.prompt_len: r.generated for r in lanes.completed}


def run_mono(cfg, params, dev) -> dict:
    """The four paged engines against their pins, cache-off, spec and the
    lanes engine. Returns the numbers the twin prints."""
    ps = prompts(cfg.vocab_size)
    geom = dict(GEOM, device=dev)
    # ---- cache OFF ----
    eng = PagedDecodeEngine(cfg, params, prefix_cache=False, **geom)
    exercise(eng, ps, EXPECTED_LOWERINGS)

    # ---- cache ON: one CoW copy built at construction, nothing after ----
    eng_on = PagedDecodeEngine(cfg, params, prefix_cache=True, **geom)
    at_construction = eng_on.xprof.compile.counts()
    assert at_construction == {"paged_cow_copy": 1}, (
        "CoW copy must be built at construction, before traffic: "
        f"{at_construction}")
    exercise(eng_on, ps, EXPECTED_WITH_PREFIX)
    pfx = eng_on.prefix_stats()
    assert pfx["tokens_matched_total"] > 0, pfx
    # The second pass resubmits identical prompts: every full-block prefix
    # must hit (the 11- and 19-token prompts').
    skipped = eng_on._sched.prefix_tokens_skipped_total
    assert skipped >= 8 + 16, skipped

    # ---- bitwise token parity: cache on vs off, both passes ----
    off_by_rid = {r.rid: r.generated for r in eng.completed}
    for r in eng_on.completed:
        assert r.generated == off_by_rid[r.rid], (
            f"prefix-cache token divergence rid={r.rid}: "
            f"{r.generated} vs {off_by_rid[r.rid]}")

    # ---- speculative decoding: fused-dispatch pin + bitwise parity ----
    eng_spec = PagedDecodeEngine(cfg, params, prefix_cache=False,
                                 spec_decode=True, spec_k=3,
                                 draft_params="self", **geom)
    exercise(eng_spec, ps, EXPECTED_SPEC)
    assert not any(n.startswith("paged_step") for n in
                   eng_spec.xprof.compile.counts()), \
        "spec engine dispatched a plain decode step"
    sp = eng_spec.spec_stats()
    # Self-draft: the drafter IS the target, so every draft must agree.
    assert sp["acceptance_rate"] == 1.0, sp
    assert sp["accepted_per_dispatch"] == 4.0, sp
    for r in eng_spec.completed:
        assert r.generated == off_by_rid[r.rid], (
            f"speculative token divergence rid={r.rid}: "
            f"{r.generated} vs {off_by_rid[r.rid]}")

    # ---- int8 paged KV: same ladder, _q8 bodies ----
    eng_q8 = PagedDecodeEngine(cfg, params, prefix_cache=False,
                               kv_quant="int8", **geom)
    exercise(eng_q8, ps, EXPECTED_QUANT)
    assert eng_q8.kv.quantized and eng_q8.kv.k.dtype == torch.int8

    # ---- parity vs the lanes engine (greedy, same params) ----
    lanes_by_len = lanes_tokens(cfg, params, ps, dev)
    paged_by_len = {r.prompt_len: r.generated
                    for r in eng.completed[:len(ps)]}
    for n in PROMPT_LENS:
        assert paged_by_len[n] == lanes_by_len[n], (
            f"paged/lanes token divergence at prompt_len={n}: "
            f"{paged_by_len[n]} vs {lanes_by_len[n]}")

    engines = (eng, eng_on, eng_spec, eng_q8)
    return {"completed": len(eng.completed),
            "builds": [sum(e.xprof.compile.counts().values())
                       for e in engines],
            "graphs_captured": [e.graphs_captured for e in engines],
            "build_seconds": sum(e.xprof.compile.payload()["total_seconds"]
                                 for e in engines),
            "prefix_tokens_skipped": skipped,
            "spec_acceptance": sp["acceptance_rate"],
            "spec_accepted_per_dispatch": sp["accepted_per_dispatch"],
            "allocs": eng._alloc.payload()["allocs_total"],
            "preemptions": eng._sched.preemptions_total}


def run_disagg(cfg, params, dev) -> dict:
    """The prefill -> decode pair: split pins, zero steady growth, bitwise
    token parity vs the mono engine, both allocators clean. Returns the
    numbers the twin prints."""
    ps = prompts(cfg.vocab_size)
    geom = dict(GEOM, prefix_cache=False, device=dev)
    mono = PagedDecodeEngine(cfg, params, **geom)
    dis = make_disagg(cfg, params, **geom)

    def drive_pair(want: int) -> None:
        for _ in range(600):
            dis.admit_from_queue()
            if len(dis.completed) >= want:
                break
            dis.step()
        dis.sync()
        assert len(dis.completed) >= want, (len(dis.completed), want)

    # Warm pass: each tier pins EXACTLY its half of the work.
    for p in ps:
        mono.submit(p, max_new_tokens=MAX_NEW)
        dis.submit(p, max_new_tokens=MAX_NEW)
    drive(mono, len(ps))
    drive_pair(len(ps))
    pre = dis.prefill.xprof.compile.counts()
    dec = dis.decode.xprof.compile.counts()
    assert pre == EXPECTED_DISAGG_PREFILL, (
        f"prefill-tier build set drifted:\n  got      {pre}\n"
        f"  expected {EXPECTED_DISAGG_PREFILL}")
    assert dec == EXPECTED_DISAGG_DECODE, (
        f"decode-tier build set drifted:\n  got      {dec}\n"
        f"  expected {EXPECTED_DISAGG_DECODE}")
    assert dis.prefill.xprof.compile.recompile_count() == 0
    assert dis.decode.xprof.compile.recompile_count() == 0
    captured = (dis.prefill.graphs_captured, dis.decode.graphs_captured)
    if dev.type == "cuda":
        # The handoff copy is not a graph: it runs on the current stream.
        assert captured == (len(pre), len(dec) - 1), (captured, pre, dec)

    # Steady state: the SAME workload must build NOTHING on either tier.
    for p in ps:
        mono.submit(p, max_new_tokens=MAX_NEW)
        dis.submit(p, max_new_tokens=MAX_NEW)
    drive(mono, 2 * len(ps))
    drive_pair(2 * len(ps))
    assert dis.prefill.xprof.compile.counts() == pre
    assert dis.decode.xprof.compile.counts() == dec
    assert (dis.prefill.graphs_captured,
            dis.decode.graphs_captured) == captured
    for tier in (dis.prefill, dis.decode):
        assert tier.xprof.compile.recompile_count() == 0
        assert tier.xprof.compile.storms == 0

    # Bitwise token parity vs the mono engine, both passes, plus lifecycle
    # stamps and clean allocators on BOTH pools.
    mono_by_rid = {r.rid: r.generated for r in mono.completed}
    for r in dis.completed:
        assert len(r.generated) == MAX_NEW, r.rid
        assert r.enqueue_ts <= r.admit_ts <= r.first_token_ts \
            <= r.done_ts, r.rid
        assert r.generated == mono_by_rid[r.rid], (
            f"disagg token divergence rid={r.rid}: "
            f"{r.generated} vs {mono_by_rid[r.rid]}")
    dis.prefill._alloc.check()
    dis.decode._alloc.check()
    assert dis.prefill._alloc.used_blocks == 0
    assert dis.decode._alloc.used_blocks == 0
    hv = dis.handoff_view()
    assert hv["requests"] == 2 * len(ps), hv
    assert hv["deferred"] == 0, hv
    return {"completed": len(dis.completed),
            "builds": [len(pre), len(dec)],
            "graphs_captured": list(captured),
            "handoff_blocks": hv["blocks"], "handoff_bytes": hv["bytes"],
            "handoff_ms_per_request": hv["ms_per_request"]}
