"""Continuous-batching schedule policy for the paged decode engine.

The port's copy of ``grove_tpu/serving/schedule.py`` (that module imports
the JAX package's kvcache, which imports JAX). Pure host bookkeeping:
nothing here touches a device. The engine (serving/engine.py
``PagedDecodeEngine``) owns the device tensors and the captured CUDA
graphs; this module owns the decisions:

- **Bucketed shapes.** Every dispatch shape comes off two fixed
  power-of-two ladders (batch slots, block-table width), so the set of
  decode graphs is FINITE and workload-independent: once the buckets a
  deployment actually uses are captured, steady state captures nothing
  new. Rounding a 5-sequence batch
  up to 8 wastes three rows of compute — the classic static-shape
  trade, and still far cheaper than one mid-traffic graph capture.
- **Admission.** A request is admitted when a decode slot is free and
  the allocator grants its first prefill chunk. A shortfall defers the
  request in place (FIFO; no head-of-line skipping — a starving big
  request must eventually get its blocks).
- **Chunked prefill.** Prompts are processed one fixed-size chunk per
  engine tick, interleaved with decode steps: the longest prompt can
  stall TPOT for at most one chunk's wall time, never the whole
  prefill. Capacity is ensured for the chunk's VALID tokens only; the
  padded tail scatters into the null block via the kernel's
  ``n_valid`` mask (ops/kvquant.scatter_slots — without the mask,
  the clipped scatter corrupted a real block's tokens, found the hard
  way in kernel bring-up).
- **Preemption by recompute.** When decode needs a block and the pool
  is dry, the NEWEST running sequence is evicted: blocks freed,
  prompt + generated-so-far becomes its recompute prompt, and it
  re-enters at the head of the admission queue (vLLM's recompute
  policy). The victim's stamps and token counts survive — recompute
  regenerates cache state, not history.
- **Prefix-aware admission** (``prefix_tree`` attached).
  Admission first matches the prompt against the block-granular prefix
  tree: whole-block hits join the table SHARED (ref'd, never copied),
  a mid-block divergence grants one fresh block as a copy-on-write
  target (the engine device-copies before the first scatter), and the
  allocator grant covers only the COLD SUFFIX. ``seq.pos`` starts at
  the matched token count, so prefill chunks skip matched tokens
  entirely — warm-prefix TTFT collapses to the suffix's chunks.
  Eviction ordering on shortfall is cached-then-preempt: ``alloc``
  reclaims unreferenced cached blocks (LRU) before it ever reports the
  OOM that defers admission or preempts running work, so a warm cache
  never steals capacity from live traffic. Every release path
  (retire / preempt / prefill-evict) registers the sequence's full
  blocks into the tree first — a preempted victim usually re-admits
  straight out of the cache it just parked.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from grove_tpu_torch.serving.kvcache import BlockAllocator, SeqBlocks


def bucket_ladder(maximum: int, start: int = 1) -> list[int]:
    """Powers of two from ``start`` up, capped by (and always
    including) ``maximum`` — the fixed shape ladder."""
    assert maximum >= 1
    out, v = [], max(1, start)
    while v < maximum:
        out.append(v)
        v *= 2
    out.append(maximum)
    return sorted(set(out))


def pick_bucket(n: int, ladder: list[int]) -> int:
    """Smallest ladder entry >= n."""
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the top bucket {ladder[-1]}")


@dataclasses.dataclass(eq=False)  # identity semantics: seqs are keys
class PagedSeq:
    """One request's life inside the paged engine. ``tokens`` is what
    prefill must process — the prompt, or prompt + generated for a
    recompute after preemption. ``pos`` is tokens already written to
    the cache; ``n_generated`` counts sampled tokens (the prefill's
    first token included, matching the lanes engine's accounting)."""

    req: object                     # serving.engine.Request
    tokens: np.ndarray              # int32 [len] — prefill input
    blocks: SeqBlocks
    order: int                      # admission sequence (preemption key)
    pos: int = 0                    # tokens written to the KV cache
    n_generated: int = 0
    recompute: bool = False         # re-prefill after preemption
    last_token: int = -1            # host view of the newest token
    preemptions: int = 0
    prefix_matched: int = 0         # tokens served from the prefix tree
    cow_src: int = -1               # shared block awaiting copy-on-write
    cow_dst: int = -1               # fresh block the copy lands in
    # Speculative decode: upper bound on tokens dispatched but not yet
    # drained. The device commits a DATA-DEPENDENT count per spec step
    # (accepted + bonus ≤ k+1); the host can't know it until the window
    # drains, so capacity grants use pos + inflight as the conservative
    # device-length bound. Drains fold the real counts into ``pos`` and
    # zero this. Always 0 in non-speculative mode.
    inflight: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    @property
    def prefill_done(self) -> bool:
        return self.pos >= len(self.tokens)

    def finished(self) -> bool:
        return self.n_generated >= self.req.max_new_tokens


class PagedScheduler:
    """Admission / prefill / decode-set policy over one allocator.

    States a sequence moves through:
    ``preempted`` (recompute queue, drains first) → ``prefilling``
    (chunks advancing) → ``running`` (in the decode batch) → gone
    (finished: blocks freed by the engine). The engine calls the
    transition methods; everything here is synchronous host work.
    """

    def __init__(self, allocator: BlockAllocator, max_slots: int,
                 max_blocks_per_seq: int, chunk: int,
                 prefix_tree=None) -> None:
        self.allocator = allocator
        self.max_slots = max_slots
        self.chunk = chunk
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_tree = prefix_tree  # kvcache.PrefixTree | None
        self.batch_buckets = bucket_ladder(max_slots)
        self.width_buckets = bucket_ladder(max_blocks_per_seq)
        self.prefilling: deque[PagedSeq] = deque()
        self.running: list[PagedSeq] = []
        self.preempted: deque[PagedSeq] = deque()
        self._order = 0
        # Policy counters (debug payloads + tests).
        self.admitted_total = 0
        self.deferred_total = 0
        self.preemptions_total = 0
        self.prefix_tokens_skipped_total = 0
        # serving/reqtrace.RequestObservatory | None: the owning engine
        # shares its recorder, so preemption and prefix boundaries stamp
        # from the transition itself (host bookkeeping, unconditional: a
        # preemption-storm request's attribution is never sampled away).
        self.reqtrace = None

    # ---- occupancy ----

    @property
    def live(self) -> int:
        return len(self.prefilling) + len(self.running)

    @property
    def slots_free(self) -> int:
        return self.max_slots - self.live

    def has_prefill_work(self) -> bool:
        return bool(self.prefilling)

    # ---- admission ----

    def _chunk_capacity(self, seq: PagedSeq) -> int:
        """Token capacity the NEXT chunk dispatch needs: its VALID
        tokens (the kernel's n_valid mask reroutes the padded tail to
        the null block, so backing the padding would just tighten OOM
        pressure in small pools for nothing)."""
        return min(seq.pos + self.chunk, len(seq.tokens),
                   self.max_blocks_per_seq * self.allocator.block_size)

    def _head_starved(self) -> bool:
        """True when the prefill head's next chunk cannot currently be
        granted — new admissions must then defer (head priority), or
        an admit/evict cycle could livelock: the head's shortfall gets
        re-granted to fresh admissions forever."""
        if not self.prefilling:
            return False
        head = self.prefilling[0]
        bs = self.allocator.block_size
        need = (-(-self._chunk_capacity(head) // bs)
                - len(head.blocks.blocks))
        return need > 0 and not self.allocator.can_alloc(need)

    def admit(self, req, tokens: np.ndarray,
              recompute: bool = False) -> PagedSeq | None:
        """Admit one request if a slot is free, the prefill head is not
        starved, and the allocator grants the first chunk. None =
        backpressure (nothing allocated — a failed admission also
        unrefs any prefix-tree hits it took, so matched blocks fall
        back to the cached pool untouched).

        With a prefix tree, matching runs FIRST: whole-block hits join
        the table shared, a mid-block hit adds one fresh copy-on-write
        target block, and the grant covers only the cold suffix.
        ``seq.pos`` starts past every matched token, so prefill skips
        them entirely."""
        if self.slots_free <= 0 or self._head_starved():
            self.deferred_total += 1
            return None
        tokens = np.asarray(tokens, np.int32)
        seq = PagedSeq(req=req, tokens=tokens,
                       blocks=SeqBlocks(self.allocator), order=self._order,
                       recompute=recompute)
        if self.prefix_tree is not None:
            shared, matched, partial = self.prefix_tree.match(tokens)
            seq.blocks.blocks = shared
            seq.pos = seq.prefix_matched = matched
            if partial is not None:
                src, _ = partial
                got = self.allocator.alloc(1)
                if got is None:
                    self._release_seq(seq)
                    self.allocator.free([src])
                    self.deferred_total += 1
                    return None
                seq.blocks.blocks.append(got[0])
                seq.cow_src, seq.cow_dst = src, got[0]
        if not seq.blocks.ensure(self._chunk_capacity(seq)):
            self._release_seq(seq)
            self.deferred_total += 1
            return None
        if self._head_starved():
            # The grant just taken starved the prefill head's next
            # chunk. The pre-grant gate above cannot see this: a warm
            # admission's cold need can be tiny (prefix hits cover the
            # rest), so it passes, grabs exactly the head's shortfall,
            # gets evicted as newest, and re-admits forever — a
            # livelock the cold path never hits (its own first-chunk
            # grant fails first). Roll back: matched refs fall to the
            # cached pool, exclusive blocks to the free list, and the
            # head's ensure succeeds again this tick.
            self._release_seq(seq)
            self.deferred_total += 1
            return None
        self.prefix_tokens_skipped_total += seq.prefix_matched
        if self.reqtrace is not None and self.prefix_tree is not None \
                and not recompute:
            bs = self.allocator.block_size
            self.reqtrace.note_prefix(
                req.rid, seq.prefix_matched // bs,
                -(-len(tokens) // bs), seq.prefix_matched)
        if not recompute:
            # TTFT segmentation for the bench surfaces (warm vs cold):
            # first admission only — a later recompute hit is recovery,
            # not a warm arrival.
            req.cached_tokens = seq.prefix_matched
        self._order += 1
        self.admitted_total += 1
        self.prefilling.append(seq)
        return seq

    def readmit(self, seq: PagedSeq) -> PagedSeq | None:
        """Move the front preempted sequence back in (called before
        fresh admissions so recompute work drains first)."""
        got = self.admit(seq.req, seq.tokens, recompute=True)
        if got is not None:
            got.n_generated = seq.n_generated
            got.preemptions = seq.preemptions
        return got

    # ---- prefill ----

    def next_prefill(self) -> PagedSeq | None:
        """The chunk to run this tick: front of the prefill queue,
        ready only if its next (padded) chunk's capacity is granted.
        FIFO — a later prompt never overtakes a blocked earlier one."""
        if not self.prefilling:
            return None
        seq = self.prefilling[0]
        if not seq.blocks.ensure(self._chunk_capacity(seq)):
            return None
        return seq

    def promote(self, seq: PagedSeq) -> None:
        """Prefill finished → join the decode batch (continuous: this
        happens at ANY step, between any two decode dispatches). The
        prompt's full blocks register into the prefix tree NOW — they
        are immutable from here (decode writes start past the prompt),
        so a concurrent identical prompt shares them while this one is
        still decoding."""
        assert self.prefilling and self.prefilling[0] is seq
        self.prefilling.popleft()
        self._register_prefix(seq)
        self.running.append(seq)

    def detach_prefill_head(self, seq: PagedSeq) -> None:
        """Prefill finished in disaggregated mode: drop the sequence from
        the prefill queue WITHOUT releasing its blocks. Ownership moves to
        the HandoffPayload (serving/handoff.py), whose ``release()`` unrefs
        them once the decode side has adopted. The prefix registration
        mirrors ``promote``: the prompt's full blocks are immutable from
        here, so a concurrent identical prompt on this prefill tier shares
        them while the payload is still in flight."""
        assert self.prefilling and self.prefilling[0] is seq
        self.prefilling.popleft()
        self._register_prefix(seq)

    def adopt_running(self, seq: PagedSeq) -> None:
        """Join a handoff-adopted sequence straight into the decode batch:
        its KV already exists locally (adopted blocks and decode-side
        prefix hits), so it skips the prefilling state, the disaggregated
        analog of admit-then-promote. The caller has already gated on
        ``slots_free``."""
        assert self.slots_free > 0, "adopt_running past the slot gate"
        seq.order = self._order
        self._order += 1
        self.admitted_total += 1
        self.prefix_tokens_skipped_total += seq.prefix_matched
        self.running.append(seq)

    # ---- release / registration (every block-freeing path) ----

    def _release_seq(self, seq: PagedSeq) -> None:
        """Drop every reference the sequence holds: its table, plus a
        pending copy-on-write source if the engine never resolved it
        (admission bail-out, prefill eviction). Shared blocks fall to
        their other holders or the cached pool; exclusive unregistered
        ones return to the free list."""
        if seq.cow_src >= 0:
            self.allocator.free([seq.cow_src])
            seq.cow_src = seq.cow_dst = -1
        seq.blocks.release()

    def _register_prefix(self, seq: PagedSeq) -> None:
        """Register the sequence's FULL blocks of known content into
        the prefix tree — called at every release site BEFORE the
        blocks are unref'd, so the last unref parks them cached instead
        of freeing them. Content is prompt + drained generated tokens
        (position ``p`` holds ``prompt[p]`` or
        ``generated[p - prompt_len]`` — the recompute replay identity),
        capped at ``seq.pos``: undrained window tokens just shorten
        what this release can cache."""
        if self.prefix_tree is None:
            return
        req = seq.req
        gen = list(getattr(req, "generated", []))
        content = np.asarray(req.prompt[:req.prompt_len], np.int32)
        if gen:
            content = np.concatenate([content,
                                      np.asarray(gen, np.int32)])
        n_known = min(seq.pos, len(content))
        n_full = n_known // self.allocator.block_size
        if n_full:
            self.prefix_tree.insert(content[:n_known],
                                    seq.blocks.blocks[:n_full])

    # ---- decode-set maintenance ----

    def retire(self, seq: PagedSeq) -> None:
        """Remove a finished sequence and free its blocks (registering
        its prefix first, so an identical prompt arriving next admits
        straight out of the cached pool)."""
        self.running.remove(seq)
        self._register_prefix(seq)
        self._release_seq(seq)

    def evict_newest_prefilling(self, protect: PagedSeq | None = None
                                ) -> PagedSeq | None:
        """Release the NEWEST prefilling sequence's blocks and drop it
        from the prefill queue (its Request restarts from scratch via
        the engine's queue — no token was produced yet, so nothing is
        replayed). The escape hatch for prefill head-of-line OOM when
        NOTHING is decoding: with every block pinned by other
        prefilling sequences that can never advance (head-only FIFO),
        waiting for completions would wait forever."""
        candidates = [s for s in self.prefilling if s is not protect]
        if not candidates:
            return None
        victim = max(candidates, key=lambda s: s.order)
        self.prefilling.remove(victim)
        self._register_prefix(victim)
        self._release_seq(victim)
        victim.pos = 0
        victim.prefix_matched = 0
        self.preemptions_total += 1
        return victim

    def preempt_newest(self, protect: PagedSeq | None = None
                       ) -> PagedSeq | None:
        """Evict the newest running sequence (≠ ``protect``) for
        recompute: free its blocks, queue it at the preempted head.
        Returns the victim, or None when nobody is evictable."""
        candidates = [s for s in self.running if s is not protect]
        if not candidates:
            return None
        victim = max(candidates, key=lambda s: s.order)
        self.running.remove(victim)
        self._register_prefix(victim)
        self._release_seq(victim)
        # Recompute input: everything decoded so far rides the new
        # prompt, so prefill reconstructs the exact cache state (greedy
        # or seeded sampling — history is replayed, not re-drawn).
        # CALLERS MUST DRAIN FIRST: req.generated is the replay source,
        # and an undrained window here would replay a cache one-or-more
        # tokens short (a value-equality heuristic cannot detect that —
        # greedy decode repeats tokens routinely), so assert instead.
        gen = list(getattr(victim.req, "generated", []))
        assert victim.last_token < 0 or (
            gen and gen[-1] == victim.last_token), \
            "preempt_newest called with undrained window tokens"
        victim.tokens = np.concatenate(
            [np.asarray(victim.req.prompt[:victim.req.prompt_len],
                        np.int32),
             np.asarray(gen, np.int32)]) if gen else \
            np.asarray(victim.req.prompt[:victim.req.prompt_len], np.int32)
        victim.pos = 0
        victim.prefix_matched = 0
        victim.inflight = 0
        victim.preemptions += 1
        self.preemptions_total += 1
        self.preempted.appendleft(victim)
        if self.reqtrace is not None:
            self.reqtrace.note_preempt(victim.req.rid, reason="capacity")
        return victim

    def ensure_decode_capacity(self, tokens_per_tick: int = 1
                               ) -> list[PagedSeq]:
        """Grant every running sequence room for ``tokens_per_tick``
        more tokens past its in-flight bound, preempting newest-first
        on shortfall. Returns the victims (the engine re-queues them).
        A lone un-growable sequence is left to the engine to
        force-finish — preempting the only occupant would livelock.

        Speculative ticks pass the full k+1-token span, but a sequence
        can run degraded on any prefix of it (the spec kernel's per-seq
        ``limit`` clamps acceptance to backed capacity), so a span
        shortfall falls back to the +1 grant before it ever preempts —
        identical eviction pressure to the non-speculative policy.

        Ensure targets cap at the per-sequence block capacity so a
        near-the-limit sequence never grows its table past the width
        ladder (the engine's length limit truncates its commit)."""
        cap = self.max_blocks_per_seq * self.allocator.block_size
        victims: list[PagedSeq] = []
        for seq in list(self.running):
            if seq not in self.running:
                continue  # already evicted this sweep
            while not seq.blocks.ensure(min(seq.pos + seq.inflight
                                            + tokens_per_tick, cap)):
                if tokens_per_tick > 1 and seq.blocks.ensure(
                        min(seq.pos + seq.inflight + 1, cap)):
                    break  # degraded span: clamp, don't evict
                v = self.preempt_newest(protect=seq)
                if v is None:
                    return victims  # engine handles the stuck lone seq
                victims.append(v)
        return victims

    # ---- shape selection ----

    def decode_shape(self) -> tuple[int, int]:
        """(batch bucket, width bucket) for the current running set."""
        n = len(self.running)
        w = max((len(s.blocks.blocks) for s in self.running), default=1)
        return pick_bucket(n, self.batch_buckets), \
            pick_bucket(w, self.width_buckets)

    def payload(self) -> dict:
        return {"running": len(self.running),
                "prefilling": len(self.prefilling),
                "preempted": len(self.preempted),
                "max_slots": self.max_slots,
                "chunk": self.chunk,
                "batch_buckets": self.batch_buckets,
                "width_buckets": self.width_buckets,
                "admitted_total": self.admitted_total,
                "deferred_total": self.deferred_total,
                "preemptions_total": self.preemptions_total,
                "prefix_tokens_skipped_total":
                    self.prefix_tokens_skipped_total,
                "prefix": (self.prefix_tree.payload()
                           if self.prefix_tree is not None else None),
                "allocator": self.allocator.payload()}
