"""What the traffic loop sees of the program: each request's tokens, stamped
when the host first sees them, and the dispatch accounting of an interval.

The loop calls ``poll`` after every call into the engine, so a token is
stamped at the first return to the loop after the fetch that brought it
to the host (a window drain, or a prompt's first token). The engine's own
counters ``steps`` (decode dispatches) and ``chunks`` (prefill-chunk
dispatches) count the work; which request a chunk served is worked out as
the engine schedules it: prompts are admitted and prefilled first in, first
out, one chunk of ``c`` tokens per tick, each chunk of the oldest prompt not
yet prefilled. A first token that arrives before its prompt's chunks add up
(a prefix-cache hit, a preemption) marks the chunk record unsound, and what
reads it then reads nothing.

Every quarter second ``poll`` also reads the KV pool's blocks in use and
held by the prefix cache from the engine's allocator counters
(``payload()``), for the log's line on the pool's occupancy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

POOL_EVERY_S = 0.25


@dataclasses.dataclass(eq=False)
class Track:
    rid: int
    req: object                 # the engine's Request: its tokens
    due: float                  # host clock when the request was due
    prompt_len: int
    in_window: bool
    prefilled: int = 0          # prompt tokens prefilled (worked out)
    stamps: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return bool(self.req.done) and len(self.stamps) == len(
            self.req.generated)


@dataclasses.dataclass
class Account:
    """The work of an interval: decode dispatches and the rows (tokens)
    they produced with the context each attended over; prefill chunks as
    (offset, valid) pairs, or None where the chunk record is unsound; the
    prompts whose last chunk ran in it."""

    decode_dispatches: int
    chunk_dispatches: int
    decode_rows: int
    decode_ctx_sum: int
    chunks: list | None
    prompts_done: int
    chunk_width: int


def submit(engine, prompt: np.ndarray, max_new: int):
    """Submit one request; returns (rid, the engine's Request). The Request
    is the one the submit queued (``engine._queue``, the engine's intake),
    checked by its id."""
    rid = engine.submit(prompt, max_new_tokens=max_new)
    req = engine._queue[-1]
    if req.rid != rid:
        raise RuntimeError(f"submit returned rid {rid}, queued {req.rid}")
    return rid, req


class Observer:
    def __init__(self, engine, chunk_width: int):
        self.engine = engine
        self.c = chunk_width
        self.tracks: list[Track] = []
        self._live: list[Track] = []
        self._pf = 0                     # oldest track not yet prefilled
        self.chunk_log: list[tuple[float, int, int]] = []  # (t, off, valid)
        self.prompt_done: list[float] = []
        self.sound = True
        self._chunks = engine.chunks
        self.pool_log: list[tuple[float, int, int, int]] = []

    def add(self, rid: int, req, due: float, in_window: bool) -> Track:
        t = Track(rid=rid, req=req, due=due, prompt_len=int(req.prompt_len),
                  in_window=in_window)
        self.tracks.append(t)
        self._live.append(t)
        return t

    def poll(self, now: float) -> None:
        """Stamp new tokens and the chunks dispatched since the last poll."""
        n = self.engine.chunks - self._chunks
        self._chunks = self.engine.chunks
        for _ in range(n):
            self._note_chunk(now)
        keep = []
        for t in self._live:
            got = len(t.req.generated)
            if got > len(t.stamps):
                if not t.stamps and t.prefilled != t.prompt_len:
                    self.sound = False
                t.stamps.extend([now] * (got - len(t.stamps)))
            if not t.done:
                keep.append(t)
        self._live = keep
        if not self.pool_log or now - self.pool_log[-1][0] >= POOL_EVERY_S:
            a = self.engine.payload()["schedule"]["allocator"]
            self.pool_log.append((now, a["used"], a["cached"],
                                  a["capacity"]))

    def _note_chunk(self, now: float) -> None:
        while self._pf < len(self.tracks) and \
                self.tracks[self._pf].prefilled >= \
                self.tracks[self._pf].prompt_len:
            self._pf += 1
        if self._pf >= len(self.tracks):
            self.sound = False
            return
        t = self.tracks[self._pf]
        valid = min(self.c, t.prompt_len - t.prefilled)
        self.chunk_log.append((now, t.prefilled, valid))
        t.prefilled += valid
        if t.prefilled >= t.prompt_len:
            self.prompt_done.append(now)

    def tokens_between(self, t0: float, t1: float) -> int:
        return sum(sum(1 for s in t.stamps if t0 <= s <= t1)
                   for t in self.tracks)

    def pool(self, t0: float, t1: float) -> dict | None:
        """The pool's blocks in use in [t0, t1]: peak and mean over the
        samples, the prefix cache's peak, and the capacity."""
        got = [x for x in self.pool_log if t0 <= x[0] <= t1]
        if not got:
            return None
        used = [u for _, u, _, _ in got]
        return {"used_peak": max(used), "used_mean": sum(used) / len(used),
                "cached_peak": max(c for _, _, c, _ in got),
                "capacity": got[-1][3], "samples": len(got)}

    def account(self, t0: float, t1: float, steps: int, chunks: int
                ) -> Account:
        """The work stamped in [t0, t1]; ``steps`` and ``chunks`` are the
        engine's dispatch counts over the same interval."""
        rows = ctx = 0
        for t in self.tracks:
            for k, s in enumerate(t.stamps):
                if k and t0 <= s <= t1:
                    rows += 1
                    ctx += t.prompt_len + k
        log = [(o, v) for (s, o, v) in self.chunk_log if t0 <= s <= t1]
        sound = self.sound and len(log) == chunks
        return Account(decode_dispatches=steps, chunk_dispatches=chunks,
                       decode_rows=rows, decode_ctx_sum=ctx,
                       chunks=log if sound else None,
                       prompts_done=sum(1 for s in self.prompt_done
                                        if t0 <= s <= t1),
                       chunk_width=self.c)
