"""Request observatory — per-request tracing and p99 latency attribution
for the serving path (docs/design/request-tracing.md).

The port's copy of ``grove_tpu/serving/reqtrace.py``; its default sink is
the port's ``serving/metrics.GLOBAL_METRICS``.

The SLO layer (serving/slo.py) can say THAT p99 TTFT breached; it cannot
say WHY: a request crosses up to three tiers (prefix cache → prefill
engine → handoff → paged decode with speculation). This module gives
every sampled request a story: a bounded host-side span recorder stamping
the seams the engine already crosses —

- enqueue / admit        (queue_wait: how long it sat before work),
- prefix-cache match     (blocks hit/missed at admission),
- prefill chunks         (bucket-labelled, one span per sampled chunk),
- handoff                (detach → copy → adopt; the trace rides
                          ``HandoffPayload.trace`` so ONE trace spans
                          both tiers of GROVE_DISAGG=1),
- decode segments        (split at preemption/recompute boundaries),
- speculation windows    (per-window acceptance),
- completion.

On top of the ring sit two consumers:

- **p99 attribution** — each finished trace classifies its dominant phase
  (argmax of accumulated per-phase seconds), feeding the
  ``grove_request_phase_seconds{phase}`` histogram family; a slowest-K
  retained ring holds the worst traces by e2e so the tail is never
  sampled away by ring churn.
- **exemplar linkage** — the SLO digest's percentile rows carry exemplar
  request ids (worst observed value per metric, tracked by
  ``EngineTelemetry``) that resolve to full traces here.

Everything is host-side dict/list work: nothing here touches the device
or a captured graph. Per-request seam stamps (enqueue/admit/handoff/done)
are unconditional: once per request, never per step. Per-TICK decoration
(prefill chunk spans, spec windows) rides the sampling gate
(``should_sample()``). ``GROVE_REQTRACE=0``: engines construct with
``reqtrace=None`` and every call site guards on it, so the token stream
is the same.

A chunk span's seconds come from the engine's device timer: on the card
CUDA events around the chunk, resolved at the next fetch the engine makes
anyway (``note_chunk`` then takes the dispatch's wall clock as ``t0``),
so no span costs a device sync.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
import weakref

# Attribution taxonomy: the phase buckets a finished trace's wall time
# is split into. Dominant phase = argmax — the one-word answer to
# "why was this request slow". ``spec`` never appears here: spec
# windows are decode dispatches and accumulate as decode time; the
# per-window spans carry the acceptance detail instead.
PHASES = ("queue_wait", "prefix_match", "prefill", "handoff",
          "decode", "preempt_recompute")

# Spans one trace may hold before it starts dropping (a pathological
# 100k-token decode must not grow an unbounded span list — phase
# accumulation keeps counting; only the span detail is shed).
SPAN_CAP = 512


def enabled() -> bool:
    """The observatory kill switch, read at engine construction (same
    contract as GROVE_XPROF/GROVE_TRACE: 0 = the exact pre-feature
    hot path — no recorder, no branches taken, no stamps)."""
    return os.environ.get("GROVE_REQTRACE", "1") != "0"


@dataclasses.dataclass
class Span:
    phase: str
    label: str
    t0: float          # absolute wall-clock start
    seconds: float
    detail: dict | None = None


class RequestTrace:
    """One request's span timeline plus its per-phase accumulation.

    Mutated only under the owning observatory's lock. ``marks`` holds
    open-segment start stamps (prefill_start/decode_start/
    preempt_start) between the seam calls that close them.
    """

    __slots__ = ("rid", "created_ts", "spans", "dropped_spans",
                 "phase_seconds", "marks", "done_ts", "dominant",
                 "e2e_s")

    def __init__(self, rid: int, created_ts: float) -> None:
        self.rid = rid
        self.created_ts = created_ts
        self.spans: list[Span] = []
        self.dropped_spans = 0
        self.phase_seconds: dict[str, float] = {}
        self.marks: dict[str, float] = {}
        self.done_ts = 0.0
        self.dominant: str | None = None
        self.e2e_s = 0.0

    def add_span(self, phase: str, label: str, t0: float,
                 seconds: float, detail: dict | None = None,
                 accumulate: bool = True) -> None:
        if accumulate:
            self.phase_seconds[phase] = \
                self.phase_seconds.get(phase, 0.0) + max(0.0, seconds)
        if len(self.spans) >= SPAN_CAP:
            self.dropped_spans += 1
            return
        self.spans.append(Span(phase, label, t0, seconds, detail))

    def classify(self) -> str:
        """Dominant phase: argmax of accumulated seconds. A trace with
        no accumulation (dropped mid-flight) attributes to queue_wait
        — the only phase every request provably entered."""
        if not self.phase_seconds:
            return "queue_wait"
        return max(self.phase_seconds, key=self.phase_seconds.get)

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "created_ts": round(self.created_ts, 6),
            "done": bool(self.done_ts),
            "e2e_s": round(self.e2e_s, 6),
            "dominant": self.dominant,
            "phases": {p: round(s, 6)
                       for p, s in self.phase_seconds.items()},
            "dropped_spans": self.dropped_spans,
            "spans": [{
                "phase": s.phase,
                "label": s.label,
                "t0_off_ms": round((s.t0 - self.created_ts) * 1e3, 3),
                "ms": round(s.seconds * 1e3, 3),
                **({"detail": s.detail} if s.detail else {}),
            } for s in sorted(self.spans, key=lambda s: s.t0)],
        }


class RequestObservatory:
    """Bounded per-request span recorder for one engine (or one shared
    disagg pair — ``make_disagg`` hands BOTH tiers the same instance,
    like the shared ``EngineTelemetry``, so a trace spans the seam).

    Three rings, all bounded:

    - ``_live``: in-flight traces keyed by rid (capped; a submit storm
      past the cap drops new traces and counts them — never grows).
    - ``_ring``: finished traces, newest-N (deque, evictions counted
      into ``grove_reqtrace_dropped_total`` so churn is visible).
    - ``_slowest``: top-K finished traces by e2e — the tail the ring
      would otherwise sample away. p99 exemplars resolve here long
      after the ring has churned past them.
    """

    def __init__(self, capacity: int | None = None,
                 sample_every: int | None = None,
                 slowest_k: int | None = None,
                 live_cap: int | None = None,
                 metrics=None, name: str | None = None,
                 namespace: str = "default") -> None:
        if metrics is None:
            from grove_tpu_torch.serving.metrics import GLOBAL_METRICS
            metrics = GLOBAL_METRICS
        if capacity is None:
            capacity = int(os.environ.get("GROVE_REQTRACE_RING", 256))
        if sample_every is None:
            sample_every = int(os.environ.get("GROVE_REQTRACE_SAMPLE", 4))
        if slowest_k is None:
            slowest_k = int(os.environ.get("GROVE_REQTRACE_SLOWEST", 8))
        if live_cap is None:
            live_cap = int(os.environ.get("GROVE_REQTRACE_LIVE", 4096))
        self.capacity = max(1, capacity)
        self.sample_every = max(1, sample_every)
        self.slowest_k = max(1, slowest_k)
        self.live_cap = max(1, live_cap)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._live: dict[int, RequestTrace] = {}
        self._ring: collections.deque[RequestTrace] = collections.deque(
            maxlen=self.capacity)
        self._slowest: list[RequestTrace] = []
        self._ticks = 0
        self.dropped = 0
        self.finished_total = 0
        self._phase_cache: tuple = (None, {})
        self.namespace = namespace
        self.name = name or _next_auto_name()
        register(self)

    # ---- sampling gate (the per-tick decoration gate; seam stamps
    # are unconditional and never route through it) ----

    def should_sample(self) -> bool:
        """Every Nth TICK's chunk/window decoration is recorded — one
        modulo per tick, the same 1/N shape as xprof's FlightRecorder.
        Phase attribution does NOT depend on this: phase seconds come
        from the unconditional seam stamps, so sampling only thins the
        per-chunk span detail."""
        self._ticks += 1
        return (self._ticks - 1) % self.sample_every == 0

    def _drop(self, n: int = 1) -> None:
        self.dropped += n
        self._metrics.inc("grove_reqtrace_dropped_total", n)

    # ---- seam hooks (unconditional: once per request per seam) ----

    def note_enqueue(self, rid: int, ts: float | None = None,
                     prompt_len: int = 0,
                     max_new_tokens: int = 0) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            if rid in self._live:
                return
            if len(self._live) >= self.live_cap:
                self._drop()
                return
            t = RequestTrace(rid, ts)
            t.add_span("queue_wait", "enqueued", ts, 0.0,
                       {"prompt_len": int(prompt_len),
                        "max_new_tokens": int(max_new_tokens)},
                       accumulate=False)
            self._live[rid] = t

    def note_admit(self, rid: int, ts: float | None = None) -> None:
        """Queue exit: closes queue_wait, opens the prefill segment."""
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.get(rid)
            if t is None or "prefill_start" in t.marks:
                return
            t.add_span("queue_wait", "", t.created_ts,
                       ts - t.created_ts)
            t.marks["prefill_start"] = ts

    def note_prefix(self, rid: int, matched_blocks: int,
                    total_blocks: int, matched_tokens: int,
                    seconds: float = 0.0) -> None:
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            t.add_span("prefix_match",
                       f"{matched_blocks}/{total_blocks} blocks",
                       time.time() - seconds, seconds,
                       {"matched_tokens": matched_tokens})

    def note_chunk(self, rid: int, bucket: int, seconds: float,
                   tokens: int, t0: float | None = None) -> None:
        """One sampled prefill chunk (bucket-labelled). Decoration
        only: prefill phase seconds accumulate from the admit →
        prefill-done boundaries, so thinning chunks never skews
        attribution. MUST stay behind the sampling gate inside
        ``_prefill_tick``. ``t0``: the chunk's start on the wall clock,
        when it is noted after the fact (an event-timed chunk resolved
        at a later fetch); default now - seconds."""
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            t.add_span("prefill", f"chunk[{bucket}]",
                       time.time() - seconds if t0 is None else t0,
                       seconds, {"tokens": tokens}, accumulate=False)

    def note_prefill_done(self, rid: int,
                          ts: float | None = None) -> None:
        """Prefill completion. If the sequence was replaying a
        preemption recompute, the elapsed prefill counts as
        preempt_recompute — recovery work, not first-pass prefill."""
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            start = t.marks.pop("prefill_start", None)
            if start is None:
                return
            phase = ("preempt_recompute" if "preempt_start" in t.marks
                     else "prefill")
            t.add_span(phase, "prefill" if phase == "prefill"
                       else "recompute-prefill", start, ts - start)

    def note_handoff(self, rid: int, detach_ts: float,
                     ts: float | None = None, blocks: int = 0,
                     nbytes: int = 0, shared: int = 0) -> None:
        """Detach → remap/copy → adopt, measured from the payload's
        ``created_ts``. Opens the decode segment on the adopting
        tier."""
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            t.add_span("handoff", f"{blocks} blocks"
                       + (f" ({shared} shared)" if shared else ""),
                       detach_ts, ts - detach_ts, {"bytes": nbytes})

    def note_decode_start(self, rid: int,
                          ts: float | None = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            t.marks.setdefault("decode_start", ts)

    def note_preempt(self, rid: int, ts: float | None = None,
                     reason: str = "capacity") -> None:
        """Preemption boundary: closes the open decode segment, opens
        the preempt_recompute segment. Called from the scheduler's
        victim path and the prefill-victim requeue — NEVER sampled;
        a preemption-storm request's attribution must survive."""
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            start = t.marks.pop("decode_start", None)
            if start is not None:
                t.add_span("decode", "segment", start, ts - start)
            t.marks["preempt_start"] = ts
            t.add_span("preempt_recompute", f"preempted ({reason})",
                       ts, 0.0, accumulate=False)

    def note_resume(self, rid: int, ts: float | None = None) -> None:
        """Recompute replay finished and the sequence is back in
        decode: closes preempt_recompute, reopens the decode
        segment."""
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            start = t.marks.pop("preempt_start", None)
            if start is not None:
                t.add_span("preempt_recompute", "resumed", start,
                           ts - start)
            t.marks["decode_start"] = ts

    def note_spec_window(self, rid: int, window: int, accepted: int,
                         drafted: int) -> None:
        """One speculation window's acceptance (decode-phase detail;
        the window's wall already accumulates through the decode
        segment)."""
        with self._lock:
            t = self._live.get(rid)
            if t is None:
                return
            t.add_span("decode", f"spec[{window}] +{accepted}/{drafted}",
                       time.time(), 0.0,
                       {"accepted": accepted, "drafted": drafted},
                       accumulate=False)

    def note_done(self, rid: int, ts: float | None = None) -> None:
        """Completion: closes any open segment, classifies the
        dominant phase, feeds grove_request_phase_seconds{phase}, and
        retires the trace into the ring (and slowest-K if it
        qualifies)."""
        ts = time.time() if ts is None else ts
        with self._lock:
            t = self._live.pop(rid, None)
            if t is None:
                return
            start = t.marks.pop("decode_start", None)
            if start is not None:
                t.add_span("decode", "segment", start, ts - start)
            start = t.marks.pop("preempt_start", None)
            if start is not None:
                # Died while preempted (evicted/truncated): the wait
                # still attributes as recovery time.
                t.add_span("preempt_recompute", "unresolved", start,
                           ts - start)
            start = t.marks.pop("prefill_start", None)
            if start is not None:
                t.add_span("prefill", "prefill (at completion)",
                           start, ts - start)
            t.done_ts = ts
            t.e2e_s = max(0.0, ts - t.created_ts)
            t.dominant = t.classify()
            self.finished_total += 1
            if len(self._ring) == self._ring.maxlen:
                self._drop()
            self._ring.append(t)
            self._retain_slowest(t)
        for phase, secs in t.phase_seconds.items():
            self._metrics.observe("grove_request_phase_seconds", secs,
                                  phase=phase)

    def _retain_slowest(self, t: RequestTrace) -> None:
        s = self._slowest
        s.append(t)
        s.sort(key=lambda x: -x.e2e_s)
        del s[self.slowest_k:]

    # ---- disagg seam: the trace rides the HandoffPayload ----

    def live_trace(self, rid: int) -> RequestTrace | None:
        with self._lock:
            return self._live.get(rid)

    def adopt_trace(self, trace: RequestTrace | None) -> None:
        """Adopt a trace carried on a HandoffPayload. With the shared
        disagg recorder this is a no-op (the rid is already live);
        with per-tier recorders it splices the producer's spans into
        this tier's live set so the timeline stays one trace."""
        if trace is None:
            return
        with self._lock:
            if trace.rid in self._live:
                return
            if len(self._live) >= self.live_cap:
                self._drop()
                return
            self._live[trace.rid] = trace

    # ---- read surface ----

    def phase_stats(self) -> dict[str, dict]:
        """Per-phase stats over finished traces (ring ∪ slowest-K):
        count, total seconds, p99 ms, dominated count. Computed at
        read time — the record path stays append-only — and cached
        per completion count, so the engine's per-completion telemetry
        rider costs a dict lookup when nothing finished since."""
        key = (self.finished_total, self.dropped)
        if self._phase_cache[0] == key:
            return self._phase_cache[1]
        acc: dict[str, dict] = {}
        for t in self._finished():
            for phase, secs in t.phase_seconds.items():
                d = acc.setdefault(phase, {"count": 0, "total_s": 0.0,
                                           "dominant": 0, "_vals": []})
                d["count"] += 1
                d["total_s"] += secs
                d["_vals"].append(secs)
                if t.dominant == phase:
                    d["dominant"] += 1
        for d in acc.values():
            vals = sorted(d.pop("_vals"))
            d["total_s"] = round(d["total_s"], 6)
            d["p50_ms"] = round(vals[len(vals) // 2] * 1e3, 3)
            d["p99_ms"] = round(
                vals[min(len(vals) - 1, int(len(vals) * 0.99))] * 1e3, 3)
        self._phase_cache = (key, acc)
        return acc

    def _finished(self) -> list[RequestTrace]:
        with self._lock:
            seen: dict[int, RequestTrace] = {t.rid: t for t in self._ring}
            for t in self._slowest:
                seen.setdefault(t.rid, t)
            return list(seen.values())

    def find(self, rid: int) -> dict | None:
        """Resolve one rid to its trace dict — slowest-K first (the
        exemplar path), then the ring, then live in-flight traces."""
        with self._lock:
            for t in self._slowest:
                if t.rid == rid:
                    return t.to_dict()
            for t in reversed(self._ring):
                if t.rid == rid:
                    return t.to_dict()
            t = self._live.get(rid)
            return t.to_dict() if t is not None else None

    def payload(self) -> dict:
        """The /debug/requests payload (one shape for both client
        twins; ``render_request_trace`` and grovectl render it)."""
        with self._lock:
            traces = [t.to_dict() for t in self._ring]
            slowest = [t.to_dict() for t in self._slowest]
            live = len(self._live)
        return {
            "scope": {"namespace": self.namespace, "name": self.name},
            "sample_every": self.sample_every,
            "ring": {"len": len(traces), "capacity": self.capacity,
                     "finished_total": self.finished_total},
            "live": live,
            "dropped": self.dropped,
            "phases": self.phase_stats(),
            "slowest": slowest,
            "traces": traces,
        }


# ---- per-process recorder registry (the debug_requests surface) ----

_REGISTRY: "collections.OrderedDict[tuple[str, str], weakref.ref]" = \
    collections.OrderedDict()
_REGISTRY_CAPACITY = 64
_registry_lock = threading.Lock()
_auto_seq = [0]


def _next_auto_name() -> str:
    with _registry_lock:
        _auto_seq[0] += 1
        return f"engine-{_auto_seq[0]}"


def register(rec: RequestObservatory, name: str | None = None,
             namespace: str | None = None) -> None:
    """(Re)register a recorder under a scope. Engines auto-register as
    default/engine-N at construction; serving wrappers re-register
    under the control-plane scope name, so ``grovectl request-trace
    --name <name>`` finds it. Weakly held and LRU-capped, exactly the
    xprof registry shape."""
    if name is not None:
        rec.name = name
    if namespace is not None:
        rec.namespace = namespace
    key = (rec.namespace, rec.name)
    with _registry_lock:
        _REGISTRY.pop(key, None)
        _REGISTRY[key] = weakref.ref(rec)
        while len(_REGISTRY) > _REGISTRY_CAPACITY:
            _REGISTRY.popitem(last=False)


def recorder_for(name: str, namespace: str = "default",
                 ) -> RequestObservatory | None:
    with _registry_lock:
        ref = _REGISTRY.get((namespace, name))
        rec = ref() if ref is not None else None
        if ref is not None and rec is None:
            del _REGISTRY[(namespace, name)]
        return rec


def scopes() -> list[tuple[str, str]]:
    with _registry_lock:
        return [k for k, ref in _REGISTRY.items() if ref() is not None]


# ---- rendering (grovectl request-trace) ----

def render_request_trace(payload: dict, rid: int) -> list[str]:
    """Human rendering of one request's trace out of a
    /debug/requests payload: phase attribution (dominant starred),
    then the span timeline."""
    trace = None
    for t in (payload.get("slowest") or []) + (payload.get("traces")
                                               or []):
        if t.get("rid") == rid:
            trace = t
            break
    scope = payload.get("scope") or {}
    out = [f"engine:    {scope.get('namespace', '?')}/"
           f"{scope.get('name', '?')}"]
    if trace is None:
        out.append(f"request {rid}: no trace retained (ring "
                   f"{(payload.get('ring') or {}).get('len', 0)}/"
                   f"{(payload.get('ring') or {}).get('capacity', 0)}, "
                   f"dropped {payload.get('dropped', 0)})")
        return out
    state = "done" if trace.get("done") else "in flight"
    out.append(f"request:   rid {rid}  ({state}, "
               f"e2e {trace.get('e2e_s', 0.0) * 1e3:.1f} ms)")
    dominant = trace.get("dominant")
    phases = trace.get("phases") or {}
    if phases:
        out.append("")
        out.append(f"  {'phase':<19}{'seconds':>10}{'frac':>8}")
        total = sum(phases.values()) or 1.0
        for name in sorted(phases, key=lambda p: -phases[p]):
            star = " *" if name == dominant else ""
            out.append(f"  {name:<19}{phases[name]:>10.4f}"
                       f"{phases[name] / total * 100:>7.1f}%{star}")
    spans = trace.get("spans") or []
    if spans:
        out.append("")
        out.append(f"  {'+ms':>9}  {'dur ms':>9}  "
                   f"{'phase':<19}label")
        for s in spans:
            star = " *" if s.get("phase") == dominant else ""
            out.append(f"  {s.get('t0_off_ms', 0.0):>9.1f}  "
                       f"{s.get('ms', 0.0):>9.2f}  "
                       f"{s.get('phase', '?'):<19}"
                       f"{s.get('label', '')}{star}")
    if trace.get("dropped_spans"):
        out.append(f"  ({trace['dropped_spans']} spans dropped at "
                   f"cap {SPAN_CAP})")
    return out
