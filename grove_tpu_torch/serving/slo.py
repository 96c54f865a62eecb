"""Serving SLO telemetry: the request-lifecycle signals the control plane
scales on (docs/design/serving-slo.md).

The port's copy of ``grove_tpu/serving/slo.py``; it takes ``_Hist`` and
``quantile_from_buckets`` from the port's own ``serving/metrics.py``.

``EngineTelemetry`` is the engine-side half: every tracked ``Request`` is
stamped at enqueue / admit / first-token / completion (host wall-clock
stamps only: nothing here touches the device or a captured graph), and
completions derive

- queue-wait      (enqueue → admit: how long the request sat queued),
- TTFT            (enqueue → first sampled token; the user-facing SLO),
- TPOT            (inter-token time over the decode phase),
- e2e latency     (enqueue → done),

into fixed-bucket histograms with pinned buckets (the same shape the
control plane's metrics hub renders, so ``quantile_from_buckets`` gives
the estimate a deployed alert would compute). Completion bookkeeping is
windowed (``host_sync_interval``), so completion-side stamps are observed
at drain time, up to interval-1 steps late by design; the enqueue/admit
stamps are exact.

Chunked prefill (the paged engine) refines the first-token stamp:
``first_token_ts`` lands when the CHUNK that produces the token
completes, not at batch-wide prefill completion. ``admit_ts`` stays
queue exit; GROVE_TTFT_COMPAT=1 fuses the two. Both engines route through
one stamp helper (engine._stamp_admit_impl), so the split cannot drift
between them.

``snapshot()`` compresses the histograms into the percentile digest the
batched push ships (serving/metrics_push.push_samples): per-metric value
+ aggregation mode, so the control plane's MetricsRegistry knows summing
a p99 across reporters is wrong (max/avg instead).
"""

from __future__ import annotations

import threading
import time

from grove_tpu_torch.serving.metrics import _Hist, quantile_from_buckets

# Pinned buckets (seconds). A tiny CPU test engine lands in the
# sub-100ms bands; a loaded production engine under a traffic ramp can
# queue for tens of seconds — the default duration buckets would
# flatten one end or the other.
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                2.5, 5.0, 10.0, 30.0, 60.0)
# Inter-token time: decode steps are ms-scale on real chips,
# sub-ms-to-ms on the CPU test mesh.
TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0)
QUEUE_WAIT_BUCKETS = TTFT_BUCKETS
E2E_BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
               30.0, 60.0, 120.0)

# Histogram name -> pinned buckets (the engine-side metric catalog;
# serving_smoke asserts these render populated).
HISTOGRAMS = {
    "queue_wait_seconds": QUEUE_WAIT_BUCKETS,
    "ttft_seconds": TTFT_BUCKETS,
    "tpot_seconds": TPOT_BUCKETS,
    "e2e_latency_seconds": E2E_BUCKETS,
}


class EngineTelemetry:
    """Host-side request-lifecycle accounting for one serving engine.

    Thread-safe (the push pump reads snapshots while the decode loop
    observes completions), but every observation is a few dict/list
    ops: nothing here touches a device, and nothing runs per token
    (tokens are counted once per drained window)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists = {name: _Hist(buckets)
                       for name, buckets in HISTOGRAMS.items()}
        self.requests_completed = 0
        self.tokens_total = 0
        # Point-sampled gauges (latest value wins, like any gauge).
        self.queue_depth = 0
        self.kv_utilization = 0.0
        # Latest memory accounting from the data-plane observatory
        # (serving/xprof.py memory_snapshot shape; None until the
        # observatory samples once). Rides the same digest as
        # TTFT/TPOT so the autoscaler and /debug/serving see memory
        # pressure, not just latency.
        self.memory: dict | None = None
        # Latest prefix-cache accounting (engine.prefix_stats shape:
        # hit_rate/cached_blocks/cached_bytes/reclaimed_bytes/...;
        # None until the engine samples once, or forever when
        # GROVE_PREFIX_CACHE=0).
        self.prefix: dict | None = None
        # Latest speculative-decoding accounting (engine.spec_stats
        # shape: acceptance_rate/accepted_per_dispatch/counters; None
        # until the engine samples once, or forever when
        # GROVE_SPEC_DECODE=0).
        self.spec: dict | None = None
        # Latest disaggregated-handoff accounting (engine.handoff_view
        # shape: requests/blocks/shared_blocks/bytes/deferred/seconds
        # + per-request derivatives; None until a handoff lands, or
        # forever when GROVE_DISAGG=0).
        self.handoff: dict | None = None
        # Latest per-phase attribution stats (reqtrace.phase_stats
        # shape: {phase: {count, total_s, dominant, p50_ms, p99_ms}};
        # None until the engine samples once, or forever when
        # GROVE_REQTRACE=0).
        self.phases: dict | None = None
        # Exemplar linkage (docs/design/request-tracing.md): the WORST
        # observed request per latency metric, by rid — the digest's
        # percentile rows carry these so a breached p99 resolves to a
        # full trace via ``grovectl request-trace <rid>``. The
        # slowest-K retained ring on the reqtrace side guarantees the
        # exemplar's trace outlives ring churn.
        self.exemplars: dict[str, dict] = {}

    # ---- engine-side hooks ----

    def sample_gauges(self, queue_depth: int,
                      kv_utilization: float) -> None:
        self.queue_depth = queue_depth
        self.kv_utilization = kv_utilization

    def sample_memory(self, mem: dict) -> None:
        """Latest engine memory accounting (xprof.memory_snapshot
        payload: kv_cache/weight/workspace/total bytes, kv_headroom,
        source) — point-sampled like the gauges."""
        self.memory = mem

    def sample_prefix(self, stats: dict) -> None:
        """Latest prefix-cache accounting (engine.prefix_stats payload:
        hit_rate, cached_blocks, cached/reclaimed bytes, cow_copies) —
        point-sampled like the gauges; rides the same digest so the
        autoscaler sees reuse alongside latency."""
        self.prefix = stats

    def sample_spec(self, stats: dict) -> None:
        """Latest speculative-decoding accounting (engine.spec_stats
        payload: acceptance_rate, accepted_per_dispatch, per-bucket
        counters) — point-sampled like the gauges; a low acceptance
        rate in the digest is the signal to shrink spec_k or swap the
        draft."""
        self.spec = stats

    def sample_handoff(self, stats: dict) -> None:
        """Latest prefill→decode handoff accounting (engine
        handoff_view payload: requests, cold/shared block counts,
        transfer bytes, deferred adoptions, per-request ms) —
        point-sampled like the gauges; a rising ms_per_request or
        deferred count in the digest is the transfer seam saturating."""
        self.handoff = stats

    def sample_phases(self, stats: dict) -> None:
        """Latest per-phase p99 attribution (reqtrace.phase_stats
        payload) — point-sampled like the gauges; the digest's
        "why slow" breakdown next to the "how slow" percentiles."""
        self.phases = stats

    def add_tokens(self, n: int) -> None:
        """Decoded-token counter, bumped once per drained window (NOT
        per token — the drain already walks the window)."""
        if n > 0:
            with self._lock:
                self.tokens_total += n

    def observe_request(self, req) -> None:
        """Fold one completed request's stamps into the histograms.
        ``req`` needs enqueue_ts/admit_ts/first_token_ts/done_ts floats
        (0.0 = never stamped) and a ``generated`` list."""
        done = req.done_ts or time.time()
        enq = req.enqueue_ts or req.admit_ts or done
        admit = req.admit_ts or enq
        first = req.first_token_ts or admit
        n_gen = len(req.generated)
        rid = getattr(req, "rid", -1)
        with self._lock:
            self.requests_completed += 1
            self._observe("queue_wait_seconds", max(0.0, admit - enq),
                          rid)
            self._observe("ttft_seconds", max(0.0, first - enq), rid)
            self._observe("e2e_latency_seconds", max(0.0, done - enq),
                          rid)
            if n_gen > 1:
                # The first token is the prefill's; the remaining
                # n_gen-1 are decode steps — TPOT is their mean pace.
                self._observe("tpot_seconds",
                              max(0.0, done - first) / (n_gen - 1), rid)

    def _observe(self, name: str, value: float,
                 rid: int = -1) -> None:
        h = self._hists[name]
        for i, ub in enumerate(h.buckets):
            if value <= ub:
                h.counts[i] += 1
                break
        else:
            h.counts[-1] += 1
        h.sum += value
        h.count += 1
        if rid >= 0:
            ex = self.exemplars.get(name)
            if ex is None or value > ex["value_s"]:
                self.exemplars[name] = {"rid": rid,
                                        "value_s": value}

    # ---- read surface ----

    def hist_count(self, name: str) -> int:
        with self._lock:
            return self._hists[name].count

    def quantile(self, name: str, q: float) -> float:
        """Bucket-interpolated quantile estimate (the same
        histogram_quantile a deployed Prometheus computes)."""
        with self._lock:
            h = self._hists[name]
            cum, c = {}, 0
            for ub, n in zip(h.buckets, h.counts):
                c += n
                cum[ub] = float(c)
            cum[float("inf")] = float(c + h.counts[-1])
        return quantile_from_buckets(q, cum)

    def snapshot(self) -> dict:
        """Percentile digest + gauges — the payload ``samples_for_push``
        turns into one batched push."""
        with self._lock:
            counts = {n: h.count for n, h in self._hists.items()}
            means = {n: (h.sum / h.count if h.count else 0.0)
                     for n, h in self._hists.items()}
            completed = self.requests_completed
            tokens = self.tokens_total
            exemplars = {n: dict(ex)
                         for n, ex in self.exemplars.items()}
        return {
            "exemplars": exemplars,
            "phases": self.phases,
            "queue_depth": self.queue_depth,
            "kv_utilization": self.kv_utilization,
            "memory": self.memory,
            "prefix": self.prefix,
            "spec": self.spec,
            "handoff": self.handoff,
            "requests_completed": completed,
            "tokens_total": tokens,
            "ttft_p50_s": self.quantile("ttft_seconds", 0.5),
            "ttft_p99_s": self.quantile("ttft_seconds", 0.99),
            "tpot_p50_s": self.quantile("tpot_seconds", 0.5),
            "tpot_p99_s": self.quantile("tpot_seconds", 0.99),
            "queue_wait_p99_s": self.quantile("queue_wait_seconds", 0.99),
            "e2e_p99_s": self.quantile("e2e_latency_seconds", 0.99),
            "counts": counts,
            "means": means,
        }


def samples_for_push(telemetry: EngineTelemetry) -> list[dict]:
    """The batched-push sample list for one engine's current state.

    Aggregation modes ride along with each sample so the registry
    combines multi-reporter values correctly WITHOUT name-sniffing:
    load signals sum (total queue depth drives scaling), utilizations
    average, worst-case latencies max (a 2-replica PCSG's p99 TTFT is
    its worst replica's, not their sum — the bug this plane fixes).
    """
    s = telemetry.snapshot()
    ms = 1000.0
    samples = []
    if s.get("memory"):
        mem = s["memory"]
        # Memory pressure alongside latency: headroom averages (the
        # scope's usable slack), byte totals sum across replicas.
        samples += [
            {"metric": "kv_headroom_frac",
             "value": float(mem.get("kv_headroom", 0.0)), "agg": "avg"},
            {"metric": "kv_cache_bytes",
             "value": float(mem.get("kv_cache_bytes", 0)), "agg": "sum"},
            {"metric": "hbm_total_bytes",
             "value": float(mem.get("total_bytes", 0)), "agg": "sum"},
        ]
    if s.get("prefix"):
        pfx = s["prefix"]
        # Prefix-cache reuse: hit-rate averages (a scope-level reuse
        # ratio), block/byte totals sum across replicas.
        samples += [
            {"metric": "prefix_hit_rate",
             "value": float(pfx.get("hit_rate", 0.0)), "agg": "avg"},
            {"metric": "prefix_cached_blocks",
             "value": float(pfx.get("cached_blocks", 0)), "agg": "sum"},
            {"metric": "prefix_reclaimed_bytes",
             "value": float(pfx.get("reclaimed_bytes", 0)), "agg": "sum"},
        ]
    if s.get("spec"):
        sp = s["spec"]
        # Speculation efficiency: rates average across replicas (a
        # scope-level acceptance ratio), the accepted-token counter
        # sums.
        samples += [
            {"metric": "spec_acceptance_rate",
             "value": float(sp.get("acceptance_rate", 0.0)),
             "agg": "avg"},
            {"metric": "spec_accepted_per_dispatch",
             "value": float(sp.get("accepted_per_dispatch", 0.0)),
             "agg": "avg"},
            {"metric": "spec_accepted_tokens",
             "value": float(sp.get("accepted_tokens", 0)), "agg": "sum"},
        ]
    if s.get("phases"):
        # p99 attribution (serving/reqtrace.py): per-phase p99 wall
        # rides the digest so the control plane sees WHERE the tail
        # lives, not just how long it is. Worst replica wins (max),
        # like the other tail latencies. These are also the
        # ``request_phase_p99_ms`` rows the bench history/dashboard
        # "p99 attribution" section consumes.
        samples += [
            {"metric": f"request_phase_p99_ms:{phase}",
             "value": float(d.get("p99_ms", 0.0)), "agg": "max"}
            for phase, d in sorted(s["phases"].items())
        ]
    if s.get("handoff"):
        ho = s["handoff"]
        # Disaggregation seam health: block/byte totals sum across
        # replica pairs, the per-request transfer cost averages (a
        # scope-level seam latency).
        samples += [
            {"metric": "handoff_blocks",
             "value": float(ho.get("blocks", 0)), "agg": "sum"},
            {"metric": "handoff_bytes",
             "value": float(ho.get("bytes", 0)), "agg": "sum"},
            {"metric": "handoff_ms_per_request",
             "value": float(ho.get("ms_per_request", 0.0)),
             "agg": "avg"},
        ]
    return samples + [
        {"metric": "queue_depth", "value": float(s["queue_depth"]),
         "agg": "sum"},
        {"metric": "kv_utilization", "value": float(s["kv_utilization"]),
         "agg": "avg"},
        {"metric": "ttft_p50_ms", "value": s["ttft_p50_s"] * ms,
         "agg": "avg"},
        {"metric": "ttft_p99_ms", "value": s["ttft_p99_s"] * ms,
         "agg": "max"},
        {"metric": "tpot_p50_ms", "value": s["tpot_p50_s"] * ms,
         "agg": "avg"},
        {"metric": "tpot_p99_ms", "value": s["tpot_p99_s"] * ms,
         "agg": "max"},
        {"metric": "queue_wait_p99_ms",
         "value": s["queue_wait_p99_s"] * ms, "agg": "max"},
        {"metric": "e2e_p99_ms", "value": s["e2e_p99_s"] * ms,
         "agg": "max"},
        {"metric": "requests_completed",
         "value": float(s["requests_completed"]), "agg": "sum"},
        {"metric": "tokens_total", "value": float(s["tokens_total"]),
         "agg": "sum"},
    ]
