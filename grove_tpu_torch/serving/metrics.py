"""The port's metrics sink: Prometheus-style counters, gauges and
fixed-bucket histograms for the serving observatories.

A copy of the parts of ``grove_tpu/runtime/metrics.py`` that the port's
``serving/slo.py``, ``serving/xprof.py``, ``serving/reqtrace.py`` and
``serving/engine.py`` call: ``_Hist``, ``quantile_from_buckets`` and the
``MetricsHub`` methods ``describe``, ``describe_histogram``, ``inc``,
``set``, ``observe``, ``counter_total``, ``hist_totals`` and ``render``
(the text exposition format). ``GLOBAL_METRICS`` describes the series
those modules write, with the JAX package's names, help texts and pinned
buckets. The JAX hub's lock-order witness is left out.

Every observatory takes ``metrics=``: any object with ``inc``, ``set``
and ``observe`` of this signature (the control plane's hub inside a pod,
for one) receives the same series instead of this module's hub.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict

# Prometheus default duration buckets; upper bounds in seconds.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

# Sampled device time per step: tens of microseconds (a tiny CPU engine)
# to seconds (a degraded device); the duration defaults' 5 ms floor would
# flatten the healthy band.
DEVICE_STEP_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3,
                       2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25,
                       0.5, 1.0, 2.5)

# Build wall time: tens of milliseconds (an eager CPU closure, a small
# graph) to minutes (a large model's first capture).
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0)

# Per-phase request seconds: sub-millisecond queue waits to multi-second
# preemption storms.
REQUEST_PHASE_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                         0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                         60.0)


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...]) -> None:
        # Pinned at creation: rendering reads the buckets from here, so a
        # re-description cannot misattribute counts already taken.
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0


class MetricsHub:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = defaultdict(float)
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], _Hist] = {}
        self._buckets: dict[str, tuple[float, ...]] = {}
        self._help: dict[str, str] = {}

    def describe(self, name: str, help_text: str) -> None:
        self._help[name] = help_text

    def describe_histogram(self, name: str, help_text: str,
                           buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                           ) -> None:
        b = tuple(sorted(buckets))
        with self._lock:
            for (hname, _), h in self._hists.items():
                if hname == name and h.buckets != b:
                    raise ValueError(
                        f"histogram {name!r} already has observations "
                        f"with {len(h.buckets)} buckets; re-describing "
                        f"with {len(b)} would misattribute counts")
            self._help[name] = help_text
            self._buckets[name] = b

    # name and value are positional-only, so that "name" stays a legal
    # label key.
    def inc(self, name: str, value: float = 1.0, /, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] += value

    def set(self, name: str, value: float, /, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value: float, **labels) -> None:
        """One observation into the fixed-bucket histogram ``name``
        (buckets from ``describe_histogram``, else the duration
        defaults)."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist(
                    self._buckets.get(name, DEFAULT_BUCKETS))
            for i, ub in enumerate(h.buckets):
                if value <= ub:
                    h.counts[i] += 1
                    break
            else:
                h.counts[-1] += 1  # +Inf
            h.sum += value
            h.count += 1

    # ---- programmatic reads ----

    def counter_total(self, name: str) -> float:
        """Sum of counter ``name`` across every label set."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def hist_totals(self, name: str) -> tuple[float, float]:
        """(sum, count) of histogram ``name`` across every label set."""
        with self._lock:
            s = c = 0.0
            for (n, _), h in self._hists.items():
                if n == name:
                    s += h.sum
                    c += h.count
            return s, c

    @staticmethod
    def _escape_label(value) -> str:
        """Text-format label escaping: backslash, double quote, newline."""
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @staticmethod
    def _fmt(name: str, labels: tuple, value: float) -> str:
        if labels:
            lbl = ",".join(f'{k}="{MetricsHub._escape_label(v)}"'
                           for k, v in labels)
            return f"{name}{{{lbl}}} {value}"
        return f"{name} {value}"

    def _render_hist(self, name: str, labels: tuple, h: _Hist) -> list[str]:
        out, cum = [], 0
        for ub, n in zip(h.buckets, h.counts):
            cum += n
            out.append(self._fmt(f"{name}_bucket",
                                 labels + (("le", repr(float(ub))),), cum))
        cum += h.counts[-1]
        out.append(self._fmt(f"{name}_bucket",
                             labels + (("le", "+Inf"),), cum))
        out.append(self._fmt(f"{name}_sum", labels, round(h.sum, 6)))
        out.append(self._fmt(f"{name}_count", labels, h.count))
        return out

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        with self._lock:
            by_name: dict[str, list[str]] = defaultdict(list)
            for (name, labels), v in sorted(self._counters.items()):
                by_name[name].append(self._fmt(name, labels, v))
            for (name, labels), v in sorted(self._gauges.items()):
                by_name[name].append(self._fmt(name, labels, v))
            hist_names = set()
            for (name, labels), h in sorted(self._hists.items()):
                hist_names.add(name)
                by_name[name].extend(self._render_hist(name, labels, h))
        for name, samples in sorted(by_name.items()):
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            if name in hist_names:
                lines.append(f"# TYPE {name} histogram")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def quantile_from_buckets(q: float, cum: dict[float, float]) -> float:
    """Prometheus ``histogram_quantile``: locate the bucket covering
    quantile ``q`` of the cumulative counts ``cum`` ({upper bound: count},
    ``math.inf`` for the total) and interpolate linearly inside it.
    Observations in the +Inf bucket return the largest finite bound."""
    total = cum.get(math.inf, 0.0)
    if total <= 0:
        return 0.0
    target = q * total
    prev_ub, prev_cum = 0.0, 0.0
    finite = [ub for ub in sorted(cum) if ub != math.inf]
    for ub in finite:
        c = cum[ub]
        if c >= target:
            if c == prev_cum:
                return ub
            return prev_ub + (ub - prev_ub) * (target - prev_cum) / (
                c - prev_cum)
        prev_ub, prev_cum = ub, c
    return finite[-1] if finite else math.inf


GLOBAL_METRICS = MetricsHub()
# The device observatory (serving/xprof.py).
GLOBAL_METRICS.describe_histogram(
    "grove_compile_seconds",
    "Build wall time per engine executable (a CUDA graph capture on the "
    "card, an eager step's first call on the CPU), by bucket name",
    buckets=COMPILE_BUCKETS)
GLOBAL_METRICS.describe(
    "grove_recompiles_total",
    "Executable builds per fn and reason (first=expected warm-up build, "
    "shape-change=new argument signature) — any non-first rate on a "
    "serving engine means shapes are churning")
GLOBAL_METRICS.describe(
    "grove_recompile_storms_total",
    "Recompile-storm warnings: more than the threshold of non-first "
    "builds inside the sliding window (each one also logs a warning)")
GLOBAL_METRICS.describe_histogram(
    "grove_device_step_seconds",
    "Sampled per-step device time by phase (prefill|step|sample|"
    "host_transfer|handoff): CUDA events around every Nth dispatch, "
    "resolved at the engine's own fetches, on the card; host wall "
    "around the eager call on the CPU",
    buckets=DEVICE_STEP_BUCKETS)
GLOBAL_METRICS.describe(
    "grove_hbm_bytes",
    "Engine memory accounting per kind (kv_cache|weights|workspace|"
    "total) and scope, from torch.cuda.memory_stats on the card and "
    "model-derived byte counts on the CPU (the payload's source field "
    "says which)")
# Disaggregated serving: the KV block handoff, counted on the adopting
# (decode) side, one bump per adopted request.
GLOBAL_METRICS.describe(
    "grove_handoff_blocks_total",
    "KV blocks physically transferred prefill→decode (cold blocks only: "
    "decode-side prefix-cache hits ride shared refs and never move)")
GLOBAL_METRICS.describe(
    "grove_handoff_bytes_total",
    "Bytes the transferred blocks represent (K + V + int8 scales when "
    "quantized)")
GLOBAL_METRICS.describe_histogram(
    "grove_handoff_seconds",
    "Per-request handoff copy time, observed on sampled adoptions only "
    "(CUDA events around the copy on the card, host wall on the CPU)",
    buckets=DEVICE_STEP_BUCKETS)
# Speculative decoding, counted at the window drain.
GLOBAL_METRICS.describe(
    "grove_spec_accepted_tokens",
    "Draft tokens the target accepted (bonus tokens excluded)")
GLOBAL_METRICS.describe(
    "grove_spec_draft_tokens",
    "Draft tokens proposed (spec_k per running sequence per dispatch)")
# The request observatory (serving/reqtrace.py).
GLOBAL_METRICS.describe_histogram(
    "grove_request_phase_seconds",
    "Wall seconds one finished request spent in each serving phase "
    "(queue_wait|prefix_match|prefill|handoff|decode|preempt_recompute), "
    "observed once per phase at completion",
    buckets=REQUEST_PHASE_BUCKETS)
GLOBAL_METRICS.describe(
    "grove_reqtrace_dropped_total",
    "Request traces shed by the observatory's bounds (live-cap overflow, "
    "finished-ring eviction); GROVE_REQTRACE_RING/GROVE_REQTRACE_LIVE "
    "raise the bounds")
