"""Data-plane observatory — build/step/memory telemetry for the serving
engine (docs/design/data-plane-observability.md; the paged engine's own
step stamps and host refills: docs/design/port-engine-tracing.md).

The port's copy of ``grove_tpu/serving/xprof.py``. The cost model, the
flight recorder's ring and ``phase_stats``, ``Observatory``, the registry
and ``render_engine_profile`` are the JAX module's; five parts differ,
because JAX's mechanisms have no torch counterpart or the port's engine
has no JAX twin:

- **CompileTracker** watches no jit cache. The engine calls
  ``note_build(name, seconds, signature)`` whenever it builds an
  executable for a new bucket: a CUDA graph capture on the card (host wall
  around the capture), the eager step's first call on the CPU, the first
  call of an eager copy (the CoW and handoff copies) and the lanes
  engine's first dispatch of each shape. The names, the reasons (first,
  shape-change) and the recompile-storm warning are the JAX package's,
  bucket by bucket, so the same traffic gives the same table in both.
- **FlightRecorder timing** never waits for the device on the dispatch
  path. ``DeviceTimer`` brackets every Nth dispatch with two
  ``torch.cuda.Event(enable_timing=True)`` recorded on the current stream
  around the graph's replay, queues the pair, and reads ``elapsed_time``
  only in ``resolve``, which the engine calls after fetches it makes
  anyway (the window drain's, the first token's, ``sync``). On the CPU
  the bracket is ``perf_counter`` around the eager call, as the JAX
  package times on its CPU backend. ``should_sample`` still counts
  dispatches when they are dispatched, so the cadence is JAX's. A sample
  is stamped with its dispatch's wall time, and the paged engine's carry
  their live rows and summed context, which ``throughput_estimate`` reads.
  The same timer stamps each decode step's end on the host clock
  (``mark``): an event after the step, placed by ``resolve`` against an
  anchor, an event that a fetch records just before its copy, at the host
  time the copy returned (on the CPU, the stamp is the host time after the
  eager step).
- **Memory accounting** reads ``torch.cuda.memory_stats`` (in use:
  ``allocated_bytes.all.current``, which counts the CUDA graphs' private
  pool too) and the card's total from its device properties (which torch
  reads once; no device call) on the card, source ``"device"``; on the CPU
  the model-derived byte counts, source ``"model-estimate"``.
- **The roofline** is the H100 SXM datasheet's (989e12 bf16 FLOP/s,
  3.35e12 B/s; ``GROVE_PEAK_FLOPS`` / ``GROVE_PEAK_HBM_BW`` override),
  and ``backend()`` names the CUDA device.
- **The host's refills** (``host`` in the payload): the paged engine counts
  each stretch from the return of a blocking device-to-host fetch to the
  return of its next chunk or step launch, in which the device can only
  idle for the host, as ``refills`` and ``refill_s``.

Surfaces follow the house pattern: ``payload()`` is the
``/debug/xprof`` shape that ``render_engine_profile`` (and the JAX
package's renderer) renders. ``GROVE_XPROF=0`` disables the observatory:
the engine then builds none, takes no sampling branch, stamps no step and
counts no refill.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
import weakref
from typing import Callable

import torch

logger = logging.getLogger("grove.xprof")

# Decode-step phases the flight recorder attributes device time to.
# "step" is the greedy decode dispatch (single step, spec dispatch, or a
# per-step normalized block), "sample" the sampled variant,
# "host_transfer" the window drain's device->host fetch; chunked-prefill
# dispatches sample into "prefill" and handoff copies into "handoff".
PHASES = ("prefill", "step", "sample", "host_transfer")

# Recompile-storm window: more than STORM_THRESHOLD non-first builds
# inside STORM_WINDOW_S means shapes are churning — warn, once per window.
STORM_WINDOW_S = 60.0
STORM_THRESHOLD = 3

# Datasheet roofline of one H100 SXM (dense bf16 tensor rate, device
# memory rate).
PEAK_FLOPS = float(os.environ.get("GROVE_PEAK_FLOPS", 989e12))
PEAK_HBM_BW = float(os.environ.get("GROVE_PEAK_HBM_BW", 3.35e12))
ROOFLINE = "H100 SXM datasheet"


def enabled() -> bool:
    """The observatory kill switch, read at engine construction (0 = no
    observatory, no sampling branch taken)."""
    return os.environ.get("GROVE_XPROF", "1") != "0"


# ---- model cost functions ----

def decode_flops_per_token(cfg, ctx: int) -> float:
    """Model FLOPs to decode one token at context length ``ctx``.

    Matmul weights count 2 FLOPs/param (multiply+add); attention adds
    the logits and value matmuls against the KV cache. Embedding lookup
    and norms are negligible.
    """
    c = cfg
    w_matmul = (c.n_layers * (c.d_model * c.n_heads * c.head_dim       # wq
                              + 2 * c.d_model * c.n_kv_heads * c.head_dim
                              + c.n_heads * c.head_dim * c.d_model     # wo
                              + c.mlp_params)                          # mlp
                + c.d_model * c.vocab_size)                            # head
    attn = 4 * ctx * c.n_layers * c.n_heads * c.head_dim
    return 2.0 * w_matmul + attn


def prefill_flops_per_token(cfg, prompt_len: int) -> float:
    """Model FLOPs per prompt token: weight matmuls plus causal
    attention at the average context (prompt_len / 2)."""
    c = cfg
    w_matmul = (c.n_layers * (c.d_model * c.n_heads * c.head_dim
                              + 2 * c.d_model * c.n_kv_heads * c.head_dim
                              + c.n_heads * c.head_dim * c.d_model
                              + c.mlp_params)
                + c.d_model * c.vocab_size)
    attn = 4 * (prompt_len / 2) * c.n_layers * c.n_heads * c.head_dim
    return 2.0 * w_matmul + attn


def decode_hbm_bytes_per_token(cfg, cache_len: int, batch: int,
                               weight_bytes: float | None = None,
                               kv_quant: str = "off") -> float:
    """Device-memory bytes moved per decoded token: full weight read amortized
    over the batch, plus this lane's KV cache read and one-entry write.
    ``cache_len`` is the ALLOCATED cache length — the padded read is
    what the implementation actually moves, regardless of live context.
    ``weight_bytes`` overrides the bf16 weight size (int8 quantization
    halves the read; the roofline must use what actually crosses HBM).
    ``kv_quant`` does the same for the cache side: int8 paged KV moves
    int8 payload plus f32 scales. Both KV terms derive from serving/
    quant.kv_bytes_per_token_per_layer — the ONE shared derivation, so
    this roofline and the engine's block-byte gauges cannot drift."""
    from grove_tpu_torch.serving.quant import kv_bytes_per_token_per_layer
    per_tok_layer = kv_bytes_per_token_per_layer(cfg, kv_quant)
    kv_read = cfg.n_layers * cache_len * per_tok_layer
    kv_write = cfg.n_layers * per_tok_layer
    weights = cfg.params_bytes if weight_bytes is None else weight_bytes
    return weights / batch + kv_read + kv_write


# ---- build observability ----

@dataclasses.dataclass
class CompileEvent:
    fn: str
    seconds: float
    reason: str        # first | shape-change | cache-evict
    ts: float


class CompileTracker:
    """Attributes every executable build the engine reports.

    ``note_build`` is called once per build (a graph capture, an eager
    step's first call), so every call counts: the first build of a name
    is ``first``, a build under a signature not seen before for that name
    ``shape-change``, a rebuild of a seen signature ``cache-evict``."""

    EVENT_CAPACITY = 256

    def __init__(self, metrics=None) -> None:
        self._lock = threading.Lock()
        self._metrics = metrics
        self._seen_sigs: dict[str, set] = {}
        self._compiles: dict[str, int] = collections.defaultdict(int)
        self._recompiles: dict[str, int] = collections.defaultdict(int)
        self._seconds: dict[str, float] = collections.defaultdict(float)
        self._last: dict[str, CompileEvent] = {}
        self.events: collections.deque[CompileEvent] = collections.deque(
            maxlen=self.EVENT_CAPACITY)
        # Non-first build timestamps inside the storm window.
        self._storm_ring: collections.deque[float] = collections.deque(
            maxlen=64)
        self._storm_warned_at = 0.0
        self.storms = 0
        # True once a build was noted since the engine last cleared it:
        # a timed dispatch that built is dropped from the flight recorder
        # (its wall is the build's, already in grove_compile_seconds).
        self.last_call_compiled = False

    def seen(self, name: str, sig: tuple) -> bool:
        """Whether ``name`` was built under ``sig`` already (the lanes
        engine's per-dispatch test for a first call)."""
        return sig in self._seen_sigs.get(name, ())

    def note_build(self, name: str, seconds: float,
                   signature: tuple = ("build",)) -> None:
        """Record one executable build of ``name`` that took ``seconds``
        of host wall time, under the argument signature ``signature``."""
        self.last_call_compiled = True
        self._on_compile(name, seconds, signature)

    def _on_compile(self, name: str, seconds: float, sig: tuple) -> None:
        now = time.time()
        with self._lock:
            seen = self._seen_sigs.setdefault(name, set())
            if not seen:
                reason = "first"
            elif sig in seen:
                reason = "cache-evict"
            else:
                reason = "shape-change"
            seen.add(sig)
            self._compiles[name] += 1
            self._seconds[name] += seconds
            ev = CompileEvent(name, seconds, reason, now)
            self._last[name] = ev
            self.events.append(ev)
            storm = False
            if reason != "first":
                self._recompiles[name] += 1
                self._storm_ring.append(now)
                recent = [t for t in self._storm_ring
                          if now - t <= STORM_WINDOW_S]
                if (len(recent) > STORM_THRESHOLD
                        and now - self._storm_warned_at > STORM_WINDOW_S):
                    self._storm_warned_at = now
                    self.storms += 1
                    storm = True
        if self._metrics is not None:
            self._metrics.observe("grove_compile_seconds", seconds, fn=name)
            self._metrics.inc("grove_recompiles_total", fn=name,
                              reason=reason)
            if storm:
                self._metrics.inc("grove_recompile_storms_total")
        if storm:
            logger.warning(
                "recompile storm: >%d rebuilds inside %.0fs (last: %s "
                "%.2fs, %s) — shapes are churning on the serving path",
                STORM_THRESHOLD, STORM_WINDOW_S, name, seconds, reason)

    def note_external_compile(self, name: str, seconds: float) -> None:
        """Record a build observed outside the engine's own executables
        (a PrefillWorker's first prefill of a shape). One synthetic
        signature per name: the first build classifies ``first``, later
        ones ``cache-evict``."""
        self._on_compile(name, seconds, ("external",))

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._compiles)

    def recompile_count(self) -> int:
        with self._lock:
            return sum(self._recompiles.values())

    def total_seconds(self) -> float:
        with self._lock:
            return sum(self._seconds.values())

    def payload(self) -> dict:
        with self._lock:
            fns = []
            for name in sorted(self._compiles):
                last = self._last.get(name)
                fns.append({
                    "fn": name,
                    "compiles": self._compiles[name],
                    "recompiles": self._recompiles.get(name, 0),
                    "total_seconds": round(self._seconds[name], 4),
                    "last_reason": last.reason if last else "",
                    "last_seconds": round(last.seconds, 4) if last else 0.0,
                })
            return {"fns": fns,
                    "total_seconds": round(sum(self._seconds.values()), 4),
                    "recompiles": sum(self._recompiles.values()),
                    "storms": self.storms}


# ---- device timing without a sync ----

class Stamp:
    """The end of a decode step on the host clock: ``ts`` is 0.0 until the
    timer places it."""

    __slots__ = ("ts", "event")

    def __init__(self, ts: float = 0.0, event=None) -> None:
        self.ts, self.event = ts, event


class DeviceTimer:
    """Times sampled dispatches without waiting for the device.

    On the card ``start`` records a ``torch.cuda.Event(enable_timing=True)``
    on the current stream and ``stop`` records a second one after the
    dispatch and queues the pair with its callback; ``resolve`` reads
    ``elapsed_time`` and runs the callbacks, and is called only after a
    fetch that has already waited for the stream (so the pairs queued
    before it are complete and nothing here blocks). Events are reused. The queue holds
    at most ``capacity`` pairs: past that the oldest is dropped, unread,
    and counted in ``dropped``. On the CPU the bracket is ``perf_counter``
    and ``stop`` runs the callback at once, unless ``defer`` holds the
    reading until ``resolve`` (which the tests use to rehearse the card's
    order of events on the CPU).

    ``mark`` stamps the end of the work enqueued so far. On the card it
    records an event from the same pool and queues it; a ``resolve`` that
    brings an anchor (from ``anchor``, which a fetch records just before
    its copy) and the host time the copy returned places it at that time
    less the device time from the mark to the anchor. On the CPU the stamp
    is the host time at once."""

    def __init__(self, device: torch.device, capacity: int = 128,
                 defer: bool = False) -> None:
        self.cuda = device.type == "cuda"
        self.capacity = max(1, capacity)
        self.defer = defer
        self._pending: collections.deque = collections.deque()
        self._marks: collections.deque[Stamp] = collections.deque()
        self._free: list = []
        self.dropped = 0
        self.resolved = 0

    def _event(self):
        ev = self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        if not self.cuda:
            return time.perf_counter()
        return self._event()

    def mark(self) -> Stamp:
        """Stamp the end of the work enqueued so far."""
        if not self.cuda:
            return Stamp(time.time())
        stamp = Stamp(event=self._event())
        self._marks.append(stamp)
        return stamp

    def anchor(self):
        """Where marks wait to be placed (only on the card): record an
        event after the work enqueued so far and return it; None otherwise.
        A fetch records it just before its copy and reads the host clock
        when the copy has returned: the stamps are then late by the copy
        and the host's wake, a few microseconds."""
        if not self._marks:
            return None
        return self._event()

    def stop(self, start, done: Callable[[float], None]) -> None:
        """Close the bracket opened by ``start``; ``done(seconds)`` runs
        when the time is known."""
        if not self.cuda:
            if not self.defer:
                done(time.perf_counter() - start)
                return
            end = time.perf_counter()
        else:
            end = self._event()
        if len(self._pending) >= self.capacity:
            s, e, _ = self._pending.popleft()
            if self.cuda:
                self._free += (s, e)
            self.dropped += 1
        self._pending.append((start, end, done))

    def resolve(self, anchor=None, at: float = 0.0) -> None:
        """Read the queued pairs, oldest first, and run their callbacks.
        Called after a fetch has waited for the stream, so the pairs
        recorded before it are complete; a pair recorded after the fetch
        (work the caller enqueued since) stays queued, unread, for the next
        call: ``query`` tells without waiting. With the fetch's
        ``anchor`` and ``at``, the host time its copy returned, the marks
        recorded before the anchor are placed first."""
        if anchor is not None:
            while self._marks and self._marks[0].event.query():
                stamp = self._marks.popleft()
                stamp.ts = at - stamp.event.elapsed_time(anchor) / 1e3
                self._free.append(stamp.event)
                stamp.event = None
            self._free.append(anchor)
        while self._pending:
            s, e, done = self._pending[0]
            if self.cuda and not e.query():
                return
            self._pending.popleft()
            if self.cuda:
                seconds = s.elapsed_time(e) / 1e3
                self._free += (s, e)
            else:
                seconds = e - s
            self.resolved += 1
            done(seconds)

    def __len__(self) -> int:
        return len(self._pending)


# ---- decode-step flight recorder ----

@dataclasses.dataclass
class StepSample:
    ts: float          # the dispatch's wall time
    phase: str
    seconds: float     # the dispatch's device time
    steps: int         # decode steps covered (blocks: K)
    tokens: int        # tokens the dispatch produced
    rows: int = 0      # live rows of a paged decode dispatch (0: unknown)
    ctx: int = 0       # their summed context


class FlightRecorder:
    """Bounded ring of sampled device timings, scoped to one engine.
    ``should_sample`` gates every hook: one modulo per dispatch when
    enabled, nothing at all when the observatory is off. Samples may
    arrive after the dispatch (resolved device timings) and out of
    dispatch order; ``phase_stats`` does not depend on the order."""

    def __init__(self, capacity: int = 1024, sample_every: int = 16,
                 metrics=None) -> None:
        self.capacity = capacity
        self.sample_every = max(1, sample_every)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._ring: collections.deque[StepSample] = collections.deque(
            maxlen=capacity)
        self.samples_total = 0
        self._dispatches = 0

    def should_sample(self) -> bool:
        """Every Nth DISPATCH (single step or K-step block) is sampled:
        counting dispatches, not steps, keeps the timing cost at 1/N of
        dispatches regardless of block size."""
        self._dispatches += 1
        return (self._dispatches - 1) % self.sample_every == 0

    def record(self, phase: str, seconds: float, steps: int = 1,
               tokens: int = 0, ts: float | None = None, rows: int = 0,
               ctx: int = 0) -> None:
        """One sample; ``ts`` is the dispatch's wall time (now when the
        time was read at the dispatch)."""
        per_step = seconds / max(1, steps)
        with self._lock:
            self._ring.append(StepSample(time.time() if ts is None else ts,
                                         phase, seconds, steps, tokens,
                                         rows, ctx))
            self.samples_total += 1
        if self._metrics is not None:
            self._metrics.observe("grove_device_step_seconds", per_step,
                                  phase=phase)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> list[StepSample]:
        with self._lock:
            return list(self._ring)

    def phase_stats(self) -> dict[str, dict]:
        """Per-phase stats over the ring: count, total device seconds,
        per-step p50/p95 ms, tokens. Computed at read time — the record
        path stays append-only."""
        out: dict[str, dict] = {}
        for s in self.snapshot():
            d = out.setdefault(s.phase, {"count": 0, "total_s": 0.0,
                                         "steps": 0, "tokens": 0,
                                         "_per_step": []})
            d["count"] += 1
            d["total_s"] += s.seconds
            d["steps"] += s.steps
            d["tokens"] += s.tokens
            d["_per_step"].append(s.seconds / max(1, s.steps))
        for d in out.values():
            vals = sorted(d.pop("_per_step"))
            d["total_s"] = round(d["total_s"], 6)
            d["p50_ms"] = round(vals[len(vals) // 2] * 1e3, 4)
            d["p95_ms"] = round(
                vals[min(len(vals) - 1, int(len(vals) * 0.95))] * 1e3, 4)
        return out


# ---- memory accounting ----

# What "in use" counts on the card.
DEVICE_MEMORY_BASIS = ("torch.cuda.memory_stats allocated_bytes.all.current "
                       "(CUDA graph pools included) of "
                       "torch.cuda.get_device_properties total_memory")


def memory_snapshot(engine) -> dict:
    """Byte accounting for one engine: ``torch.cuda.memory_stats`` on the
    card (source "device"), model-derived tensor and weight sizes on the
    CPU (source "model-estimate": the numbers are derived, not
    measured)."""
    from grove_tpu_torch.serving.quant import params_bytes

    cache = engine.cache
    # PagedKV.pool_bytes includes the int8 scale pools; the lanes
    # engine's contiguous cache has no such property. A speculative
    # engine's draft pool is device memory too.
    kv_bytes = int(getattr(cache, "pool_bytes", None)
                   or (cache.k.nbytes + cache.v.nbytes))
    draft = getattr(engine, "draft_kv", None)
    if draft is not None:
        kv_bytes += int(draft.pool_bytes)
    weight_bytes = int(params_bytes(engine.params))
    dev = cache.k.device
    on_card = dev.type == "cuda"
    limit = in_use = 0
    if on_card:
        in_use = int(torch.cuda.memory_stats(dev)[
            "allocated_bytes.all.current"])
        # torch reads the properties once per device: no call reaches the
        # card here (mem_get_info would, on the tick path).
        limit = int(torch.cuda.get_device_properties(dev).total_memory)
    total = in_use if on_card else kv_bytes + weight_bytes
    workspace = max(0, total - kv_bytes - weight_bytes)
    # KV headroom: on the card the device's free fraction; model-derived,
    # the unused fraction of the allocated cache.
    if on_card and limit:
        headroom = max(0.0, 1.0 - total / limit)
    else:
        headroom = max(0.0, 1.0 - engine.kv_lane_utilization)
    out = {"kv_cache_bytes": kv_bytes, "weight_bytes": weight_bytes,
           "workspace_bytes": workspace, "total_bytes": total,
           "limit_bytes": limit,
           "source": "device" if on_card else "model-estimate",
           "kv_headroom": round(headroom, 4)}
    if on_card:
        out["basis"] = DEVICE_MEMORY_BASIS
    return out


# ---- the observatory ----

class Observatory:
    """One engine's data-plane instruments, bundled: build tracker, flight
    recorder, memory gauges, roofline estimates. Construction is cheap;
    everything heavy happens only on sampled events."""

    MEMORY_MIN_INTERVAL_S = 0.25

    def __init__(self, cfg=None, batch: int = 1, max_len: int = 0,
                 capacity: int | None = None,
                 sample_every: int | None = None,
                 metrics=None, name: str | None = None,
                 namespace: str = "default",
                 device: torch.device | str | None = None) -> None:
        if metrics is None:
            from grove_tpu_torch.serving.metrics import GLOBAL_METRICS
            metrics = GLOBAL_METRICS
        if capacity is None:
            capacity = int(os.environ.get("GROVE_XPROF_RING", 1024))
        if sample_every is None:
            sample_every = int(os.environ.get("GROVE_XPROF_SAMPLE", 16))
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        # The engine's device (set by the engine): backend() reads it.
        self.device = None if device is None else torch.device(device)
        self._metrics = metrics
        self.compile = CompileTracker(metrics=metrics)
        self.recorder = FlightRecorder(capacity=capacity,
                                       sample_every=sample_every,
                                       metrics=metrics)
        self.namespace = namespace
        self.name = name or _next_auto_name()
        self._last_memory: dict | None = None
        self._last_memory_ts = 0.0
        self._weight_bytes: int | None = None
        # Engine-pushed riders (set by the paged engine when the
        # corresponding feature is on, None otherwise).
        self.spec: dict | None = None   # engine.spec_stats() shape
        self.handoff: dict | None = None  # engine.handoff_view() shape
        self.kv_quant: str = "off"      # KV byte basis for the roofline
        # The engine's DeviceTimer (its pending and dropped counts ride
        # the payload); None until an engine attaches one.
        self.timer: DeviceTimer | None = None
        # The paged engine's refills: host seconds from a blocking fetch's
        # return to the return of the next chunk or step launch.
        self.refills = 0
        self.refill_s = 0.0
        register(self)

    # -- hooks the engine calls --

    def should_sample(self) -> bool:
        return self.recorder.should_sample()

    def record(self, phase: str, seconds: float, steps: int = 1,
               tokens: int = 0, ts: float | None = None, rows: int = 0,
               ctx: int = 0) -> None:
        self.recorder.record(phase, seconds, steps=steps, tokens=tokens,
                             ts=ts, rows=rows, ctx=ctx)

    def note_refill(self, seconds: float) -> None:
        self.refills += 1
        self.refill_s += seconds

    def host(self) -> dict:
        """The refill counters (``host`` of the payloads)."""
        return {"refills": self.refills, "refill_s": self.refill_s}

    def observe_memory(self, engine, telemetry=None) -> None:
        """Refresh the memory gauges from the engine's live state
        (rate-limited: admission and drain call this opportunistically,
        and a submit storm must not turn it into a query storm)."""
        now = time.time()
        if now - self._last_memory_ts < self.MEMORY_MIN_INTERVAL_S:
            return
        self._last_memory_ts = now
        mem = memory_snapshot(engine)
        self._last_memory = mem
        self._weight_bytes = mem["weight_bytes"]
        scope = f"{self.namespace}/{self.name}"
        for kind, key in (("kv_cache", "kv_cache_bytes"),
                          ("weights", "weight_bytes"),
                          ("workspace", "workspace_bytes"),
                          ("total", "total_bytes")):
            self._metrics.set("grove_hbm_bytes", float(mem[key]),
                              kind=kind, scope=scope)
        # getattr-guarded: telemetry doubles may implement only the SLO
        # hooks.
        push = getattr(telemetry, "sample_memory", None)
        if push is not None:
            push(mem)

    # -- derived views --

    def backend(self) -> dict:
        if self.device is not None and self.device.type == "cuda":
            return {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(self.device),
                    "estimated": False}
        return {"platform": "cpu", "device_kind": "cpu", "estimated": True}

    def throughput_estimate(self) -> dict | None:
        """Tokens/sec over the ring's decode samples placed against the
        H100 roofline; off the card the block is stamped a model-derived
        estimate. A sample's FLOPs and bytes are its live rows at their
        summed context where it carries them (the paged engine's), else
        its tokens at half the allocated length in a full batch (the lanes
        engine's steps read the whole padded cache)."""
        if self.cfg is None:
            return None
        decode = [s for s in self.recorder.snapshot()
                  if s.phase in ("step", "sample")]
        tokens = sum(s.tokens for s in decode)
        secs = sum(s.seconds for s in decode)
        if not tokens or secs <= 0:
            return None
        flops = nbytes = 0.0
        for s in decode:
            if s.rows:
                # Both costs are linear in the context: the rows at their
                # mean context cost what the rows at their own do.
                n, batch = s.rows, s.rows
                attended = cached = s.ctx / s.rows
            else:
                n, batch = s.tokens, max(1, self.batch)
                attended = max(1, self.max_len // 2)
                cached = self.max_len or self.cfg.max_seq_len
            flops += n * decode_flops_per_token(self.cfg, attended)
            nbytes += n * decode_hbm_bytes_per_token(
                self.cfg, cached, batch, weight_bytes=self._weight_bytes,
                kv_quant=self.kv_quant)
        backend = self.backend()
        return {
            "tokens_per_sec_est": round(tokens / secs, 1),
            "mfu_est": round(flops / secs / PEAK_FLOPS, 6),
            "hbm_util_est": round(nbytes / secs / PEAK_HBM_BW, 6),
            "basis": (f"device-sampled (CUDA events) vs {ROOFLINE}"
                      if not backend["estimated"]
                      else f"model-estimate (CPU backend; {ROOFLINE} "
                           "roofline)"),
            "estimated": backend["estimated"],
        }

    def payload(self) -> dict:
        """The /debug/xprof payload (``render_engine_profile`` renders
        it)."""
        phases = self.recorder.phase_stats()
        hottest = max(phases, key=lambda p: phases[p]["total_s"]) \
            if phases else None
        out = {
            "scope": {"namespace": self.namespace, "name": self.name},
            "backend": self.backend(),
            "sample_every": self.recorder.sample_every,
            "ring": {"len": len(self.recorder),
                     "capacity": self.recorder.capacity,
                     "samples_total": self.recorder.samples_total},
            "phases": phases,
            "hottest_phase": hottest,
            "compile": self.compile.payload(),
            "memory": self._last_memory,
            "kv_quant": self.kv_quant,
            "spec": self.spec,
            "handoff": self.handoff,
            "throughput": self.throughput_estimate(),
            "host": self.host(),
        }
        if self.timer is not None:
            out["timer"] = {"pending": len(self.timer),
                            "capacity": self.timer.capacity,
                            "resolved": self.timer.resolved,
                            "dropped": self.timer.dropped}
        return out


# ---- per-process observatory registry (the debug_xprof surface) ----

_REGISTRY: "collections.OrderedDict[tuple[str, str], weakref.ref]" = \
    collections.OrderedDict()
_REGISTRY_CAPACITY = 64
_registry_lock = threading.Lock()
_auto_seq = [0]


def _next_auto_name() -> str:
    with _registry_lock:
        _auto_seq[0] += 1
        return f"engine-{_auto_seq[0]}"


def _zero_scope_gauges(scope: str, metrics) -> None:
    """Zero a dead/evicted scope's grove_hbm_bytes series: a retired
    engine's bytes must read 0, not linger at their last value (the
    set_gauge_family / kube-state-metrics convention; the hub keeps
    the zeroed series in the rendering, which is the standard
    Prometheus staleness shape)."""
    for kind in ("kv_cache", "weights", "workspace", "total"):
        metrics.set("grove_hbm_bytes", 0.0, kind=kind, scope=scope)


def register(obs: Observatory, name: str | None = None,
             namespace: str | None = None) -> None:
    """(Re)register an observatory under a scope. Engines auto-register
    as default/engine-N at construction; serving wrappers re-register
    under the scope name the control plane knows (the PCSG), so
    ``grovectl engine-profile <name>`` finds it. Weakly held and
    LRU-capped: a dead engine's entry evicts and its gauge series
    zero, never lingering at stale byte values."""
    if name is not None and name != obs.name and obs._last_memory:
        # Re-registration under a new scope: the gauges written under
        # the old scope would otherwise read stale forever.
        _zero_scope_gauges(f"{obs.namespace}/{obs.name}", obs._metrics)
    if name is not None:
        obs.name = name
    if namespace is not None:
        obs.namespace = namespace
    key = (obs.namespace, obs.name)
    # Zero this scope's gauges when the observatory is collected (the
    # finalizer must not hold obs — capture only the scope string).
    weakref.finalize(obs, _zero_scope_gauges,
                     f"{obs.namespace}/{obs.name}", obs._metrics)
    with _registry_lock:
        _REGISTRY.pop(key, None)
        _REGISTRY[key] = weakref.ref(obs)
        while len(_REGISTRY) > _REGISTRY_CAPACITY:
            _REGISTRY.popitem(last=False)


def observatory_for(name: str, namespace: str = "default",
                    ) -> Observatory | None:
    with _registry_lock:
        ref = _REGISTRY.get((namespace, name))
        obs = ref() if ref is not None else None
        if ref is not None and obs is None:
            del _REGISTRY[(namespace, name)]
        return obs


def scopes() -> list[tuple[str, str]]:
    with _registry_lock:
        return [k for k, ref in _REGISTRY.items() if ref() is not None]


# ---- rendering (grovectl engine-profile) ----

def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TB"


def render_engine_profile(payload: dict) -> list[str]:
    """Human rendering of one observatory payload: phase breakdown
    (hottest phase starred), compile table, memory bar."""
    out: list[str] = []
    scope = payload.get("scope") or {}
    backend = payload.get("backend") or {}
    out.append(f"engine:    {scope.get('namespace', '?')}/"
               f"{scope.get('name', '?')}")
    est = " (estimates are model-derived)" if backend.get("estimated") \
        else ""
    out.append(f"backend:   {backend.get('platform', '?')}:"
               f"{backend.get('device_kind', '?')}{est}")
    ring = payload.get("ring") or {}
    out.append(f"sampling:  every {payload.get('sample_every', '?')} "
               f"steps, ring {ring.get('len', 0)}/"
               f"{ring.get('capacity', 0)} "
               f"({ring.get('samples_total', 0)} samples total)")
    phases = payload.get("phases") or {}
    if phases:
        out.append("")
        out.append(f"  {'phase':<15}{'samples':>8}{'p50 ms':>10}"
                   f"{'p95 ms':>10}{'total s':>10}  ")
        hottest = payload.get("hottest_phase")
        for name in sorted(phases, key=lambda p: -phases[p]["total_s"]):
            d = phases[name]
            star = " *" if name == hottest else ""
            out.append(f"  {name:<15}{d['count']:>8}{d['p50_ms']:>10.3f}"
                       f"{d['p95_ms']:>10.3f}{d['total_s']:>10.3f}{star}")
    else:
        out.append("  (no device-time samples yet)")
    comp = payload.get("compile") or {}
    if comp.get("fns"):
        out.append("")
        out.append(f"  {'compiled fn':<22}{'compiles':>9}{'recompiles':>11}"
                   f"{'total s':>9}  last")
        for f in comp["fns"]:
            out.append(f"  {f['fn']:<22}{f['compiles']:>9}"
                       f"{f['recompiles']:>11}{f['total_seconds']:>9.2f}"
                       f"  {f['last_reason']} ({f['last_seconds']:.2f}s)")
        if comp.get("storms"):
            out.append(f"  RECOMPILE STORMS: {comp['storms']} — shapes "
                       "are churning on the serving path")
    mem = payload.get("memory")
    if mem:
        out.append("")
        out.append(f"memory ({mem['source']}):")
        total = max(1, mem["total_bytes"])
        for kind, key in (("kv_cache", "kv_cache_bytes"),
                          ("weights", "weight_bytes"),
                          ("workspace", "workspace_bytes")):
            b = mem[key]
            bar = "#" * min(40, int(40 * b / total))
            out.append(f"  {kind:<11}{_fmt_bytes(b):>12}  {bar}")
        limit = (f" / limit {_fmt_bytes(mem['limit_bytes'])}"
                 if mem.get("limit_bytes") else "")
        out.append(f"  {'total':<11}{_fmt_bytes(mem['total_bytes']):>12}"
                   f"{limit}  kv_headroom {mem['kv_headroom']:.2f}")
    spec = payload.get("spec")
    if spec:
        out.append("")
        rate = spec.get("acceptance_rate", 0.0)
        # <50% acceptance means more than half the draft compute is
        # thrown away — the speculation config IS the bottleneck
        # (shrink spec_k or improve the draft), so star it the way
        # the hottest phase is starred.
        star = "  * LOW ACCEPTANCE — speculation is the bottleneck" \
            if spec.get("draft_tokens", 0) and rate < 0.5 else ""
        out.append(f"speculation (k={spec.get('spec_k', '?')}): "
                   f"acceptance {rate * 100:.1f}%, "
                   f"{spec.get('accepted_per_dispatch', 0.0):.2f} "
                   f"tokens/dispatch "
                   f"({spec.get('accepted_tokens', 0)}/"
                   f"{spec.get('draft_tokens', 0)} drafts accepted)"
                   f"{star}")
        buckets = spec.get("per_bucket") or {}
        for key in sorted(buckets):
            b = buckets[key]
            acc = (b["accepted_tokens"] / b["draft_tokens"]
                   if b.get("draft_tokens") else 0.0)
            per = (b["committed_tokens"] / b["rows"]
                   if b.get("rows") else 0.0)
            out.append(f"  [{key}] acceptance {acc * 100:.1f}%, "
                       f"{per:.2f} tok/dispatch over "
                       f"{b.get('dispatches', 0)} dispatches")
    thr = payload.get("throughput")
    if thr:
        out.append("")
        tag = " [estimate]" if thr.get("estimated") else ""
        out.append(f"throughput: {thr['tokens_per_sec_est']:.1f} tok/s, "
                   f"MFU {thr['mfu_est'] * 100:.2f}%, "
                   f"HBM {thr['hbm_util_est'] * 100:.1f}%{tag}")
        out.append(f"  basis: {thr['basis']}")
    return out
