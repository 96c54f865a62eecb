"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds in the middle of the window, bounded by two syncs of the engine so
that every dispatch in it also ran in it, and read once the run is over.

The slice is the window's last seconds. Its end closes its range and turns
the host side of the profiler off (a device side turned off drops what it
holds); the profiler stops, and processes what it holds, which takes a
second or more, once the traffic loop has returned: after the window's
requests have all been served, so that the stop stalls none of them.

The benchmark places ``record_function`` ranges around its own calls into
the engine (``bench.submit``, ``bench.admit``, ``bench.step``,
``bench.poll``, ``bench.wait``, ``bench.sync``) and one around the slice
(``bench.slice``), which is the traced window. From the trace it takes:

- ``busy_s``: the union of device operations (kernels, copies, sets) over
  the slice; ``window_s`` the slice's length;
- the device time of kernels by name, for the rooflines and the breakdown;
- the idle gaps (the slice less the union), each labelled by the benchmark
  range and the CUDA runtime call the host was in at the gap's midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class TraceData:
    busy_s: float
    window_s: float
    kernels: dict           # name -> device seconds inside the slice
    idle_gaps: list         # [[label, seconds], ...], longest first

    def kernel_seconds(self, matches) -> float:
        return sum(s for n, s in self.kernels.items()
                   if any(m in n for m in matches))

    def device_ops(self, top: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s] for n, s in rows]


class Tracer:
    """Off (``enabled`` False): every range is a null context and nothing
    is profiled. On: ``start``/``stop`` bound the slice."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.done = False
        self._prof = None
        self._slice = None
        self._stopped = False

    def prime(self) -> None:
        """Start and stop the profiler once, during set-up: its first start
        loads and initialises the tracing library, which would otherwise
        stall the window."""
        if not self.enabled:
            return
        self.start()
        torch.zeros(1).add_(1)
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.end_slice()
        self._prof.stop()
        self.done = False
        self._prof = None

    def range(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self.active = True
        self._slice = torch.profiler.record_function("bench.slice")
        self._slice.__enter__()

    def end_slice(self) -> None:
        """Close the slice and stop collecting host events; the profiler
        runs on until ``finish``."""
        from torch.profiler import ProfilerActivity
        self._slice.__exit__(None, None, None)
        self._prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])
        self.active = False
        self.done = True

    def finish(self) -> float:
        """Stop the profiler after the traffic loop; returns the seconds
        the stop took (0 when nothing was traced)."""
        if not self.done or self._stopped:
            return 0.0
        t = time.time()
        self._prof.stop()
        self._stopped = True
        return time.time() - t

    def read(self) -> TraceData | None:
        if not self._stopped:
            return None
        return read(self._prof)


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return fn() if fn is not None else int(getattr(e, f"{what}_us")() * 1e3)


def read(prof) -> TraceData | None:
    events = prof.profiler.kineto_results.events()
    dev, bench, runtime = [], [], []
    ws = we = None
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            dev.append((start, end, name))
        elif name == "bench.slice":
            ws, we = start, end
        elif name.startswith("bench."):
            bench.append((start, end, name))
        elif name.startswith("cuda"):
            runtime.append((start, end, name))
    if ws is None or we <= ws:
        return None
    kernels: dict[str, float] = {}
    spans = []
    for s, e, n in dev:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        kernels[n] = kernels.get(n, 0.0) + (e - s) / 1e9
        spans.append((s, e))
    spans.sort()
    busy, gaps, cur = 0, [], ws
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if we > cur:
        gaps.append((cur, we))
    return TraceData(busy_s=busy / 1e9, window_s=(we - ws) / 1e9,
                     kernels=kernels,
                     idle_gaps=_label(gaps, bench, runtime))


def _at(spans: list, starts: list, t: int) -> str | None:
    """The span of ``spans`` (sorted, not overlapping) holding ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return None


def _label(gaps: list, bench: list, runtime: list) -> list:
    """Sum the idle time by what the host was doing at each gap's midpoint:
    the benchmark's range and the runtime call inside it."""
    bench.sort()
    runtime.sort()
    b_starts = [s for s, _, _ in bench]
    r_starts = [s for s, _, _ in runtime]
    by: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        label = (f"{_at(bench, b_starts, mid) or 'host'}:"
                 f"{_at(runtime, r_starts, mid) or 'python'}")
        by[label] = by.get(label, 0.0) + (e - s) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]
