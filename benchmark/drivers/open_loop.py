"""``open_loop``: independent users, each sending one request when it is due,
whether or not earlier ones have finished (an open loop: a slow engine
cannot slow its own offered load, and its queue grows instead).

Mix parameters: ``rate_per_s`` (Poisson arrivals), ``prompt_tokens`` and
``output_tokens`` (length specs, traffic_gen.py), ``preroll_s`` (arrivals
before the window, so that it opens on an engine already at its steady
load), ``after_window_s`` (the bound on the drain after the window) and
``schedule_seed``: the seed of the arrival gaps and lengths, which every
run replays in the same order, the run's own seed drawing the token ids
(and the weights). The order of a few hundred arrivals moves a TTFT tail
far more than two runs of one order differ (620-1,116 ms over six orders
at one load, against 0-7% between two runs of one order), and no
reordering that keeps the load Poisson brings that down, so a cell judged
on its tail replays one schedule.

The arrivals come in three runs of the one schedule: ``preroll_s`` of them
before the window, the window's ``round(rate * seconds)`` requests due in
it, and more after it at the same rate while the window's last requests
finish, so that every window request starts and ends under the load it is
measured at. Only the window's requests are measured; one still unfinished
when the drain ends has failed. Every request is greedy.

The loop, on one thread: submit what is due (each stamped against its due
time, so that a late generator shows as its lateness and as latency), admit
from the queue, one engine tick, look at the tokens. At the window's end
the engine is synced, so that every token dispatched in the window is
counted in it and the window is as long as that work took.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from benchmark import traffic_gen
from benchmark.observe import submit
from grove_tpu_torch.serving.schedule import bucket_ladder


@dataclasses.dataclass
class Plan:
    offsets: np.ndarray         # due times against the window's opening
    prompts: list
    max_new: np.ndarray
    window: slice               # the window's requests
    drain_s: float


def plan(mix: dict, cell: dict, cfg, seconds: float, seed: int) -> Plan:
    rng = traffic_gen.rng_for(mix["schedule_seed"])
    rate = float(mix["rate_per_s"])
    pre = float(mix.get("preroll_s", 0.0))
    drain_s = float(mix["after_window_s"])
    counts = (round(rate * pre), max(1, round(rate * seconds)),
              math.ceil(rate * drain_s))
    starts = (-pre, 0.0, float(seconds))
    offsets, p, o = [], [], []
    for n, start in zip(counts, starts):
        offsets.append(start + traffic_gen.poisson_offsets(rate, n, rng))
        p.append(traffic_gen.lengths(mix["prompt_tokens"], n, rng))
        o.append(traffic_gen.lengths(mix["output_tokens"], n, rng))
    return Plan(offsets=np.concatenate(offsets),
                prompts=traffic_gen.token_ids(np.concatenate(p),
                                              cfg.vocab_size,
                                              traffic_gen.rng_for(seed)),
                max_new=np.concatenate(o),
                window=slice(counts[0], counts[0] + counts[1]),
                drain_s=drain_s)


def shapes(p: Plan, cell: dict, engine) -> dict:
    """The decode batches, table widths and chunk widths this traffic can
    reach: any batch bucket up to the cell's batch; decode tables from the
    shortest prompt's to the longest request's; chunk tables from the
    first chunk of the shortest prompt to the longest prompt."""
    e = cell["engine"]
    lens = np.array([len(x) for x in p.prompts])
    longest = int(min(e["max_len"], (lens + p.max_new).max()))
    c = e["prefill_chunk"]
    return {"batches": bucket_ladder(e["batch"]),
            "widths": engine.decode_width_buckets(int(lens.min()) + 1,
                                                  longest),
            "prefill_widths": engine.decode_width_buckets(
                min(c, int(lens.min())), int(lens.max()))}


def tick(engine, obs, tracer) -> None:
    """Admit from the queue, one engine tick, look at the tokens."""
    with tracer.range("bench.admit"):
        engine.admit_from_queue()
    with tracer.range("bench.step"):
        engine.step()
    with tracer.range("bench.poll"):
        obs.poll(time.time())


def drive(engine, p: Plan, seconds: float, obs, tracer, slicer) -> dict:
    ta = time.time()
    t0 = ta - float(p.offsets[0])
    dues = t0 + p.offsets
    end = t0 + seconds
    i, n = 0, len(dues)
    t1 = opened = closed = None
    late = []
    window = []
    while True:
        now = time.time()
        slicer.tick(now - t0)
        if opened is None and now >= t0:
            opened = engine.payload()
        while i < n and dues[i] <= now:
            with tracer.range("bench.submit"):
                rid, req = submit(engine, p.prompts[i], int(p.max_new[i]))
            t = obs.add(rid, req, float(dues[i]),
                        in_window=p.window.start <= i < p.window.stop)
            if t.in_window:
                window.append(t)
                late.append(now - dues[i])
            i += 1
        if t1 is None and now >= end:
            with tracer.range("bench.sync"):
                engine.sync()
            t1 = time.time()
            obs.poll(t1)
            closed = engine.payload()
        if t1 is not None and (all(t.done for t in window)
                               or now > end + p.drain_s):
            break
        tick(engine, obs, tracer)
        if engine.idle() and engine.queue_depth == 0 and i < n:
            with tracer.range("bench.wait"):
                time.sleep(max(0.0, min(dues[i] - time.time(), 0.002)))
    return {"ta": ta, "t0": t0, "t1": t1, "end": time.time(),
            "counters": (opened, closed), "lateness_s": late}
