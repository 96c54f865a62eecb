"""``sessions``: long-lived sessions whose caches are built during set-up and
that decode through the whole window (long-document and agent sessions
decoding over caches of several thousand tokens).

Mix parameters: ``sessions`` (how many; the cell's batch holds them all),
``prompt_tokens`` (a length spec, traffic_gen.py). Each session may decode
to the cell's ``max_len``, so none ends inside the window. Set-up submits
every session and prefills them all (``admit_prompts``: prefill chunks
only, no decode, until every session holds its first token); the window
then ticks the engine for ``seconds`` and syncs it, so that every token
dispatched in the window is counted in it. No prefill runs in the window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark import traffic_gen
from benchmark.observe import submit
from grove_tpu_torch.serving.schedule import bucket_ladder, pick_bucket


@dataclasses.dataclass
class Plan:
    prompts: list
    max_new: np.ndarray


def plan(mix: dict, cell: dict, cfg, seconds: float, seed: int) -> Plan:
    rng = traffic_gen.rng_for(seed)
    n = int(mix["sessions"])
    p = traffic_gen.lengths(mix["prompt_tokens"], n, rng)
    return Plan(prompts=traffic_gen.token_ids(p, cfg.vocab_size, rng),
                max_new=cell["engine"]["max_len"] - p)


def shapes(p: Plan, cell: dict, engine) -> dict:
    """One decode batch (all sessions), the table widths from the longest
    prompt to ``max_len`` (the batch's width is its longest session's),
    and the chunk widths of the set-up prefill."""
    e = cell["engine"]
    lens = np.array([len(x) for x in p.prompts])
    c = e["prefill_chunk"]
    return {"batches": [pick_bucket(len(p.prompts),
                                    bucket_ladder(e["batch"]))],
            "widths": engine.decode_width_buckets(int(lens.max()) + 1,
                                                  e["max_len"]),
            "prefill_widths": engine.decode_width_buckets(
                min(c, int(lens.min())), int(lens.max()))}


def prepare(engine, p: Plan, obs) -> None:
    now = time.time()
    for prompt, m in zip(p.prompts, p.max_new):
        rid, req = submit(engine, prompt, int(m))
        obs.add(rid, req, now, in_window=True)
    engine.admit_prompts(np.zeros((0, 1), np.int32))
    obs.poll(time.time())
    missing = [t.rid for t in obs.tracks if not t.stamps]
    if missing:
        raise RuntimeError(f"sessions {missing} hold no first token after "
                           "set-up")


def failed(tracks) -> int:
    """A session failed if it decoded fewer than two tokens in the window."""
    return sum(1 for t in tracks if len(t.stamps) < 3)


def sample_pool(tracks) -> list:
    """Sessions never finish in the window: each is compared over what it
    served up to the window's end."""
    return list(tracks)


def drive(engine, p: Plan, seconds: float, obs, tracer, slicer) -> dict:
    opened = engine.payload()
    t0 = time.time()
    end = t0 + seconds
    while True:
        now = time.time()
        slicer.tick(now - t0)
        if now >= end:
            break
        with tracer.range("bench.step"):
            engine.step()
        with tracer.range("bench.poll"):
            obs.poll(time.time())
    with tracer.range("bench.sync"):
        engine.sync()
    t1 = time.time()
    obs.poll(t1)
    return {"ta": t0, "t0": t0, "t1": t1, "end": t1,
            "counters": (opened, engine.payload()), "lateness_s": []}
