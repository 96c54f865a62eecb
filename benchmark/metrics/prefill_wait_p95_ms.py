"""Engine scheduler: 95th percentile, over every request due in the window,
of its first prefill chunk's dispatch (the engine's
``Request.prefill_start_ts``) minus its admission (``admit_ts``): the wait
behind earlier prompts in the first-in, first-out prefill. A request never
started by the drain's end counts at the drain's end, from its admission or,
never admitted, from its due time. None where the program keeps no such
stamp."""

from benchmark.stats import p95


def read(r):
    tracks = r.window_tracks()
    if not tracks or not hasattr(tracks[0].req, "prefill_start_ts"):
        return None
    end = r.win["end"]
    return p95([((t.req.prefill_start_ts or end)
                 - (t.req.admit_ts or t.due)) * 1e3 for t in tracks])
