"""Engine scheduler: 95th percentile, over every request due in the window,
of the queue's exit (the engine's ``Request.admit_ts``) minus the due time.
A request never admitted counts at the drain's end."""

from benchmark.stats import p95


def read(r):
    end = r.win["end"]
    return p95([((t.req.admit_ts or end) - t.due) * 1e3
                for t in r.window_tracks()])
