"""Engine scheduler: 95th percentile, over every request due in the window,
of its first token (``Request.first_token_ts``) minus its first prefill
chunk's dispatch (``prefill_start_ts``): the ticks its prompt's chunks are
spread over. A request with no first token by the drain's end counts at the
drain's end, from its first chunk or, never started, from its admission or
due time. None where the program keeps no such stamp."""

from benchmark.stats import p95


def read(r):
    tracks = r.window_tracks()
    if not tracks or not hasattr(tracks[0].req, "prefill_start_ts"):
        return None
    end = r.win["end"]
    return p95([((t.req.first_token_ts or end)
                 - (t.req.prefill_start_ts or t.req.admit_ts or t.due))
                * 1e3 for t in tracks])
