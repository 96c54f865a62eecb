"""95th percentile, over every request due in the window, of its first
token's host stamp (the engine's ``first_token_ts``) minus its due time. A
request with no first token by the drain's end counts at the drain's end."""

from benchmark.stats import p95


def read(r):
    end = r.win["end"]
    return p95([((t.req.first_token_ts or end) - t.due) * 1e3
                for t in r.window_tracks()])
