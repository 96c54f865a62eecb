"""95th percentile, over every window request with two or more output
tokens, of (last token - first token) / (tokens after the first), each token
stamped when the host first saw it; tokens stamped before the window (a
session's set-up) are left out."""

from benchmark.stats import p95, tpot_s


def read(r):
    vals = [tpot_s(t.stamps, r.win["t0"]) for t in r.window_tracks()]
    return p95([v * 1e3 for v in vals if v is not None])
