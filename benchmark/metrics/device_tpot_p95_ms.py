"""Model step: ``tpot_p95_ms``'s rule over the engine's own token stamps
(``Request.token_ts``: the host-clock time at which the device finished the
step that produced each token, the first token's the fetch that brought it)
instead of the host's stamps at each window's drain. ``tpot_p95_ms`` minus
this is what the drain's delivery costs users. None where the program keeps
no such stamps."""

from benchmark.stats import p95, tpot_s


def read(r):
    vals = []
    for t in r.window_tracks():
        stamps = getattr(t.req, "token_ts", None)
        if stamps:
            vals.append(tpot_s([t.req.first_token_ts] + list(stamps),
                               r.win["t0"]))
    return p95([v * 1e3 for v in vals if v is not None])
