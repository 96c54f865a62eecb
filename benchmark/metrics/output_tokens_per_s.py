"""Every output token the host saw inside the window, over the window's
seconds (the window ends after a sync, so every token dispatched in it is
counted in it)."""


def read(r):
    t0, t1 = r.win["t0"], r.win["t1"]
    return r.obs.tokens_between(t0, t1) / (t1 - t0)
