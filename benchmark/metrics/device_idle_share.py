"""Device: the share of the traced slice in which no operation ran on the
card, in percent (1 - the union of device operations / the slice)."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
