"""Device: the model operations of every token prefilled or decoded in the
traced slice, attention over the real contexts included (roofline/model.py),
over the seconds the device was busy in it times the card's bf16 peak, in
percent. The busy seconds, not the slice's, because in an open loop the
work of a slice is set by the arrivals: a faster step then does the same
work in less device time, and only a share of the busy time shows it. None
where the slice's prefill chunks cannot be accounted for."""


def read(r):
    if r.trace is None or r.slice is None or r.peaks is None \
            or r.trace.busy_s <= 0 or (r.slice.chunk_dispatches
                                       and r.slice.chunks is None):
        return None
    ops = r.roofline("model").flops(r.cfg, r.slice)
    return 100.0 * ops / (r.trace.busy_s * r.peaks["bf16_flops"])
