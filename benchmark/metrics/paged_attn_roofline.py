"""Kernels: paged decode and chunk attention (``paged_partial``,
``paged_combine``) in the traced slice, their least time from the
benchmark's counts (roofline/paged_attn.py) over their device time, in
percent."""


def read(r):
    if r.trace is None or r.slice is None or r.peaks is None:
        return None
    a = r.roofline("paged_attn")
    t = r.trace.kernel_seconds(a.KERNEL_MATCH)
    least = a.least_seconds(r.cfg, r.slice, r.peaks)
    return 100.0 * least / t if t and least is not None else None
