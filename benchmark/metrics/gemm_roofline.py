"""Kernels: the projections' GEMM (``w8a16`` kernels) in the traced slice,
its least time from the benchmark's counts (roofline/gemm.py) over its
device time in the trace, in percent."""


def read(r):
    if r.trace is None or r.slice is None or r.peaks is None:
        return None
    g = r.roofline("gemm")
    t = r.trace.kernel_seconds(g.KERNEL_MATCH)
    return 100.0 * g.least_seconds(r.cfg, r.slice, r.peaks) / t if t \
        else None
