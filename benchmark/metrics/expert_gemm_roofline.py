"""Kernels: the grouped expert GEMM (``moe_expert_kernel``) in the traced
slice, its least time from the benchmark's counts (roofline/expert_gemm.py:
the weights of the experts reached, from the engine's expert counters of
the window, scaled to the slice by its dispatches) over its device time in
the trace, in percent. None without the counters or the kernel."""


def read(r):
    if r.trace is None or r.slice is None or r.peaks is None:
        return None
    g = r.roofline("expert_gemm")
    t = r.trace.kernel_seconds(g.KERNEL_MATCH)
    least = g.least_seconds(r.cfg, r.slice, r.peaks, r.counters0,
                            r.counters1)
    return 100.0 * least / t if t and least is not None else None
