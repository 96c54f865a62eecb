"""Device: the share of the traced slice's busy device time spent in the
routed expert layer's kernels (``csrc/moe_gemm.cu``: the route, the grouped
expert GEMM and the combine), in percent. None where the slice ran none."""

KERNELS = ("moe_route_kernel", "moe_expert_kernel", "moe_combine_kernel")


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    t = r.trace.kernel_seconds(KERNELS)
    return 100.0 * t / r.trace.busy_s if t else None
