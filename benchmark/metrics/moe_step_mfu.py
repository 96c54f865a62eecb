"""Device: the model operations of every token a Mixtral-shaped MoE
prefilled or decoded in the traced slice (roofline/moe_model.py: the k
experts a token chose and the router, attention over the real contexts)
over the seconds the device was busy in it times the card's bf16 peak, in
percent; ``step_mfu`` for a model whose step is not a dense MLP. None
where the slice's prefill chunks cannot be accounted for, or the model has
no experts."""


def read(r):
    if r.trace is None or r.slice is None or r.peaks is None \
            or r.trace.busy_s <= 0 or not hasattr(r.cfg, "n_experts") \
            or (r.slice.chunk_dispatches and r.slice.chunks is None):
        return None
    ops = r.roofline("moe_model").flops(r.cfg, r.slice)
    return 100.0 * ops / (r.trace.busy_s * r.peaks["bf16_flops"])
