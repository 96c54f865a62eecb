"""Operations and bytes of the projections' GEMM (``csrc/w8a16_gemm.cu``,
``dense_matmul`` for bf16 weights) over a traced slice.

Each forward reads every projection weight and the LM head once; the
activations are read once and the outputs written once, over the rows each
dispatch had: a decode step's live rows (the graph's padded rows are not
counted), a prefill chunk's ``c`` rows (the chunk's GEMM runs at M = c) and
the one row whose logits the chunk takes. The least time of a dispatch is
the larger of its bytes at the memory rate and its operations at the bf16
tensor-core peak (the arithmetic of ``chip_smoke.py``'s ``w8a16_bound_ms``).
Decode dispatches are summed before the larger is taken: that is never more
than the sum over dispatches, so the share is never overstated.
"""

from __future__ import annotations

KERNEL_MATCH = ("w8a16",)


def shapes(cfg) -> dict:
    d, h, kv, hd, ff, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.n_layers,
                              cfg.vocab_size)
    proj = L * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff)
    # One row's activations per layer, in and out of each launch group:
    # [wq wk wv] reads x once, wo, [w_gate w_up] reads x once, w_down.
    act_in = L * (d + h * hd + d + ff)
    act_out = L * ((h + 2 * kv) * hd + d + 2 * ff + d)
    return {"proj_params": proj, "head_params": d * V,
            "act_elems": act_in + act_out, "head_in": d, "head_out": V}


def least_seconds(cfg, acc, peaks: dict, elt: int = 2) -> float:
    """``acc``: the slice's dispatch accounting (harness.SliceAccount)."""
    s = shapes(cfg)
    bw, flops = peaks["hbm_bytes_per_s"], peaks["bf16_flops"]
    w_bytes = (s["proj_params"] + s["head_params"]) * elt
    row_bytes = s["act_elems"] * elt + s["head_in"] * elt + s["head_out"] * 4
    dec_bytes = acc.decode_dispatches * w_bytes + acc.decode_rows * row_bytes
    dec_ops = 2 * acc.decode_rows * (s["proj_params"] + s["head_params"])
    total = max(dec_bytes / bw, dec_ops / flops)
    c = acc.chunk_width
    ch_bytes = (w_bytes + c * s["act_elems"] * elt + s["head_in"] * elt
                + s["head_out"] * 4)
    ch_ops = 2 * (c * s["proj_params"] + s["head_params"])
    total += acc.chunk_dispatches * max(ch_bytes / bw, ch_ops / flops)
    return total
