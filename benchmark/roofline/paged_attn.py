"""Operations and bytes of paged attention (``csrc/paged_attn.cu``: the
decode and chunk kernels and their combine) over a traced slice.

Every live token's K and V rows are read once per step and layer (all kv
heads, bf16), the queries read once and the outputs written once; the
operations are 4 * head_dim per (query head, visible key) pair. A decode
token k of a request with prompt P attends over P + k positions; a chunk of
``valid`` rows at ``offset`` over offset + valid, causally. The least time
of a dispatch is the larger of its bytes at the memory rate and its
operations at the bf16 peak (``chip_smoke.py``'s ``paged_bound_ms``); a
decode step is bound by bytes (H / KV operations per byte), so its
dispatches are summed first.
"""

from __future__ import annotations

KERNEL_MATCH = ("paged_partial", "paged_combine")


def least_seconds(cfg, acc, peaks: dict, elt: int = 2) -> float | None:
    if acc.chunks is None:
        return None
    h, kv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    bw, flops = peaks["hbm_bytes_per_s"], peaks["bf16_flops"]
    kv_row = 2 * kv * hd * elt                   # K and V of one position
    q_row = 2 * h * hd * elt                     # a query read, its output
    dec_bytes = L * (acc.decode_ctx_sum * kv_row + acc.decode_rows * q_row)
    dec_ops = 4 * hd * h * L * acc.decode_ctx_sum
    total = max(dec_bytes / bw, dec_ops / flops)
    for offset, valid in acc.chunks:
        nbytes = L * ((offset + valid) * kv_row + valid * q_row)
        pairs = valid * offset + valid * (valid + 1) // 2
        total += max(nbytes / bw, 4 * hd * h * L * pairs / flops)
    return total
