"""Model operations of the tokens a window served by a Mixtral-shaped MoE,
for the whole step's share of the chip's peak: 2 operations per weight a
token passes through (the attention projections, its k experts' SwiGLU and
the router in every layer; the LM head once per decoded token and once per
prompt), and 4 * head_dim per (query head, visible key) pair of attention.
The experts a token did not choose are not counted."""

from __future__ import annotations


def flops(cfg, acc) -> float:
    d, h, kv, hd, ff, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.n_layers,
                              cfg.vocab_size)
    E, k = cfg.n_experts, cfg.experts_per_token
    proj = L * (d * h * hd + 2 * d * kv * hd + h * hd * d
                + k * 3 * d * ff + d * E)
    head = d * V
    attn = 4 * hd * h * L
    total = 2 * acc.decode_rows * (proj + head) + attn * acc.decode_ctx_sum
    for offset, valid in acc.chunks or ():
        pairs = valid * offset + valid * (valid + 1) // 2
        total += 2 * valid * proj + attn * pairs
    total += 2 * head * acc.prompts_done
    return float(total)
