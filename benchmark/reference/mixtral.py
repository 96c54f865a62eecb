"""The plain reference of a Mixtral-shaped decoder (Mixtral-8x7B-v0.1: the
Mistral attention, and in each layer's MLP slot a router over E experts,
top-k with a softmax over the k, each chosen expert's SwiGLU weighted and
summed), in float32 plain PyTorch.

It reads the benchmark's own weights dict (the layout of
``weights_moe.py``: the router [L, d, E], the experts ``we_gate``,
``we_up`` [L, E, d, F] and ``we_down`` [L, E, F, d]) and nothing that the
program made, and imports nothing of the program; attention, rope and the
norm are ``llama.py``'s. It runs one layer at a time and, inside a layer,
one expert at a time, upcasting only that expert's bf16 weights to
float32, so that 16 layers of eight 14,336-wide experts over a few
thousand tokens fit beside the weights in a few GB. No cache and no
batching: the whole sequence goes through every layer. TF32 is switched
off: every product is a float32 one.

Departures from the published model: none in the arithmetic. The k largest
logits are taken by ``torch.topk`` (descending) and softmaxed over those k,
which equals the published softmax over all E, top-k, renormalised. An
expert that no token chose is skipped, which changes nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import llama


@dataclasses.dataclass(frozen=True)
class Config(llama.Config):
    """The sizes the reference needs, read from a ``configs/<name>.json``
    (Hugging Face key names)."""

    n_experts: int = 8
    experts_per_token: int = 2

    @classmethod
    def from_file(cls, spec: dict) -> "Config":
        base = llama.Config.from_file(spec)
        return cls(**dataclasses.asdict(base),
                   n_experts=spec["num_local_experts"],
                   experts_per_token=spec["num_experts_per_tok"])


# Router logits this close are a near-tie: the k-th and (k + 1)-th choice
# may swap on a bf16 rounding upstream.
NEAR_TIE = 1e-2


def experts(cfg: Config, lay: dict, i: int, h: torch.Tensor,
            ties: dict | None = None) -> torch.Tensor:
    """Layer ``i``'s routed experts over the normed rows ``h`` [T, d]
    (float32): the weighted sum of each row's k experts' SwiGLU. ``ties``,
    where given, counts the rows (``rows``) and those whose k-th and
    (k + 1)-th logits lie within ``NEAR_TIE`` (``near``)."""
    logits = h @ lay["router"][i].float()                    # [T, E]
    k = cfg.experts_per_token
    if ties is not None and k < cfg.n_experts:
        top = torch.topk(logits, k + 1, dim=-1).values
        ties["rows"] = ties.get("rows", 0) + top.shape[0]
        ties["near"] = ties.get("near", 0) + int(
            (top[:, k - 1] - top[:, k] < NEAR_TIE).sum())
    vals, idx = torch.topk(logits, k, dim=-1)
    w = torch.softmax(vals, dim=-1)                           # [T, k]
    out = torch.zeros_like(h)
    for e in range(cfg.n_experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = x @ lay["we_gate"][i, e].float()
        u = x @ lay["we_up"][i, e].float()
        y = (torch.nn.functional.silu(g) * u) @ lay["we_down"][i, e].float()
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


@torch.no_grad()
def logits(cfg: Config, params: dict, tokens: torch.Tensor, start: int,
           ties: dict | None = None) -> torch.Tensor:
    """float32 logits [len(tokens) - start, vocab] of the causal model over
    ``tokens`` [T] (int64, on the weights' device): row i predicts the
    token after position ``start + i``. ``ties`` counts the router's
    near-ties (``experts``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, params, tokens, start, ties)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits(cfg: Config, params: dict, tokens: torch.Tensor, start: int,
            ties: dict | None) -> torch.Tensor:
    L, d, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    T = tokens.shape[0]
    eps = cfg.norm_eps
    lay = params["layers"]
    cos, sin = llama._rope_tables(T, hd, cfg.rope_theta, tokens.device)
    x = params["tok_embed"][tokens].float()
    for i in range(L):
        h = llama._rms_norm(x, lay["attn_norm"][i], eps)
        q = (h @ lay["wq"][i].float().reshape(d, H * hd)).view(T, H, hd)
        k = (h @ lay["wk"][i].float().reshape(d, KV * hd)).view(T, KV, hd)
        v = (h @ lay["wv"][i].float().reshape(d, KV * hd)).view(T, KV, hd)
        a = llama._attention(llama._rope(q, cos, sin),
                             llama._rope(k, cos, sin), v)
        x = x + a.reshape(T, H * hd) @ lay["wo"][i].float().reshape(H * hd, d)
        x = x + experts(cfg, lay, i,
                        llama._rms_norm(x, lay["mlp_norm"][i], eps), ties)
    x = llama._rms_norm(x[start:], params["final_norm"], eps)
    return x @ params["lm_head"].float()


def compare(cfg: Config, params: dict, sample, device) -> dict:
    """``check.compare`` over this reference: for each (prompt, served)
    pair, the gap of each served token's logit below the reference's best
    at the position that produced it. Returns the mean and the widest gap,
    the tokens compared, how many were not the reference's best, and the
    share of (layer, position) rows whose router had a near-tie
    (``near_ties``)."""
    total, widest, tokens, off_best = 0.0, 0.0, 0, 0
    ties: dict = {}
    for prompt, served in sample:
        seq = torch.as_tensor(list(prompt) + list(served[:-1]),
                              dtype=torch.long, device=device)
        ref = logits(cfg, params, seq, len(prompt) - 1, ties)
        toks = torch.as_tensor(list(served), dtype=torch.long, device=device)
        best = ref.max(dim=-1).values
        g = (best - ref.gather(1, toks[:, None])[:, 0]).double().cpu()
        total += float(g.sum())
        widest = max(widest, float(g.max()))
        tokens += len(served)
        off_best += int((g > 0).sum())
    return {"mean_gap": total / tokens, "widest_gap": widest,
            "tokens": tokens, "off_best": off_best,
            "near_ties": ties.get("near", 0) / max(1, ties.get("rows", 0))}
