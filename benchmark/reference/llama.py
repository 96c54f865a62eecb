"""The plain reference: a Llama-family decoder (RMSNorm, rotary positions in
the rotate-half pairing, grouped-query causal attention, SwiGLU MLP, untied
head), as the published Llama, Mistral and Yi configurations describe it, in
float32 plain PyTorch.

It reads the benchmark's own weights dict (the layout of ``weights.py``) and
nothing that the program made, and imports nothing of the program. It runs
one layer at a time, upcasting that layer's bf16 weights to float32 as it
goes, and attends in blocks of query rows, so that a 9 B model over a few
thousand tokens fits in a few GB beside the weights. TF32 is switched off:
every product is a float32 one.

Departures from the published models: none in the arithmetic. The rotary
angles are taken in float64 and rounded once to float32.
"""

from __future__ import annotations

import dataclasses

import torch

Q_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class Config:
    """The sizes the reference needs, read from a ``configs/<name>.json``
    (Hugging Face key names)."""

    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int
    rope_theta: float
    norm_eps: float

    @classmethod
    def from_file(cls, spec: dict) -> "Config":
        return cls(vocab_size=spec["vocab_size"],
                   d_model=spec["hidden_size"],
                   n_layers=spec["num_hidden_layers"],
                   n_heads=spec["num_attention_heads"],
                   n_kv_heads=spec["num_key_value_heads"],
                   d_ff=spec["intermediate_size"],
                   head_dim=spec.get("head_dim", spec["hidden_size"]
                                     // spec["num_attention_heads"]),
                   rope_theta=float(spec["rope_theta"]),
                   norm_eps=float(spec["rms_norm_eps"]))


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope_tables(n: int, hd: int, theta: float, device) -> tuple:
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=device) / hd))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return ang.cos().float(), ang.sin().float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x [T, heads, hd]: dimension i pairs with i + hd / 2."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Causal GQA attention: q [T, H, hd], k and v [T, KV, hd]; query head
    j reads kv head j // (H / KV)."""
    T, H, hd = q.shape
    kv = k.shape[1]
    g = H // kv
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                      # [KV, hd, T]
    vt = v.permute(1, 0, 2)                      # [KV, T, hd]
    for s in range(0, T, Q_BLOCK):
        e = min(T, s + Q_BLOCK)
        qb = q[s:e].reshape(e - s, kv, g, hd).permute(1, 2, 0, 3)
        scores = torch.matmul(qb, kt[:, None, :, :e]) * hd ** -0.5
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None, :]
        scores.masked_fill_(cols > rows, float("-inf"))
        p = torch.softmax(scores, dim=-1)        # [KV, g, rows, e]
        o = torch.matmul(p, vt[:, None, :e])     # [KV, g, rows, hd]
        out[s:e] = o.permute(2, 0, 1, 3).reshape(e - s, H, hd)
    return out


@torch.no_grad()
def logits(cfg: Config, params: dict, tokens: torch.Tensor, start: int
           ) -> torch.Tensor:
    """float32 logits [len(tokens) - start, vocab] of the causal model over
    ``tokens`` [T] (int64, on the weights' device): row i predicts the
    token after position ``start + i``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, params, tokens, start)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits(cfg: Config, params: dict, tokens: torch.Tensor, start: int
            ) -> torch.Tensor:
    L, d, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    T = tokens.shape[0]
    eps = cfg.norm_eps
    lay = params["layers"]
    cos, sin = _rope_tables(T, hd, cfg.rope_theta, tokens.device)
    x = params["tok_embed"][tokens].float()
    for i in range(L):
        h = _rms_norm(x, lay["attn_norm"][i], eps)
        q = (h @ lay["wq"][i].float().reshape(d, H * hd)).view(T, H, hd)
        k = (h @ lay["wk"][i].float().reshape(d, KV * hd)).view(T, KV, hd)
        v = (h @ lay["wv"][i].float().reshape(d, KV * hd)).view(T, KV, hd)
        a = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v)
        x = x + a.reshape(T, H * hd) @ lay["wo"][i].float().reshape(H * hd, d)
        h = _rms_norm(x, lay["mlp_norm"][i], eps)
        gate = h @ lay["w_gate"][i].float()
        up = h @ lay["w_up"][i].float()
        x = x + (torch.nn.functional.silu(gate) * up) @ lay["w_down"][i].float()
    x = _rms_norm(x[start:], params["final_norm"], eps)
    return x @ params["lm_head"].float()
