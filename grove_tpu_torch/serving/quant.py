"""Weight-only int8 quantization for the serving path.

Matmul weights are stored as int8 with per-output-channel bf16 scales
(symmetric, scale = amax / 127). The model's projections read them through
the W8A16 GEMM (ops/w8a16.py, called from ``llama._proj`` and
``llama._logits``): on the card a kernel that reads the weight as int8 and
forms ``materialize``'s bf16 values in shared memory, as XLA fuses the
upcast into the matmul's operand read in the JAX package; on the CPU the
plain version, ``materialize`` and then the matmul. The embedding gathers
int8 rows and scales them (``llama.embed``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor       # int8, same shape as the original weight
    scale: torch.Tensor   # bf16, broadcastable (contracted axes kept as 1)

    @property
    def shape(self):
        return self.q.shape

    def materialize(self) -> torch.Tensor:
        """The dequantized weight, computed in the scale's type."""
        return self.q.to(self.scale.dtype) * self.scale

    def __getitem__(self, idx) -> "QTensor":
        """Slice q and scale together (a layer of a stacked weight)."""
        return QTensor(q=self.q[idx], scale=self.scale[idx])


# Parameter leaf -> axes CONTRACTED by its matmul (the scale is per output
# channel, i.e. reduced over exactly these axes). The leading L stacking
# axis is counted where present.
_CONTRACT_AXES: dict[str, tuple[int, ...]] = {
    "wq": (1,), "wk": (1,), "wv": (1,),        # [L, d, h, hd] @ d
    "wo": (1, 2),                              # [L, h, hd, d] @ (h, hd)
    "w_gate": (1,), "w_up": (1,),              # [L, d, ff]    @ d
    "w_down": (1,),                            # [L, ff, d]    @ ff
    "lm_head": (0,),                           # [d, v]        @ d
    "tok_embed": (1,),                         # [v, d] gather: per-row
}


def quantize_tensor(w: torch.Tensor, axes: tuple[int, ...]) -> QTensor:
    """Symmetric per-channel int8: scale = amax/127 over ``axes``; values
    are rounded half to even with the f32 scale and clipped to +-127; the
    stored scale is bf16."""
    wf = w.to(torch.float32)
    amax = torch.amax(torch.abs(wf), dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale.to(torch.bfloat16))


def quantize_params(params: Any) -> Any:
    """Quantize every known matmul leaf of a Llama params dict; norms and
    unknown leaves pass through untouched. A MoE's router and experts are
    unknown here (no kernel reads int8 experts): they stay as they are."""
    def walk(tree):
        out = {}
        for name, w in tree.items():
            if isinstance(w, dict):
                out[name] = walk(w)
            elif name in _CONTRACT_AXES and isinstance(w, torch.Tensor):
                out[name] = quantize_tensor(w, _CONTRACT_AXES[name])
            else:
                out[name] = w
        return out
    return walk(params)


def kv_bytes_per_token_per_layer(cfg: Any, kv_quant: str = "off") -> int:
    """Bytes one token's K+V occupy in one layer of the serving cache: int8
    KV stores one int8 per element plus one f32 scale per (slot, head) for
    each of K and V."""
    if kv_quant == "int8":
        return 2 * cfg.n_kv_heads * (cfg.head_dim + 4)
    if kv_quant != "off":
        raise ValueError(f"unknown KV quant mode {kv_quant!r}")
    return 2 * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize


def kv_block_bytes(cfg: Any, block_size: int, kv_quant: str = "off") -> int:
    """Device bytes of one K+V block pair across all layers: what one
    allocator grant costs in device memory."""
    return cfg.n_layers * block_size * kv_bytes_per_token_per_layer(
        cfg, kv_quant)


def flatten_params(tree: Any, prefix: str = ""
                   ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A params dict's tensors by path in key order (``layers/wq``; a
    ``QTensor`` as ``path/q`` and ``path/scale``) and the paths of its
    ``QTensor`` leaves."""
    flat: dict[str, torch.Tensor] = {}
    qtensors: list[str] = []
    for name, leaf in tree.items():
        if not isinstance(name, str) or "/" in name:
            raise ValueError(f"param key {name!r} is not a plain string")
        key = prefix + name
        if isinstance(leaf, dict):
            sub, subq = flatten_params(leaf, key + "/")
            flat.update(sub)
            qtensors += subq
        elif isinstance(leaf, QTensor):
            flat[key + "/q"] = leaf.q
            flat[key + "/scale"] = leaf.scale
            qtensors.append(key)
        elif isinstance(leaf, torch.Tensor):
            flat[key] = leaf
        else:
            raise TypeError(f"param {key!r} is a {type(leaf).__name__}, "
                            f"not a tensor")
    return flat, qtensors


def unflatten_params(flat: dict[str, torch.Tensor],
                     qtensors: list[str]) -> dict:
    """The params dict of ``flatten_params``' output: ``path/q`` and
    ``path/scale`` of each path in ``qtensors`` become one ``QTensor``."""
    q = set(qtensors)
    tree: dict = {}
    for key, t in flat.items():
        head, _, last = key.rpartition("/")
        if head in q:
            if last != "q":
                continue
            key, t = head, QTensor(q=t, scale=flat[head + "/scale"])
        node = tree
        *dirs, name = key.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = t
    return tree


def params_bytes(params: Any) -> int:
    """Actual bytes of a (possibly quantized) params dict."""
    return sum(t.numel() * t.element_size()
               for t in flatten_params(params)[0].values())
