"""Llama-family decoder as plain PyTorch functions over a params dict.

The params dict keeps the JAX package's key names and layouts: layers are
stacked on axis 0 (``wq`` is [L, d, h, hd]), so weights convert key for key
(grove_tpu_torch/convert.py). The JAX ``lax.scan`` over layers is a Python
loop over the L axis here, and the KV cache is updated in place.

Products take the working type's inputs: where the JAX code asks for an
f32 result (``preferred_element_type``), the port multiplies the same
values upcast to f32. Every projection goes through the GEMM kernel of
ops/w8a16.py on CUDA tensors (int8 weights, ``QTensor`` leaves: the W8A16
build, which reads the weight as int8; dense weights: its bf16-weight
build) and its plain version on CPU tensors (materialize then matmul; the
einsum). Each residual add runs inside the next norm (``add_rms_norm``).

Training (``forward``, ``loss_fn``) takes none of that: the kernels have no
backward (each wrapper raises on an input that requires grad), so its
layers are the JAX package's in plain ops, as XLA runs them there; under a
mesh (``mesh=``) each rank runs its block of them, with the collectives as
autograd Functions (the training section below).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from grove_tpu_torch.device import resolve_device
from grove_tpu_torch.ops.attention import (causal_attention, decode_attention,
                                           pick_causal_attention)
from grove_tpu_torch.ops.kvcache import KVCache, write_rows
from grove_tpu_torch.ops.kvquant import (paged_rope_scatter,
                                         paged_rope_scatter_q)
from grove_tpu_torch.ops.norms import add_rms_norm, rms_norm, rms_norm_ref
from grove_tpu_torch.ops.paged import (paged_chunk_attention,
                                       paged_chunk_attention_q8,
                                       paged_decode_attention,
                                       paged_decode_attention_q8)
from grove_tpu_torch.ops.rope import apply_rope, rope_table
from grove_tpu_torch.ops.w8a16 import (ROW_INVARIANT_M, dense_matmul_group,
                                       dense_matmul_ref, w8a16_matmul_group)
from grove_tpu_torch.serving.quant import QTensor

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 5632
    head_dim: int = 128
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def params_bytes(self) -> int:
        c = self
        per_layer = (2 * c.d_model
                     + c.d_model * c.n_heads * c.head_dim
                     + 2 * c.d_model * c.n_kv_heads * c.head_dim
                     + c.n_heads * c.head_dim * c.d_model
                     + 3 * c.d_model * c.d_ff)
        total = (2 * c.vocab_size * c.d_model + c.d_model
                 + c.n_layers * per_layer)
        return total * c.dtype.itemsize


CONFIGS: dict[str, LlamaConfig] = {
    # Tiny config for unit tests.
    "test-tiny": LlamaConfig(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=8, n_kv_heads=4, d_ff=128, head_dim=8,
                             max_seq_len=128),
    # ~1.1B: the single-card serving model.
    "llama-1b": LlamaConfig(vocab_size=32000, d_model=2048, n_layers=16,
                            n_heads=16, n_kv_heads=8, d_ff=5632, head_dim=128,
                            max_seq_len=2048),
    # Llama-3-8B-shaped.
    "llama-8b": LlamaConfig(vocab_size=128256, d_model=4096, n_layers=32,
                            n_heads=32, n_kv_heads=8, d_ff=14336, head_dim=128,
                            max_seq_len=8192),
    # Llama-70B-shaped.
    "llama-70b": LlamaConfig(vocab_size=128256, d_model=8192, n_layers=80,
                             n_heads=64, n_kv_heads=8, d_ff=28672, head_dim=128,
                             max_seq_len=8192),
}


def draft_config(cfg: LlamaConfig) -> LlamaConfig:
    """Shrink a target config into its speculative-decoding draft: a
    quarter of the width and depth, the same vocab (acceptance compares
    token ids), rope geometry, context budget and head_dim (so the draft's
    pool shares the target's block geometry and tables; only n_kv and the
    layer count differ)."""
    n_heads = max(2, cfg.n_heads // 4)
    n_kv = max(1, cfg.n_kv_heads // 4)
    while n_heads % n_kv:  # GQA grouping needs an even split
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        d_model=max(32, cfg.d_model // 4),
        n_layers=max(1, cfg.n_layers // 4),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=max(64, cfg.d_ff // 4),
    )


def dense_init(cfg: LlamaConfig, shape, fan_in: int,
               generator: torch.Generator | None,
               device: torch.device) -> torch.Tensor:
    """normal(0, 1) * fan_in**-0.5 drawn in f32 from ``generator``, cast to
    ``cfg.dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * (fan_in ** -0.5)).to(cfg.dtype)


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device: str | torch.device | None = None,
                include_mlp: bool = True) -> Params:
    """Random params (layers stacked on axis 0): ``dense_init`` weights;
    norms are ones. The numbers come from ``generator`` (torch's RNG, so
    not the JAX package's numbers); it must live on ``device``.
    ``device=None`` means the card. ``include_mlp=False`` leaves out the
    dense MLP (the MoE family replaces it, and at real widths it would be
    gigabytes thrown away)."""
    dev = resolve_device(device)
    d, h, kv, hd, ff, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.n_layers)

    def dense(shape, fan_in):
        return dense_init(cfg, shape, fan_in, generator, dev)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "attn_norm": ones((L, d)),
        "mlp_norm": ones((L, d)),
        "wq": dense((L, d, h, hd), d),
        "wk": dense((L, d, kv, hd), d),
        "wv": dense((L, d, kv, hd), d),
        "wo": dense((L, h, hd, d), h * hd),
    }
    if include_mlp:
        layers.update({
            "w_gate": dense((L, d, ff), d),
            "w_up": dense((L, d, ff), d),
            "w_down": dense((L, ff, d), ff),
        })
    return {
        "tok_embed": dense((cfg.vocab_size, d), d),
        "lm_head": dense((d, cfg.vocab_size), d),
        "final_norm": ones((d,)),
        "layers": layers,
    }


@functools.lru_cache(maxsize=8)
def _rope(max_seq_len: int, head_dim: int, theta: float,
          device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rope tables on ``device``, built once per geometry (read-only)."""
    return rope_table(max_seq_len, head_dim, theta, device=device)


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked layer dict (int8 leaves slice q and scale
    together)."""
    return {name: w[i] for name, w in layers.items()}


def _matmul(x: torch.Tensor, ws, n_contract: int, out_dtype: torch.dtype,
            wide: bool = False) -> list[torch.Tensor]:
    """``x`` [..., *w.shape[:n_contract]] contracted with the leading
    ``n_contract`` axes of each weight of ``ws`` (all int8 or all dense):
    one grouped launch of the GEMM kernel on CUDA tensors (x as [M, K],
    each weight as the [K, N] it is stored as, an int8 weight's scales as
    [N]), its plain version on CPU tensors. Above 256 rows the call runs in
    slabs of 256 rows, each row with the bits it has at any M <= 256,
    unless ``wide`` (the lanes prefill): then int8 weights take the wide
    kernel and dense ones ``torch.matmul``."""
    k = ws[0].shape[:n_contract].numel()
    x2 = x.reshape(-1, k)
    if isinstance(ws[0], QTensor):
        ys = w8a16_matmul_group(
            x2, [(w.q.reshape(k, -1), w.scale.reshape(-1)) for w in ws],
            out_dtype, slabbed=not wide)
    elif wide and x2.is_cuda and x2.shape[0] > ROW_INVARIANT_M:
        ys = [dense_matmul_ref(x2, w.reshape(k, -1), out_dtype) for w in ws]
    else:
        ys = dense_matmul_group(x2, [w.reshape(k, -1) for w in ws],
                                out_dtype)
    lead = x.shape[:x.dim() - n_contract]
    return [y.reshape(lead + w.shape[n_contract:]) for y, w in zip(ys, ws)]


def _projs(eq: str, x: torch.Tensor, ws, wide: bool = False
           ) -> list[torch.Tensor]:
    """``einsum(eq, x, w)`` for each weight of ``ws`` (they share x; all
    int8 or all dense), with JAX's type promotion: mixed inputs (an f32
    model over bf16 int8 scales) meet in the wider type. Every equation here contracts x's trailing axes
    with w's leading ones, so int8 weights go through the W8A16 GEMM and,
    on CUDA tensors, dense ones through its dense build, one launch for all
    (``_matmul``); dense weights on CPU tensors take the einsum itself."""
    w_axes, out_axes = eq.split(",")[1].split("->")
    n_contract = sum(a not in out_axes for a in w_axes)
    if isinstance(ws[0], QTensor):
        return _matmul(x, ws, n_contract,
                       torch.promote_types(x.dtype, ws[0].scale.dtype), wide)
    dt = torch.promote_types(x.dtype, ws[0].dtype)
    if not x.is_cuda:
        return [torch.einsum(eq, x.to(dt), w.to(dt)) for w in ws]
    return _matmul(x.to(dt), [w.to(dt) for w in ws], n_contract, dt, wide)


def _proj(eq: str, x: torch.Tensor, w, wide: bool = False) -> torch.Tensor:
    """``_projs`` of one weight."""
    return _projs(eq, x, [w], wide)[0]


def _qkv_proj(h, lp, wide: bool = False):
    """The QKV projections of the normed rows ``h``, before rope (the paged
    path ropes inside its KV write)."""
    return _projs("bsd,dhk->bshk", h, [lp["wq"], lp["wk"], lp["wv"]], wide)


def _reduce(y: torch.Tensor, tp) -> torch.Tensor:
    """A head- or mlp-sharded projection's partial sum, summed over the tp
    group (``y`` itself without one)."""
    return y if tp is None else tp.all_reduce(y)


def _attn_out(attn, lp, dtype: torch.dtype, wide: bool = False, tp=None):
    """The attention output's projection, as the residual's type."""
    return _reduce(_proj("bshk,hkd->bsd", attn, lp["wo"], wide),
                   tp).to(dtype)


def _mlp_block(h, lp, dtype: torch.dtype, wide: bool = False, tp=None):
    """The SwiGLU MLP of the normed rows ``h``, as the residual's type."""
    gate, up = _projs("bsd,df->bsf", h, [lp["w_gate"], lp["w_up"]], wide)
    return _reduce(_proj("bsf,fd->bsd", F.silu(gate) * up, lp["w_down"],
                         wide), tp).to(dtype)


def _decoder(cfg: LlamaConfig, params: Params, x: torch.Tensor, attend,
             wide: bool = False, tp=None) -> torch.Tensor:
    """The decoder layers over the embedded rows ``x`` [b, s, d]:
    ``attend(i, q, k, v)`` is layer i's attention over the unroped
    projections (rope, the cache write and attention). Returns the final
    norm's rows.

    Each residual add is fused with the norm after it (``add_rms_norm``):
    the attention output's with ``mlp_norm``, the MLP's with the next
    layer's ``attn_norm`` (the last layer's with ``final_norm``), so a
    forward runs one plain norm and 2 n_layers fused ones, and no separate
    add; the bits are those of the add and then the norm.

    Under a tp group (``tp``, parallel/mesh.py's ``AxisComm``; the params
    are its rank's slices) the attention output's and the MLP's partial
    projections are summed over the group before the fused add: the JAX
    package's psum sites in ``_attn_out`` and ``_mlp_block``, and where
    GSPMD reduces the head- and mlp-sharded products."""
    layers, eps = params["layers"], cfg.norm_eps
    h = rms_norm(x, layers["attn_norm"][0], eps)
    for i in range(cfg.n_layers):
        lp = layer_params(layers, i)
        attn = attend(i, *_qkv_proj(h, lp, wide))
        x, h = add_rms_norm(x, _attn_out(attn, lp, x.dtype, wide, tp),
                            lp["mlp_norm"], eps)
        nxt = (layers["attn_norm"][i + 1] if i + 1 < cfg.n_layers
               else params["final_norm"])
        x, h = add_rms_norm(x, _mlp_block(h, lp, x.dtype, wide, tp), nxt,
                            eps)
    return h


def _embed_rows(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                tp=None) -> torch.Tensor:
    """The rows of this rank's table: under a tp group the table is its
    slice of the vocab, and an id outside it reads a zero row."""
    te = params["tok_embed"]
    if tp is not None:
        rows = te.shape[0]
        local = tokens - tp.rank * rows
        hit = (local >= 0) & (local < rows)
        tokens = torch.where(hit, local, torch.zeros_like(local))
    if isinstance(te, QTensor):  # int8: gather rows, then scale them
        x = (te.q[tokens].to(te.scale.dtype)
             * te.scale[tokens]).to(cfg.dtype)
    else:
        x = te[tokens].to(cfg.dtype)
    if tp is None:
        return x
    return torch.where(hit[..., None], x, torch.zeros_like(x))


def embed(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
          tp=None) -> torch.Tensor:
    """Token embedding. Under a tp group the table is this rank's slice of
    the vocab: an id outside it reads a zero row, and the sum over the group
    is exact, since each row has one non-zero term."""
    x = _embed_rows(cfg, params, tokens, tp)
    return x if tp is None else tp.all_reduce(x)


def _logits(x: torch.Tensor, w, tp=None) -> torch.Tensor:
    """LM-head product with an f32 result: the working-type values upcast
    to f32, as the JAX ``preferred_element_type=f32`` product (through the
    GEMM kernel with an f32 output: an int8 head's W8A16 build, a dense
    head's bf16-weight build, which reads the head as stored). Under a tp
    group each rank computes its vocab slice and the slices are gathered
    into the full logits, so that every rank chooses the same tokens."""
    if isinstance(w, QTensor) or x.is_cuda:
        y = _matmul(x, [w], 1, torch.float32)[0]
    else:
        y = x.to(torch.float32) @ w.to(torch.float32)
    return y if tp is None else tp.all_gather(y)


def prefill(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            cache: KVCache, lengths: torch.Tensor | None = None,
            tp=None) -> tuple[torch.Tensor, KVCache]:
    """Prefill: run the prompt, fill the cache, return last-token logits.

    tokens: [b, s], right-padded to a static s; ``lengths`` [b] gives the
    true prompt length per lane (defaults to s). Cache lanes are
    overwritten from position 0, in place. Pad positions >= length are
    causally invisible to valid tokens and marked invalid by the returned
    lengths; the logits are taken at each lane's last valid token.

    Returns (logits [b, vocab] f32, ``cache`` with lengths set per lane).

    ``tp`` (parallel/mesh.py's ``AxisComm``) runs the prefill as one rank
    of a tensor-parallel group, as ``decode_step_paged`` does: ``params``
    are the rank's slices (parallel/sharding.py ``shard_params``), the
    cache holds its n_kv / tp heads, and the logits are the full vocab on
    every rank. ``prefill_chunk``, ``prefill_chunked`` and ``decode_step``
    take it too; without it no collective runs.
    """
    b, s = tokens.shape
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    positions = torch.arange(s, device=dev).expand(b, s)
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    # CUDA tensors and a fitting shape -> the flash kernel; else plain.
    attn_fn = pick_causal_attention(s, cfg.head_dim, device=dev)

    def attend(i, q, k, v):
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        write_rows(cache.k[i], k, 0)
        write_rows(cache.v[i], v, 0)
        if attn_fn is None:
            return causal_attention(q, k, v, q_offset=0)
        return attn_fn(q, k, v)

    # b * s rows: the wide int8 kernel or torch.matmul past 256.
    x = _decoder(cfg, params, embed(cfg, params, tokens, tp), attend,
                 wide=True, tp=tp)
    # Last valid token per lane (ragged batches: pad rows carry garbage).
    last = (lengths.to(torch.long) - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=dev), last]
    cache.lengths = lengths.to(device=dev, dtype=torch.int32)
    return _logits(x_last, params["lm_head"], tp), cache


def prefill_chunk(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                  cache: KVCache, offset: int, tp=None
                  ) -> tuple[torch.Tensor, KVCache]:
    """One chunked-prefill window: tokens [b, c] at absolute positions
    [offset, offset + c) against a cache whose first ``offset`` rows are
    filled. Rows [offset, offset + c) of the cache are written in place
    (clamped like ``write_rows`` past max_len), and attention reads only
    cache[:offset + c], so the scores are [b, h, c, offset + c] instead of
    the whole prompt's square.

    The offset-0 window is square and causal: ``pick_causal_attention``
    gives it the flash kernel on CUDA tensors when ``c % 128 == 0``. Later
    windows are rectangular (q against a longer prefix), which the kernel
    does not tile: they take the plain ``causal_attention`` over the cache.

    Returns (rows [b, c, d_model] after the final norm, ``cache`` with its
    lengths set to offset + c): the caller gathers each lane's last valid
    row and applies the LM head once."""
    b, c = tokens.shape
    end = offset + c
    dev = tokens.device
    positions = (offset + torch.arange(c, device=dev)).expand(b, c)
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    flash = pick_causal_attention(c, cfg.head_dim, q_offset=offset,
                                  device=dev)

    def attend(i, q, k, v):
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        kc = write_rows(cache.k[i], k, offset)
        vc = write_rows(cache.v[i], v, offset)
        if flash is not None:  # offset 0: the window is the whole prefix
            return flash(q, k, v)
        return causal_attention(q, kc[:, :end], vc[:, :end], q_offset=offset)

    # b * c rows: the wide int8 kernel or torch.matmul past 256.
    x = _decoder(cfg, params, embed(cfg, params, tokens, tp), attend,
                 wide=True, tp=tp)
    cache.lengths = torch.full((b,), end, dtype=torch.int32, device=dev)
    return x, cache


def prefill_chunked(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                    cache: KVCache, chunk: int,
                    lengths: torch.Tensor | None = None, tp=None
                    ) -> tuple[torch.Tensor, KVCache]:
    """Bounded-memory prefill: the prompt runs in windows of ``chunk``
    positions (``prefill_chunk``), each attending over the cache filled so
    far; the cache is written in place. Matches ``prefill`` up to float
    accumulation order. Ragged batches: each lane's logits come from its
    last VALID position (``lengths``), gathered from whichever window holds
    it; the LM head runs once.

    Returns (logits [b, vocab] f32, ``cache`` with lengths set per lane)."""
    b, s = tokens.shape
    if s % chunk and s >= chunk:
        raise ValueError(f"prompt length {s} must divide into chunks of "
                         f"{chunk}")
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    else:
        lengths = torch.as_tensor(lengths).to(dev, torch.int32)
    last = lengths.to(torch.long) - 1
    lanes = torch.arange(b, device=dev)
    x_last = torch.zeros((b, cfg.d_model), dtype=cfg.dtype, device=dev)
    for off in range(0, s, chunk):
        x, cache = prefill_chunk(cfg, params, tokens[:, off:off + chunk],
                                 cache, off, tp)
        c = x.shape[1]
        # Lanes whose last valid token lands in this window keep its row.
        rows = x[lanes, (last - off).clamp(0, c - 1)]
        in_window = (last >= off) & (last < off + c)
        x_last = torch.where(in_window[:, None], rows, x_last)
    cache.lengths = lengths
    return _logits(x_last, params["lm_head"], tp), cache


def decode_step(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                cache: KVCache, tp=None) -> tuple[torch.Tensor, KVCache]:
    """One decode step. tokens: [b] (last sampled token per lane).

    Returns (logits [b, vocab] f32, ``cache`` advanced by one in place).

    Capacity: callers must not decode a lane past ``cache.max_len``: the
    cache write clamps silently (see kvcache.write_row); check
    ``cache.has_room()`` before stepping.
    """
    positions = cache.lengths[:, None]  # [b, 1]
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                     tokens.device)
    new_lengths = cache.lengths + 1

    def attend(i, q, k, v):
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        kc = write_rows(cache.k[i], k, cache.lengths)
        vc = write_rows(cache.v[i], v, cache.lengths)
        return decode_attention(q, kc, vc, new_lengths)

    x = _decoder(cfg, params, embed(cfg, params, tokens[:, None], tp),
                 attend, tp=tp)
    cache.lengths = new_lengths
    return _logits(x[:, 0], params["lm_head"], tp), cache


# ---- paged (block-table) execution path ------------------------------
# The continuous-batching engine's memory model (serving/kvcache.py): K/V
# live in fixed-size blocks [layers, num_blocks, block_size, n_kv, d] and a
# sequence's tokens are addressed through its block table. These functions
# take the raw pool tensors and write them in place (the JAX package
# donates them and returns new ones). Attention reads the pools through
# the tables with the kernels of ops/paged.py on CUDA tensors and their
# plain versions (the JAX composition: ``_paged_gather``, which is
# ops/paged.py's ``paged_gather``, then dense attention) on CPU tensors.
#
# Rope and the write are one call, ops/kvquant.py's ``paged_rope_scatter``
# (``_q`` for an int8 pool): one kernel per layer on CUDA tensors, and on
# CPU tensors its plain version, the JAX package's ``apply_rope`` on q and
# k and then its ``_paged_scatter`` (``_q``).
#
# int8 paged KV (GROVE_KV_QUANT=int8): the pools hold int8 rows with a
# per-(slot, head) f32 scale beside them ([layers, num_blocks, bs, n_kv],
# ``k_scale``/``v_scale``). The write quantizes (the JAX package's
# ``_paged_scatter_q``, inside the same kernel),
# attention dequantizes as it reads (``_paged_gather_q``'s arithmetic:
# ops/paged.py, inside the paged kernels).


def paged_block_copy(dst_k: torch.Tensor, dst_v: torch.Tensor,
                     src_k: torch.Tensor, src_v: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy K/V block rows ``src`` of the source pools into blocks ``dst``
    of the destination pools, in place (``[L, nb, bs, n_kv, d]`` each;
    ``src``/``dst`` int64 id vectors of one length, padded with the null
    block: a pad pair writes null-block garbage over the null block). The
    source rows are read before any write lands, so a pool may be its own
    source: the prefix cache's copy-on-write is this copy with one pool."""
    k_rows = src_k.index_select(1, src)
    v_rows = src_v.index_select(1, src)
    dst_k.index_copy_(1, dst, k_rows)
    dst_v.index_copy_(1, dst, v_rows)


def paged_block_copy_q(dst_k: torch.Tensor, dst_v: torch.Tensor,
                       dst_ks: torch.Tensor, dst_vs: torch.Tensor,
                       src_k: torch.Tensor, src_v: torch.Tensor,
                       src_ks: torch.Tensor, src_vs: torch.Tensor,
                       src: torch.Tensor, dst: torch.Tensor) -> None:
    """int8 variant of ``paged_block_copy``: the int8 rows and their
    per-slot scales move together, as they are (an int8 block without its
    scale rows dequantizes to garbage)."""
    paged_block_copy(dst_k, dst_v, src_k, src_v, src, dst)
    paged_block_copy(dst_ks, dst_vs, src_ks, src_vs, src, dst)


def _write_and_attend(q, k, v, cos, sin, kc, vc, ks, vs, tables, positions,
                      per_seq, valid, decode: bool):
    """One layer's rope, paged K/V write and attention, over a model-dtype
    pool (``ks`` None) or an int8 pool with its scales. q, k, v come from
    the projections unroped."""
    if ks is None:
        q = paged_rope_scatter(kc, vc, q, k, v, cos, sin, tables, positions,
                               valid)
        attn = paged_decode_attention if decode else paged_chunk_attention
        return attn(q, kc, vc, tables, per_seq)
    q = paged_rope_scatter_q(kc, vc, ks, vs, q, k, v, cos, sin, tables,
                             positions, valid)
    attn = paged_decode_attention_q8 if decode else paged_chunk_attention_q8
    return attn(q, kc, vc, ks, vs, tables, per_seq)


def decode_step_paged(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                      kv_k: torch.Tensor, kv_v: torch.Tensor,
                      tables: torch.Tensor, lengths: torch.Tensor,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None,
                      limit: torch.Tensor | None = None,
                      tp=None) -> torch.Tensor:
    """One decode step over block tables. tokens: [b]; pools:
    [layers, num_blocks, bs, n_kv, d]; tables: [b, w] int32; lengths: [b]
    int32 = tokens already in cache (the new token writes at that
    position). With ``k_scale``/``v_scale`` ([layers, num_blocks, bs,
    n_kv] f32) the pools are int8. Writes the new K/V (and scales) into the
    pools in place and returns the logits [b, vocab] f32.

    ``limit`` [b] int32, when given, caps the writes: a row at a position
    >= its limit writes into the null block instead (the speculative
    draft's steps past a sequence's backed capacity). Without it every row
    writes where its table says.

    Everything stays on the device and nothing is read back to the host,
    so the engine can capture the step in a CUDA graph: ``tables`` and
    ``lengths`` are read by the kernels from device memory. Attention reads
    only the w * bs window of the bucketed table width.

    ``tp`` (parallel/mesh.py's ``AxisComm``) runs the step as one rank of a
    tensor-parallel group: ``params`` are the rank's slices
    (parallel/sharding.py ``shard_params``), the pools hold its n_kv / tp
    heads, and each forward runs 2 n_layers + 2 collectives (the
    embedding's sum, two sums per layer, the logits' gather), the same on
    every rank. The prefill, verify and spec functions take it too."""
    positions = lengths[:, None]  # [b, 1]
    valid = None if limit is None else positions < limit[:, None]
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                     tokens.device)
    new_lengths = lengths + 1

    def attend(i, q, k, v):
        return _write_and_attend(
            q, k, v, cos, sin, kv_k[i], kv_v[i],
            None if k_scale is None else k_scale[i],
            None if v_scale is None else v_scale[i], tables, positions,
            new_lengths, valid, decode=True)

    x = _decoder(cfg, params, embed(cfg, params, tokens[:, None], tp),
                 attend, tp=tp)
    return _logits(x[:, 0], params["lm_head"], tp)


def _device_scalar(v, device: torch.device) -> torch.Tensor:
    """An int or a one-element tensor as a [1] int32 tensor on ``device``
    (a tensor already there is not copied)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(v)], dtype=torch.int32, device=device)


def prefill_chunk_paged(cfg: LlamaConfig, params: Params,
                        tokens: torch.Tensor, kv_k: torch.Tensor,
                        kv_v: torch.Tensor, tables: torch.Tensor,
                        offset, logit_idx, n_valid=None,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None,
                        logits: bool = True,
                        tp=None) -> torch.Tensor | None:
    """One chunked-prefill window over block tables, the pools written in
    place (int8 pools with ``k_scale``/``v_scale``, as in
    ``decode_step_paged``).

    tokens: [b, c] at absolute positions [offset, offset + c). ``offset``,
    ``logit_idx`` and ``n_valid`` are int32 device scalars (one-element
    tensors; Python ints are taken too and give the same numbers): the
    JAX package's traced scalars, and what lets one captured CUDA graph per
    (c, table width) serve every window, since nothing here is read back to
    the host. ``n_valid`` (default c) counts the real tokens of the chunk:
    padded tail rows scatter to the null block instead of clamping into the
    sequence's last backed block (see ``scatter_slots``; they are causally
    invisible to the valid rows regardless). Attention is causal from
    ``offset`` over the w * bs window the tables reach. Returns the logits
    [b, vocab] f32 at row ``logit_idx``: the caller passes the last valid
    row for the chunk that completes the prompt. An index outside the chunk
    is clamped into it (the JAX package's ``take`` returns NaN rows there
    instead; no caller passes one). ``logits=False`` writes the pools only
    and returns None (the speculative draft's replay of a chunk, whose
    logits nobody reads)."""
    b, c = tokens.shape
    dev = tokens.device
    offset = _device_scalar(offset, dev)
    logit_idx = _device_scalar(logit_idx, dev)
    n_valid = _device_scalar(c if n_valid is None else n_valid, dev)
    steps = torch.arange(c, dtype=torch.int32, device=dev)
    positions = (offset + steps)[None, :].expand(b, c)
    valid = (steps < n_valid)[None, :].expand(b, c)
    offsets = offset.expand(b)
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)

    def attend(i, q, k, v):
        return _write_and_attend(
            q, k, v, cos, sin, kv_k[i], kv_v[i],
            None if k_scale is None else k_scale[i],
            None if v_scale is None else v_scale[i], tables, positions,
            offsets, valid, decode=False)

    x = _decoder(cfg, params, embed(cfg, params, tokens, tp), attend, tp=tp)
    if not logits:
        return None
    row = x.index_select(1, logit_idx.clamp(0, c - 1))[:, 0]  # [b, d]
    return _logits(row, params["lm_head"], tp)


# ---- speculative decoding --------------------------------------------
# Verifying k drafted tokens is a (k + 1)-wide chunk with logits at every
# row and a per-sequence causal offset (each sequence sits at its own
# length). Row i's logits depend only on cache rows < lengths + i and chunk
# rows <= i, which hold what sequential greedy decoding would have written,
# so the argmax of each row is the token sequential greedy emits there:
# acceptance is exact, not approximate. That rests on each row's numbers
# not depending on the rest of the batch: the projections' rows on M (the
# GEMM kernel's, int8 and dense bf16 weights alike, for M <= 256 and in
# slabs of 256 rows above, ops/w8a16.py ``partition`` and ``slabs``),
# attention's rows on decode vs chunk (csrc/paged_attn.cu's header),
# rms_norm's and add_rms_norm's on the row count (ops/norms.py) and the KV
# write's codes and scales on the row alone (ops/kvquant.py).


def verify_chunk_paged(cfg: LlamaConfig, params: Params,
                       tokens: torch.Tensor, kv_k: torch.Tensor,
                       kv_v: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor,
                       limit: torch.Tensor | None = None,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       logits: bool = True,
                       tp=None) -> torch.Tensor | None:
    """The target's verification chunk. tokens: [b, c] int32, row 0 the
    last committed token and rows 1..c-1 the draft; row i writes its K/V at
    position lengths[b] + i (into the pools, in place; int8 pools with
    ``k_scale``/``v_scale``) and its logits predict position lengths[b] +
    i + 1. ``limit`` [b] caps the writes per sequence (the least of max_len
    and the table's backed capacity): rows at positions >= limit write into
    the null block. Returns the f32 logits [b, c, vocab], or None with
    ``logits=False`` (the tiny draft's replay of the chunk).

    Nothing is read back to the host: the offsets and the valid mask are
    device tensors, so the engine captures this inside its spec step."""
    c = tokens.shape[1]
    dev = tokens.device
    positions = lengths[:, None] + torch.arange(c, dtype=torch.int32,
                                                device=dev)[None, :]
    valid = None if limit is None else positions < limit[:, None]
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)

    def attend(i, q, k, v):
        return _write_and_attend(
            q, k, v, cos, sin, kv_k[i], kv_v[i],
            None if k_scale is None else k_scale[i],
            None if v_scale is None else v_scale[i], tables, positions,
            lengths, valid, decode=False)

    x = _decoder(cfg, params, embed(cfg, params, tokens, tp), attend, tp=tp)
    if not logits:
        return None
    return _logits(x, params["lm_head"], tp)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row: the first index of the largest logit,
    int32 (the engine's ``sample_tokens`` at temperature 0)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def spec_step_paged(cfg: LlamaConfig, dcfg: LlamaConfig, params: Params,
                    dparams: Params, tokens: torch.Tensor,
                    kv_k: torch.Tensor, kv_v: torch.Tensor,
                    draft_k: torch.Tensor | None,
                    draft_v: torch.Tensor | None, tables: torch.Tensor,
                    lengths: torch.Tensor, limit: torch.Tensor, spec_k: int,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    self_draft: bool = False, tp=None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One speculative decode step: draft ``spec_k`` tokens greedily with
    the draft model (its own pool ``draft_k``/``draft_v``, addressed by the
    same block tables), verify them and the input token in one
    (spec_k + 1)-wide target chunk, and accept the longest agreeing prefix
    plus one bonus token, the target's argmax after it. That is exactly
    what sequential greedy decoding emits; rejected rows sit above the new
    length, causally invisible, and the next step overwrites them.

    ``limit`` [b] is each sequence's write cap; acceptance is clamped so
    that the new length stays <= limit and every committed token's K/V row
    is real. A padded row carries limit 0: its writes land in the null
    block and its length stays.

    ``self_draft``: the drafter is the target (dcfg/dparams are cfg/params)
    and drafts straight over the target's pools (int8 ones too, with their
    scales): its writes at lengths..lengths + k - 1 are what the verify
    chunk writes there again, bit for bit, so no draft pool exists
    (``draft_k``/``draft_v`` are None) and no draft replay runs. Otherwise
    the draft replays the whole chunk into its pool afterwards (its own
    steps wrote only their inputs' rows, so the last draft's row would stay
    a hole), with no head.

    Writes the pools in place and returns (out_tokens [b, spec_k + 1]
    int32: the committed tokens, then -1; next_tokens [b]; new_lengths
    [b]). Nothing is read back to the host. Under a tp group (``tp``) the
    draft runs sharded like the target: its params are the rank's slices
    and its pool holds the rank's heads."""
    scales = dict(k_scale=k_scale, v_scale=v_scale) if self_draft else {}
    pool_k, pool_v = (kv_k, kv_v) if self_draft else (draft_k, draft_v)
    tokens = tokens.to(torch.int32)
    tok, ln, drafts = tokens, lengths, []
    for _ in range(spec_k):
        tok = greedy_tokens(decode_step_paged(
            dcfg, dparams, tok, pool_k, pool_v, tables, ln, limit=limit,
            tp=tp, **scales))
        drafts.append(tok)
        ln = ln + 1
    drafts = torch.stack(drafts, dim=1)                      # [b, k]
    chunk = torch.cat([tokens[:, None], drafts], dim=1)      # [b, k + 1]
    if not self_draft:
        verify_chunk_paged(dcfg, dparams, chunk, draft_k, draft_v, tables,
                           lengths, limit=limit, logits=False, tp=tp)
    tgt = greedy_tokens(verify_chunk_paged(
        cfg, params, chunk, kv_k, kv_v, tables, lengths, limit=limit,
        k_scale=k_scale, v_scale=v_scale, tp=tp))            # [b, k + 1]
    agree = (drafts == tgt[:, :-1]).to(torch.int32)
    m = torch.cumprod(agree, dim=1).sum(dim=1, dtype=torch.int32)
    # Committed token i's K/V lives at lengths + i, which must be < limit;
    # the bonus needs no row yet (it is the next step's input). A full or
    # padded row (limit <= lengths) commits nothing.
    m = torch.minimum(m, (limit - lengths - 1).clamp_min(0))
    bonus = torch.take_along_dim(tgt, m[:, None].to(torch.long), dim=1)
    idx = torch.arange(spec_k + 1, dtype=torch.int32,
                       device=tokens.device)[None, :]
    drafts_p = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    out = torch.where(idx == m[:, None], bonus, drafts_p)
    out = torch.where(idx <= m[:, None], out, torch.full_like(out, -1))
    new_lengths = torch.minimum(lengths + m + 1,
                                torch.maximum(limit, lengths))
    return out, bonus[:, 0], new_lengths


# ---- training --------------------------------------------------------
# The JAX package's ``forward`` / ``loss_fn`` (grove_tpu/models/llama.py:
# 216-279, :951-964): its prefill layer with the XLA attention, which runs
# no Pallas kernel and which autodiff differentiates. The port's hand-written
# kernels have no backward, so nothing here reaches one: the projections
# are ``torch.einsum``, the norms ``rms_norm_ref`` (JAX's ``rms_norm`` is an
# XLA composition) and attention the plain ``causal_attention``, or ring or
# Ulysses attention over the sp axis. The layers are a Python loop over
# ``layer_params``, so each layer's gradient lands in the stacked [L, ...]
# leaf, as ``lax.scan``'s does.
#
# Under a mesh (``mesh=``) each rank runs its block of the global function
# that JAX's GSPMD partitions: the batch rows of its dp coordinate, the
# positions of its sp coordinate (when an sp strategy cuts the sequence),
# and its tp slices of the heads, the ff width and the vocab. The
# collectives are written out where GSPMD and JAX's psums put them, as
# autograd Functions (parallel/mesh.py's ``AxisComm``): the Megatron pair
# around each head- and ff-sharded product, the vocab-sharded embedding's
# sum, a vocab-parallel cross-entropy, and the sums over the ranks that saw
# other tokens.

SP_STRATEGIES = ("ring", "ulysses")


def _w(w) -> torch.Tensor:
    """A weight for a plain product (an int8 leaf materialized)."""
    return w.materialize() if isinstance(w, QTensor) else w


def _einsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """``einsum(eq, x, w)`` at JAX's promoted type of x and w."""
    w = _w(w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(dt), w.to(dt))


def qkv(cfg: LlamaConfig, x: torch.Tensor, lp: Params, cos: torch.Tensor,
        sin: torch.Tensor, positions: torch.Tensor, tp=None):
    """Pre-norm, the QKV projections and rope (JAX's ``_qkv``). Under a tp
    group (``tp``, an ``AxisComm``) the weights hold the rank's heads and
    the normed rows enter them through ``copy_to``."""
    h = rms_norm_ref(x, lp["attn_norm"], cfg.norm_eps)
    if tp is not None:
        h = tp.copy_to(h)
    q, k, v = (_einsum("bsd,dhk->bshk", h, lp[n]) for n in ("wq", "wk", "wv"))
    return (apply_rope(q, cos, sin, positions),
            apply_rope(k, cos, sin, positions), v)


def attn_out(x: torch.Tensor, attn: torch.Tensor, lp: Params,
             tp=None) -> torch.Tensor:
    """The attention output's projection, added to the residual. Under a tp
    group the rank's heads give a partial sum, summed by ``reduce_from``
    (JAX's psum in ``_attn_out``)."""
    out = _einsum("bshk,hkd->bsd", attn, lp["wo"])
    if tp is not None:
        out = tp.reduce_from(out)
    return x + out.to(x.dtype)


def mlp_block(cfg: LlamaConfig, x: torch.Tensor, lp: Params,
              tp=None) -> torch.Tensor:
    """Pre-norm SwiGLU MLP, added to the residual; under a tp group over the
    rank's slice of the ff width (JAX's psum in ``_mlp_block``)."""
    hm = rms_norm_ref(x, lp["mlp_norm"], cfg.norm_eps)
    if tp is not None:
        hm = tp.copy_to(hm)
    gate = _einsum("bsd,df->bsf", hm, lp["w_gate"])
    up = _einsum("bsd,df->bsf", hm, lp["w_up"])
    out = _einsum("bsf,fd->bsd", F.silu(gate) * up, lp["w_down"])
    if tp is not None:
        out = tp.reduce_from(out)
    return x + out.to(x.dtype)


def head(cfg: LlamaConfig, params: Params, x: torch.Tensor,
         tp=None) -> torch.Tensor:
    """Final norm and the LM head, an f32 result from the working-type
    values upcast (JAX's ``preferred_element_type=f32``). Under a tp group
    the head is the rank's vocab slice and so are the logits."""
    x = rms_norm_ref(x, params["final_norm"], cfg.norm_eps)
    if tp is not None:
        x = tp.copy_to(x)
    return torch.einsum("bsd,dv->bsv", x.to(torch.float32),
                        _w(params["lm_head"]).to(torch.float32))


def embed_train(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                tp=None) -> torch.Tensor:
    """``embed`` for training: under a tp group the rank's rows are summed
    by ``reduce_from``, so each rank's slice of the table gets its
    gradient."""
    x = _embed_rows(cfg, params, tokens, tp)
    return x if tp is None else tp.reduce_from(x)


def decoder_layers(cfg: LlamaConfig, layers: Params, x: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor,
                   positions: torch.Tensor, attn=causal_attention,
                   tp=None) -> torch.Tensor:
    """The stacked ``layers`` (all L of them, or a pipeline stage's) over
    the embedded rows ``x``; ``attn(q, k, v)`` is the attention."""
    for i in range(layers["attn_norm"].shape[0]):
        lp = layer_params(layers, i)
        q, k, v = qkv(cfg, x, lp, cos, sin, positions, tp)
        x = attn_out(x, attn(q, k, v), lp, tp)
        x = mlp_block(cfg, x, lp, tp)
    return x


def sp_strategy(mesh, ring: bool, sp: str | None,
                positions: torch.Tensor | None) -> str | None:
    """JAX's argument rules for sequence parallelism, with its exception
    types: ``ring=True`` is the old spelling of ``sp="ring"`` and conflicts
    with another strategy; ``sp`` needs the mesh; both strategies derive
    causality from shard offsets, so custom positions are refused; an
    unknown strategy is a ``ValueError``."""
    if ring:
        if sp not in (None, "ring"):
            raise AssertionError(f"ring=True conflicts with sp={sp!r}")
        sp = "ring"
    if sp is not None:
        if mesh is None:
            raise AssertionError("sequence parallelism needs the mesh")
        if positions is not None:
            raise AssertionError(
                "sequence parallelism does not support custom positions")
        if sp not in SP_STRATEGIES:
            raise ValueError(f"unknown sp strategy {sp!r} "
                             "(expected 'ring' or 'ulysses')")
    return sp


def _sp_attention(mesh, sp: str | None):
    if sp == "ring":
        from grove_tpu_torch.ops.ringattention import ring_attention
        return lambda q, k, v: ring_attention(mesh, q, k, v)
    if sp == "ulysses":
        from grove_tpu_torch.ops.ulysses import ulysses_attention
        return lambda q, k, v: ulysses_attention(mesh, q, k, v)
    return causal_attention


def sum_leaf_grads(params: Params, comms, skip=(), only=None) -> Params:
    """``params`` with each leaf that requires grad (those named in
    ``only`` where given, but not those in ``skip``) summed over ``comms``
    in the backward (``parallel/mesh.py``'s ``sum_grads``): the ranks of
    those axes hold the same leaf and saw other tokens."""
    from grove_tpu_torch.parallel.mesh import sum_grads
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    nodes = [out, *(v for v in out.values() if isinstance(v, dict))]
    slots = [(node, name) for node in nodes for name, leaf in node.items()
             if isinstance(leaf, torch.Tensor) and leaf.requires_grad
             and name not in skip and (only is None or name in only)]
    views = sum_grads([node[name] for node, name in slots], comms)
    for (node, name), view in zip(slots, views):
        node[name] = view
    return out


def _mesh_block(mesh, tokens: torch.Tensor, cut_seq: bool):
    """This rank's block of the global batch: (first row, rows, first
    position, positions). Rows follow the dp coordinate; positions the sp
    coordinate when ``cut_seq``, else the whole sequence."""
    from grove_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP
    B, S = tokens.shape
    n_dp = mesh.shape[AXIS_DP]
    n_sp = mesh.shape[AXIS_SP] if cut_seq else 1
    if B % n_dp:
        raise ValueError(f"dp={n_dp} must divide the batch {B}")
    if S % n_sp:
        raise ValueError(f"sp={n_sp} must divide the sequence {S}")
    b, s = B // n_dp, S // n_sp
    c0 = mesh.coord(AXIS_SP) * s if cut_seq else 0
    return mesh.coord(AXIS_DP) * b, b, c0, s


def _check_slices(cfg: LlamaConfig, params: Params, mesh) -> None:
    """Refuse full-width params under tp > 1: summing every rank's full
    product would give tp times the result without an error."""
    from grove_tpu_torch.parallel.mesh import AXIS_TP
    t = mesh.shape[AXIS_TP]
    got = (params["layers"]["wq"].shape[2], params["tok_embed"].shape[0])
    want = (cfg.n_heads // t, cfg.vocab_size // t)
    if got != want:
        raise ValueError(
            f"under tp={t} the params are this rank's slices "
            f"(parallel/sharding.py shard_params): wq heads and tok_embed "
            f"rows {got}, want {want}")


def _mesh_forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor | None, mesh, sp: str | None):
    """This rank's block of logits and (block, token axes, tp group)."""
    from grove_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP
    _check_slices(cfg, params, mesh)
    block = r0, b, c0, s = _mesh_block(mesh, tokens, sp is not None)
    tp = mesh.comm(AXIS_TP)
    token_axes = [mesh.comm(AXIS_DP)]
    if sp is not None:
        token_axes.append(mesh.comm(AXIS_SP))
    params = sum_leaf_grads(params, token_axes)
    dev = tokens.device
    toks = tokens[r0:r0 + b, c0:c0 + s]
    if positions is None:
        positions = torch.arange(c0, c0 + s, device=dev).expand(b, s)
    else:
        positions = positions[r0:r0 + b]
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    x = embed_train(cfg, params, toks, tp)
    x = decoder_layers(cfg, params["layers"], x, cos, sin, positions,
                       _sp_attention(mesh, sp), tp)
    return head(cfg, params, x, tp), block, token_axes, tp


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            positions: torch.Tensor | None = None, mesh=None,
            ring: bool = False, sp: str | None = None) -> torch.Tensor:
    """Full forward: logits [b, s, vocab] f32, differentiable (the training
    path). ``positions`` [b, s] defaults to 0..s-1 in every row.

    ``mesh`` (parallel/mesh.py's ``Mesh``) runs this rank's block of the
    sharded forward: ``params`` are the rank's slices
    (``parallel/sharding.py``'s ``shard_params``), ``tokens`` the global
    batch, the same on every rank. The result is the rank's block of the
    global logits, [B / dp, S / sp, vocab / tp]: the batch rows of its dp
    coordinate, the positions of its sp coordinate (the whole sequence
    without an sp strategy: the sp ranks then compute the same block) and
    the vocab slice of its tp coordinate. ``sp`` selects the sequence
    parallelism over the sp axis: ``"ring"`` (K/V blocks rotate, O(s / sp)
    memory, any head count) or ``"ulysses"`` (two all-to-all exchanges,
    heads must divide over sp); ``ring=True`` is the old spelling of
    ``sp="ring"``. Other axes (pp, ep) replicate the computation, as in
    JAX."""
    sp = sp_strategy(mesh, ring, sp, positions)
    if mesh is not None:
        return _mesh_forward(cfg, params, tokens, positions, mesh, sp)[0]
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    cos, sin = _rope(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    x = decoder_layers(cfg, params["layers"], embed(cfg, params, tokens),
                       cos, sin, positions)
    return head(cfg, params, x)


def nll_sum(logits: torch.Tensor, targets: torch.Tensor,
            valid: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """The sum over positions (those ``valid`` marks, all by default) of
    -log softmax(logits)[target], in f32. Under a tp group ``logits`` are
    the rank's vocab slice (rank r holds ids [r V/tp, (r + 1) V/tp)): the
    max, the exp-sum and the target's logit are summed over the group, so
    every rank gets the same value and its slice's gradient, and the full
    logits are never gathered. The max is detached, as JAX's
    ``log_softmax`` takes it."""
    from torch.distributed import ReduceOp
    logits = logits.to(torch.float32)
    top = logits.amax(dim=-1, keepdim=True).detach()
    if tp is not None:
        top = tp.all_reduce(top, op=ReduceOp.MAX)
    shifted = logits - top
    sumexp = torch.exp(shifted).sum(dim=-1)
    rows = logits.shape[-1]
    local = targets.to(torch.long) - (tp.rank * rows if tp is not None
                                      else 0)
    hit = (local >= 0) & (local < rows)
    picked = torch.take_along_dim(
        shifted, torch.where(hit, local, 0)[..., None], dim=-1)[..., 0]
    picked = torch.where(hit, picked, 0.0)
    if tp is not None:
        sumexp, picked = tp.reduce_from(sumexp), tp.reduce_from(picked)
    nll = torch.log(sumexp) - picked
    if valid is not None:
        nll = torch.where(valid, nll, 0.0)
    return nll.sum()


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32 (every model family's): the
    log-softmax of each position's logits, gathered at the next token.
    Under a tp group ``logits`` are the rank's vocab slice (``nll_sum``)."""
    targets = tokens[:, 1:].to(torch.long)
    return nll_sum(logits[:, :-1], targets, tp=tp) / targets.numel()


def block_targets(tokens: torch.Tensor, block) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The next-token targets of a rank's block (first row, rows, first
    position, positions) of the global ``tokens`` and which positions have
    one: a block's last position predicts the next block's first token,
    and only the sequence's last position has no target."""
    r0, b, c0, s = block
    S = tokens.shape[1]
    nxt = tokens[r0:r0 + b, c0 + 1:c0 + s + 1].to(torch.long)
    if nxt.shape[1] < s:
        nxt = torch.cat([nxt, torch.zeros_like(nxt[:, :1])], dim=1)
    valid = torch.arange(c0, c0 + s, device=tokens.device) < S - 1
    return nxt, valid


def loss_fn(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            mesh=None, ring: bool = False,
            sp: str | None = None) -> torch.Tensor:
    """Next-token cross-entropy of ``forward`` (the training loss). Under a
    mesh it is the global loss, the same value on every rank: each rank's
    block sums its positions' losses over the vocab-sharded logits, the
    blocks are summed over the ranks that saw other tokens (dp, and sp when
    an sp strategy cuts the sequence) and divided by B (S - 1). After
    ``backward()`` each leaf's ``.grad`` is the rank's slice of the global
    gradient."""
    sp = sp_strategy(mesh, ring, sp, None)
    if mesh is None:
        return next_token_loss(forward(cfg, params, tokens), tokens)
    logits, block, token_axes, tp = _mesh_forward(cfg, params, tokens, None,
                                                  mesh, sp)
    targets, valid = block_targets(tokens, block)
    B, S = tokens.shape
    loss = nll_sum(logits, targets, valid, tp) / (B * (S - 1))
    for comm in token_axes:
        if comm is not None:
            loss = comm.reduce_from(loss)
    return loss
