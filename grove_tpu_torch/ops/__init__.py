from grove_tpu_torch.ops.attention import causal_attention, decode_attention
from grove_tpu_torch.ops.kvcache import KVCache
from grove_tpu_torch.ops.norms import rms_norm
from grove_tpu_torch.ops.rope import apply_rope, rope_table

__all__ = [
    "rms_norm",
    "apply_rope",
    "rope_table",
    "causal_attention",
    "decode_attention",
    "KVCache",
]
