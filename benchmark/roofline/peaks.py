"""The table of peaks the roofline shares are taken against: NVIDIA's data
sheet for the H100 SXM part, dense rates without sparsity, at its full
700 W power limit (a card set below it runs slower under load: the run
prints the card's limit beside its numbers)."""

from __future__ import annotations

H100_SXM = {"bf16_flops": 989e12, "fp8_flops": 1979e12, "f32_flops": 67e12,
            "hbm_bytes_per_s": 3.35e12}


def for_device(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a device this table does not hold (the CPU): a share of a
    peak is then not reported."""
    return H100_SXM if "H100" in kind else None
