"""Arithmetic shared by the metric readers."""

from __future__ import annotations

import numpy as np


def p95(values) -> float | None:
    """The 95th percentile (linear between order statistics), or None
    for no values."""
    return float(np.percentile(values, 95)) if len(values) else None


def tpot_s(stamps: list, t0: float) -> float | None:
    """Seconds per output token after the first, as the host saw them:
    (last stamp - first stamp) over the tokens stamped after the first
    stamp, counting only stamps from ``t0`` on. None with no such token."""
    s = [x for x in stamps if x >= t0]
    if not s:
        return None
    later = sum(1 for x in s if x > s[0])
    return (s[-1] - s[0]) / later if later else None
