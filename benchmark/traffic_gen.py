"""The one traffic generator every mix goes through: seeded arrivals and
bounded lengths, drawn from the parameters of a ``traffic/<mix>.json``.

The arithmetic is that of the repository's load generator (tools/loadgen.py,
``LoadProfile`` and ``ArrivalSchedule``): Poisson arrivals as exponential
gaps at the rate, lengths drawn from a distribution and clipped to bounds,
token ids uniform over the vocabulary, all from one ``numpy`` generator
seeded with the run's seed. One thing differs. A run measures a fixed window,
and a seed must not change how much work that window holds, or runs on two
seeds would differ by far more than two runs of one seed. So every draw is
stratified: ``n`` values sit at the quantiles ``(i + 0.5) / n`` of their
distribution, and the seed only shuffles their order. Every seed then offers
the same set of gaps, prompt lengths and output lengths, in another order,
with other token ids.

Length specs (``prompt_tokens``, ``output_tokens`` in a mix):

- ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
- ``{"dist": "uniform", "min": a, "max": b}``
- ``{"dist": "fixed", "value": v}``
"""

from __future__ import annotations

import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


def rng_for(seed: int) -> np.random.Generator:
    """The run's host generator (any whole number, negative ones too)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def quantiles(n: int) -> np.ndarray:
    """The midpoints of ``n`` equal strata of [0, 1]."""
    return (np.arange(n, dtype=np.float64) + 0.5) / max(n, 1)


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` stratified lengths of the spec, shuffled by ``rng``, int64."""
    u = quantiles(n)
    dist = spec["dist"]
    if dist == "lognormal":
        z = np.array([_NORMAL.inv_cdf(x) for x in u])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif dist == "uniform":
        vals = spec["min"] + u * (spec["max"] - spec["min"])
    elif dist == "fixed":
        vals = np.full(n, float(spec["value"]))
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    lo = spec.get("min", spec.get("value"))
    hi = spec.get("max", spec.get("value"))
    out = np.clip(np.rint(vals), lo, hi).astype(np.int64)
    rng.shuffle(out)
    return out


def poisson_offsets(rate: float, n: int, rng: np.random.Generator
                    ) -> np.ndarray:
    """Arrival offsets in seconds of ``n`` requests at ``rate`` per second:
    the first at 0, then ``n - 1`` stratified exponential gaps in the order
    ``rng`` shuffles them."""
    if n <= 0:
        return np.zeros(0)
    gaps = -np.log1p(-quantiles(n - 1)) / rate
    rng.shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)])


def token_ids(lens: np.ndarray, vocab: int, rng: np.random.Generator
              ) -> list[np.ndarray]:
    """One prompt of uniform token ids per length, int32."""
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]
