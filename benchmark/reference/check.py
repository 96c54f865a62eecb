"""The comparison that decides ``correct`` for a served model.

For each sampled request, the reference runs once over its prompt and the
tokens the program served, and reads at each served position the gap by
which the served token's logit lies below the reference's best logit there.
A greedy server that computes what the model states serves the reference's
best token, or one whose logit is within its rounding of the best.

The number compared with the cell's limit is the mean gap over every served
token of the sample. The widest gap is logged beside it but not compared: on
random weights the top two logits of a 32k-64k vocabulary often lie within
the bf16 program's rounding of each other, so the widest gap of sound runs
is a tail of that rounding, and the control (the program's int8 weights and
int8 KV) reads only 2-3 times it. The mean weighs how often a token is off
its best and by how much, and separates the two by far more; a token
altered where it is produced adds its whole gap (several logits) to it.
"""

from __future__ import annotations

import torch

from benchmark.reference import llama


def served_gaps(cfg: llama.Config, params: dict, prompt, served,
                device) -> torch.Tensor:
    """float32 gaps [len(served)] of one request: position j is
    ``max(ref) - ref[served[j]]`` at the position that produced it."""
    seq = torch.as_tensor(list(prompt) + list(served[:-1]),
                          dtype=torch.long, device=device)
    ref = llama.logits(cfg, params, seq, len(prompt) - 1)
    toks = torch.as_tensor(list(served), dtype=torch.long, device=device)
    best = ref.max(dim=-1).values
    return (best - ref.gather(1, toks[:, None])[:, 0]).cpu()


def compare(cfg: llama.Config, params: dict, sample, device) -> dict:
    """``sample``: (prompt, served) pairs. Returns the mean and the widest
    gap over every served token, the tokens compared and how many of them
    were not the reference's best."""
    total, widest, tokens, off_best = 0.0, 0.0, 0, 0
    for prompt, served in sample:
        g = served_gaps(cfg, params, prompt, served, device).double()
        total += float(g.sum())
        widest = max(widest, float(g.max()))
        tokens += len(served)
        off_best += int((g > 0).sum())
    return {"mean_gap": total / tokens, "widest_gap": widest,
            "tokens": tokens, "off_best": off_best}
