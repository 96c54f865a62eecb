"""The output check fails a run whose timed path is broken underneath: the
harness runs as it does on the card, past its look for one, with one fault
planted in the program's decode path each time."""

import pytest

import grove_tpu_torch.models.llama as llama
import grove_tpu_torch.serving.engine as engine_mod
from benchmark import harness
from grove_tpu_torch.ops.rope import apply_rope

SAMPLE = engine_mod.sample_tokens
DECODE = llama.decode_step_paged
SCATTER = llama.paged_rope_scatter


def altered_token(logits, gen, cfg):
    """Every token altered where it is produced: the next id."""
    return (SAMPLE(logits, gen, cfg) + 1) % logits.shape[-1]


def half_batch(*args, **kw):
    """The decode step computes the first half of its rows only."""
    out = DECODE(*args, **kw)
    out[out.shape[0] // 2:] = 0
    return out


def state_unchanged(kc, vc, q, k, v, cos, sin, tables, positions,
                    valid=None):
    """A decode step leaves the cache as it was: the new token's K and V
    are never written."""
    if q.shape[1] == 1:
        return apply_rope(q, cos, sin, positions)
    return SCATTER(kc, vc, q, k, v, cos, sin, tables, positions, valid)


FAULTS = {"altered_token": (engine_mod, "sample_tokens", altered_token),
          "half_batch": (llama, "decode_step_paged", half_batch),
          "state_unchanged": (llama, "paged_rope_scatter", state_unchanged)}


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.sessions"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_comes_out_not_correct(tiny_root, monkeypatch,
                                               cell, fault):
    mod, name, fn = FAULTS[fault]
    monkeypatch.setattr(mod, name, fn)
    res = harness.run(tiny_root, cell, 3, 1.0, False, device="cpu")
    check = res["checks"]["mean_gap"]
    assert res["correct"] is False, check
    assert check["value"] > check["limit"]
