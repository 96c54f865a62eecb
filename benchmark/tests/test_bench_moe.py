"""The MoE cell's runner (``runners/moe.py``) end to end at a test size on
the CPU, through the kernels' plain versions, against the plain reference
(``reference/mixtral.py``); faults planted in the expert layer that the
output check must catch; and the absence of JAX from what it loads."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny-moe.chat"


@pytest.fixture
def moe_root(tiny_root):
    """The tiny root plus a Mixtral-shaped tiny configuration (4 experts,
    top-2) and a chat cell on it that names the MoE runner."""
    import tiny
    b = tiny_root / "benchmark"
    conf = dict(tiny.CONFIG, name="tiny-moe", model_type="mixtral",
                intermediate_size=96, num_local_experts=4,
                num_experts_per_tok=2)
    (b / "configs" / "tiny-moe.json").write_text(json.dumps(conf))
    cell = dict(tiny.CELLS["tiny.chat"], config="tiny-moe", runner="moe")
    (b / "cells" / f"{CELL}.json").write_text(json.dumps(cell))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "benchmark/configs/tiny-moe.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-moe",
                               "traffic": "tiny-chat", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.chat" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def run(root, seed=2 ** 33 + 7, seconds=1.0, trace=0, control=0):
    runner = harness.load_module(root / "benchmark" / "runners" / "moe.py")
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=seconds,
                                 trace=trace, control=control)
    return runner.run(root, args, device="cpu")


def test_the_moe_cell_runs_and_is_correct(moe_root):
    res = run(moe_root)
    bench = json.loads((moe_root / "BENCHMARK.json").read_text())
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {
        m["name"] for m in harness.metrics_for(bench, CELL, False)}
    assert list(res)[-1] == "checks"
    assert res["checks"]["mean_gap"]["value"] <= \
        res["checks"]["mean_gap"]["limit"]


def test_a_traced_moe_run_reads_the_programs_spans(moe_root, monkeypatch):
    runner = harness.load_module(moe_root / "benchmark" / "runners" /
                                 "moe.py")
    build = runner.build

    def build_sampling_all(*a, **k):
        cfg, params, engine = build(*a, **k)
        engine.xprof.recorder.sample_every = 1
        return cfg, params, engine
    monkeypatch.setattr(runner, "build", build_sampling_all)
    res = run(moe_root, seed=11, seconds=2.0, trace=1)
    got = set(res["metrics"])
    assert {"admit_wait_p95_ms", "decode_step_ms", "prefill_chunk_ms"} <= got
    # No device trace on the CPU: the kernels' and the device's metrics are
    # silent.
    assert not got & {"expert_gemm_roofline", "moe_step_mfu",
                      "expert_layer_share", "paged_attn_roofline"}
    assert res["correct"] is True


def second_expert_dropped(y, slot, w, k):
    """Each token keeps its first expert's output only."""
    from grove_tpu_torch.ops import moe
    w = w.view(-1, k).clone()
    w[:, 1:] = 0.0
    return moe.moe_combine_ref(y, slot, w.reshape(-1), k)


def softmax_over_all(logits, k):
    """The weights of a softmax over all experts, not renormalised over the
    k chosen."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.topk(logits.to(torch.float32), k, dim=-1)
    return idx, p.gather(1, idx)


FAULTS = {"second_expert_dropped": ("moe_combine", second_expert_dropped),
          "softmax_over_all": ("route_ref", softmax_over_all)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_expert_fault_comes_out_not_correct(moe_root, monkeypatch,
                                                      fault):
    from grove_tpu_torch.ops import moe
    name, fn = FAULTS[fault]
    monkeypatch.setattr(moe, name, fn)
    res = run(moe_root, seed=3)
    check = res["checks"]["mean_gap"]
    assert res["correct"] is False, check
    assert check["value"] > check["limit"]


def test_the_control_serves_rounded_experts(moe_root, monkeypatch):
    """``--control 1`` rounds the experts through int8 in place, and its
    reference reads weights made anew: the reference's weights are not the
    served ones."""
    runner = harness.load_module(moe_root / "benchmark" / "runners" /
                                 "moe.py")
    made, compared = [], []
    make = runner.weights_moe.make
    compare = runner.ref_mixtral.compare

    def making(*a, **k):
        made.append(make(*a, **k))
        return made[-1]

    def comparing(cfg, params, *a, **k):
        compared.append(params)
        return compare(cfg, params, *a, **k)
    monkeypatch.setattr(runner.weights_moe, "make", making)
    monkeypatch.setattr(runner.ref_mixtral, "compare", comparing)
    res = run(moe_root, control=1)
    assert len(made) == 2 and compared[0] is made[1]
    served = made[0]["layers"]["we_gate"]
    fresh = made[1]["layers"]["we_gate"]
    assert not torch.equal(served, fresh)
    assert res["checks"]["mean_gap"]["value"] is not None


def test_the_runner_loads_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from benchmark import harness
base = Path({str(REPO)!r}) / "benchmark"
harness.load_module(base / "runners" / "moe.py")
import benchmark.weights_moe
from benchmark.reference import mixtral
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    got = {m.split(".")[0] for m in
           json.loads(out.stdout.strip().splitlines()[-1])}
    assert not got & {"jax", "jaxlib", "flax", "grove_tpu"}


def test_the_moe_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from benchmark.reference import mixtral
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    got = {m.split(".")[0] for m in
           json.loads(out.stdout.strip().splitlines()[-1])}
    assert not got & {"grove_tpu_torch", "grove_tpu", "jax", "jaxlib",
                      "flax"}
