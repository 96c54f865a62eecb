"""The harness end to end at a test size on the CPU, through the kernels'
plain versions, against the plain reference; and the command's refusal to
run without a card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]


def names(bench, cell, trace):
    return {m["name"] for m in harness.metrics_for(bench, cell, trace)}


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.sessions"])
def test_a_cell_runs_and_is_correct(tiny_root, cell):
    res = harness.run(tiny_root, cell, 2 ** 31 + 5, 1.0, False,
                      device="cpu")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == names(bench, cell, False)
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checks"]["mean_gap"]["value"] <= \
        res["checks"]["mean_gap"]["limit"]
    assert res["device"]["platform"] == "cpu"


def test_a_traced_run_reports_per_layer_metrics(tiny_root, monkeypatch):
    # The flight recorder samples every 16th dispatch; a CPU window holds
    # few, so here it samples every one and both phases are read.
    build = harness.build

    def build_sampling_all(*a, **k):
        cfg, params, engine = build(*a, **k)
        engine.xprof.recorder.sample_every = 1
        return cfg, params, engine
    monkeypatch.setattr(harness, "build", build_sampling_all)
    res = harness.run(tiny_root, "tiny.chat", 11, 2.0, True, device="cpu")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    got = set(res["metrics"])
    assert got <= names(bench, "tiny.chat", True)
    # The CPU has no device trace and no peak: what needs them is silent;
    # the program's own counters and spans are read.
    assert {"admit_wait_p95_ms", "decode_step_ms", "prefill_chunk_ms"} <= got
    assert not got & {"gemm_roofline", "paged_attn_roofline",
                      "device_idle_share", "step_mfu"}
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]


def test_the_profiler_stops_after_the_traffic_loop(tiny_root, monkeypatch):
    """The profiler's stop, which takes about a second on the card, comes
    after the loop has returned, so that it stalls no window request."""
    import torch
    seen = {"stops": []}
    load = harness.load_module

    def load_and_watch(path):
        mod = load(path)
        if path.parent.name == "drivers":
            drive = mod.drive

            def watched(*a, **k):
                win = drive(*a, **k)
                seen["end"] = win["end"]
                return win
            monkeypatch.setattr(mod, "drive", watched)
        return mod

    stop = torch.profiler.profile.stop

    def timed_stop(self):
        seen["stops"].append(time.time())
        return stop(self)
    monkeypatch.setattr(harness, "load_module", load_and_watch)
    monkeypatch.setattr(torch.profiler.profile, "stop", timed_stop)
    res = harness.run(tiny_root, "tiny.chat", 13, 2.0, True, device="cpu")
    assert res["device"]["window_s"] > 0
    # One stop primes the profiler in set-up; the slice's comes after.
    assert len(seen["stops"]) == 2
    assert seen["stops"][0] < seen["end"] <= seen["stops"][1]


@pytest.mark.parametrize("script", ["run.py", "sweep.py"])
def test_the_command_refuses_a_machine_without_a_card(script):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["--trace", "0"] if script == "run.py" else ["--rates", "5"]
    out = subprocess.run(
        [sys.executable, f"benchmark/{script}", "--workload",
         "yi-1.5-9b.chat", "--seed", "1", "--seconds", "1", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_file_names_what_exists():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = REPO / "benchmark"
    for w in bench["workloads"]:
        cell = json.loads((base / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        mix = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (base / "drivers" / f"{mix['kind']}.py").exists()
        # Every cell reports setup_s, another end-to-end metric and a
        # per-layer one.
        e2e = names(bench, w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert names(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (base / "metrics" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()
