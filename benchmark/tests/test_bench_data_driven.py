"""A configuration, a traffic mix, a cell and a per-layer metric arrive as
new files and one entry each in BENCHMARK.json; the harness runs them
without an edit to any file it had."""

import hashlib
import json

from benchmark import harness


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_new_files_make_a_new_cell(tiny_root):
    before = digest(tiny_root)
    b = tiny_root / "benchmark"
    conf = json.loads((b / "configs" / "tiny.json").read_text())
    conf.update(name="tiny-wide", hidden_size=128, num_attention_heads=8,
                num_key_value_heads=2, head_dim=16, intermediate_size=256)
    (b / "configs" / "tiny-wide.json").write_text(json.dumps(conf))
    (b / "traffic" / "fixed-burst.json").write_text(json.dumps({
        "kind": "open_loop", "rate_per_s": 30.0, "after_window_s": 30,
        "schedule_seed": 2,
        "prompt_tokens": {"dist": "fixed", "value": 24},
        "output_tokens": {"dist": "fixed", "value": 6}}))
    cell = json.loads((b / "cells" / "tiny.chat.json").read_text())
    cell.update(config="tiny-wide", traffic="fixed-burst")
    (b / "cells" / "tiny-wide.fixed-burst.json").write_text(json.dumps(cell))
    (b / "metrics" / "served_prompt_tokens.py").write_text(
        "def read(r):\n"
        "    return float(sum(t.prompt_len for t in r.window_tracks()"
        " if t.done))\n")
    (b / "metrics" / "admitted_in_window.py").write_text(
        "def read(r):\n"
        "    return float(r.counters1['schedule']['admitted_total']"
        " - r.counters0['schedule']['admitted_total'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide", "source": "test",
                             "file": "benchmark/configs/tiny-wide.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny-wide.fixed-burst",
                               "config": "tiny-wide",
                               "traffic": "fixed-burst", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "served_prompt_tokens",
                               "unit": "tokens", "better": "higher",
                               "source": "program_counter",
                               "layer": "Engine scheduler",
                               "moves": "output_tokens_per_s",
                               "workloads": ["tiny-wide.fixed-burst"]})
    bench["per_layer"].append({"name": "admitted_in_window",
                               "unit": "requests", "better": "higher",
                               "source": "program_counter",
                               "layer": "Engine scheduler",
                               "moves": "output_tokens_per_s",
                               "workloads": ["tiny-wide.fixed-burst"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tiny_root)
    assert all(after[p] == h for p, h in before.items())

    res = harness.run(tiny_root, "tiny-wide.fixed-burst", 8, 1.0, False,
                      device="cpu")
    assert res["correct"] is True
    assert {"tpot_p95_ms", "output_tokens_per_s", "setup_s"} <= \
        set(res["metrics"])
    traced = harness.run(tiny_root, "tiny-wide.fixed-burst", 8, 1.0, True,
                         device="cpu")
    served = traced["metrics"]["served_prompt_tokens"]
    assert served["unit"] == "tokens"
    assert served["value"] == 24 * traced["attempted"]
    admitted = traced["metrics"]["admitted_in_window"]["value"]
    assert 1 <= admitted <= traced["attempted"]


def test_a_cell_may_bring_its_own_runner(tiny_root, monkeypatch, capsys):
    import torch

    from benchmark import run
    b = tiny_root / "benchmark"
    (b / "runners").mkdir()
    (b / "runners" / "fake.py").write_text(
        "def run(root, args, process_start):\n"
        "    return {'correct': True, 'attempted': 1, 'failed': 0,\n"
        "            'metrics': {}, 'device': {'seed': args.seed},\n"
        "            'checks': {}}\n")
    cell = json.loads((b / "cells" / "tiny.chat.json").read_text())
    (b / "cells" / "tiny.chat.json").write_text(
        json.dumps(dict(cell, runner="fake")))
    monkeypatch.setattr(run, "ROOT", tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    assert run.main(["--workload", "tiny.chat", "--seed", "5",
                     "--seconds", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == {"seed": 5}
