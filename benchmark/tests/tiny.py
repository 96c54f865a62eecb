"""A tiny benchmark root for the CPU tests: a copy of the benchmark's files
with a test-sized configuration, two mixes and two cells, and a
``BENCHMARK.json`` naming them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

CONFIG = {
    "name": "tiny", "source": "test", "model_type": "llama",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 4, "vocab_size": 256,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "head_dim": 8, "reduced": [], "assumed": [],
    "deployment": "the CPU tests"}
MIXES = {
    "tiny-chat": {"kind": "open_loop", "rate_per_s": 12.0,
                  "prompt_tokens": {"dist": "lognormal", "median": 20,
                                    "sigma": 0.6, "min": 8, "max": 48},
                  "output_tokens": {"dist": "lognormal", "median": 8,
                                    "sigma": 0.6, "min": 4, "max": 24},
                  "preroll_s": 0.5, "after_window_s": 30,
                  "schedule_seed": 4},
    "tiny-sessions": {"kind": "sessions", "sessions": 4,
                      "prompt_tokens": {"dist": "uniform", "min": 40,
                                        "max": 72}},
}
ENGINE = {"batch": 4, "max_len": 128, "num_blocks": 65, "block_size": 8,
          "prefill_chunk": 16, "quant": None, "kv_quant": "off"}
CELLS = {
    "tiny.chat": {"config": "tiny", "traffic": "tiny-chat",
                  "engine": ENGINE,
                  "check": {"requests": 6, "served_tokens": 200,
                            "mean_gap": 0.01}},
    "tiny.sessions": {"config": "tiny", "traffic": "tiny-sessions",
                      "engine": dict(ENGINE, max_len=256, num_blocks=129),
                      "check": {"requests": 4, "served_tokens": 10000,
                                "mean_gap": 0.01}},
}


def make_root(dst: Path) -> Path:
    """A root whose ``benchmark/`` is a copy of this one (tests excluded)
    plus the tiny files, and whose BENCHMARK.json names only them."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    b = dst / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    for name, mix in MIXES.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, cell in CELLS.items():
        (b / "cells" / f"{name}.json").write_text(json.dumps(cell))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [
        {"name": n, "config": "tiny", "traffic": c["traffic"], "chips": 1,
         "why": "tests"} for n, c in CELLS.items()]
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in cells
                              if m["name"] != "ttft_p95_ms"
                              and m.get("moves") != "ttft_p95_ms"
                              or c == "tiny.chat"]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
