"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level part, whole: ``grove_tpu_torch`` is the port, not the JAX
package ``grove_tpu``."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

IMPORT_ALL = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
import benchmark.run, benchmark.harness, benchmark.sweep
from benchmark.reference import check, llama
from benchmark.harness import load_module
base = Path({str(REPO)!r}) / "benchmark"
for d in ("drivers", "metrics", "roofline"):
    for p in sorted((base / d).glob("*.py")):
        load_module(p)
print(json.dumps(sorted(sys.modules)))
"""

IMPORT_REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from benchmark.reference import check, llama
print(json.dumps(sorted(sys.modules)))
"""


def modules(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def tops(mods):
    return {m.split(".")[0] for m in mods}


def test_the_harness_loads_no_jax():
    got = tops(modules(IMPORT_ALL))
    assert "grove_tpu_torch" in got
    assert not got & {"jax", "jaxlib", "flax", "grove_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    got = tops(modules(IMPORT_REFERENCE))
    assert not got & {"grove_tpu_torch", "grove_tpu", "jax", "jaxlib",
                      "flax"}


def test_the_forbidden_check_compares_whole_top_level_names():
    from benchmark import harness
    sys.modules["grove_tpu_torch_probe"] = sys
    try:
        assert "grove_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["grove_tpu_torch_probe"]
