"""The port's twins of the data-plane gates import no JAX: each twin
(tools/*_torch.py) runs with ``--device cpu`` in one fresh interpreter,
after which neither ``jax`` nor a JAX-package compute module is in
``sys.modules``; and an AST scan holds every import a twin makes to the
control plane (``grove_tpu.api``, ``cluster``, ``server``, ``store``,
``runtime``, ``topology``, ``agent``, ``cli``), the registries it reads
(``grove_tpu.serving.xprof`` and ``.reqtrace``, entered by
``loadgen_torch.serving_registries`` without the package's ``__init__``),
the engine-agnostic JAX-side tools it reuses (tools/loadgen.py's arrival
model, tools/decode_smoke.py's pins) and the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TWINS = sorted((ROOT / "tools").glob("*_torch.py"))
CONTROL_PLANE = ("api", "cluster", "server", "store", "runtime", "topology",
                 "agent", "cli")
REGISTRIES = ("grove_tpu.serving.xprof", "grove_tpu.serving.reqtrace")
# What may never load: JAX, and the JAX package's compute modules.
NEVER = ("jax", "jaxlib", "grove_tpu.models", "grove_tpu.ops",
         "grove_tpu.parallel", "grove_tpu.serving.engine",
         "grove_tpu.serving.quant", "grove_tpu.serving.kvcache",
         "grove_tpu.serving.checkpoint")
RUNS = [("serving_smoke_torch", []), ("engine_profile_smoke_torch", []),
        ("reqtrace_smoke_torch", []), ("decode_smoke_torch", []),
        ("decode_smoke_torch", ["--disagg"]),
        ("chaos_soak_torch", ["--scenario", "prefill-replica-kill"]),
        ("loadgen_torch", ["--duration", "1", "--engine", "disagg"])]


def _allowed(name: str) -> bool:
    top = name.split(".")[0]
    if top == "grove_tpu":
        parts = name.split(".")
        return (len(parts) == 1 or parts[1] in CONTROL_PLANE
                or name in REGISTRIES)
    return top not in ("jax", "jaxlib", "optax", "orbax")


def test_twins_exist():
    assert {p.stem for p in TWINS} == {
        "loadgen_torch", "serving_smoke_torch", "engine_profile_smoke_torch",
        "reqtrace_smoke_torch", "decode_smoke_torch", "chaos_soak_torch"}


@pytest.mark.parametrize("path", TWINS, ids=lambda p: p.stem)
def test_twin_imports_only_the_control_plane_and_the_port(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if not _allowed(n)]
    assert not bad, bad


@pytest.mark.timeout(240)
def test_twins_run_without_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import importlib\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"for mod, args in {RUNS!r}:\n"
        "    rc = importlib.import_module(mod).main(['--device', 'cpu']"
        " + args)\n"
        "    assert rc == 0, (mod, rc)\n"
        f"never = {NEVER!r}\n"
        "bad = sorted(m for m in sys.modules if any("
        "m == n or m.startswith(n + '.') for n in never))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=220)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    for ok in ("serving smoke OK:", "engine-profile smoke OK:",
               "reqtrace smoke OK:", "decode smoke OK:",
               "decode smoke OK (disagg):", "prefill-replica-kill OK:"):
        assert ok in proc.stdout, ok
