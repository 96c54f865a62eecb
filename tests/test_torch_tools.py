"""The port's twins of the data-plane gates (tools/*_torch.py), each run
through its ``main`` with ``--device cpu`` at test-tiny: the serving,
engine-profile, request-trace and decode smokes (mono and ``--disagg``),
the prefill-replica-kill chaos scenario, and the load generator. Each
exits 0 with its JAX counterpart's assertions held inside; the output's
OK line is checked here. tests/test_torch_tools_nojax.py runs them again
in a process of their own, where no JAX may load."""

import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(120)

# twin module, its arguments, and the OK line it prints last.
TWINS = {
    "serving": ("serving_smoke_torch", [], "serving smoke OK:"),
    "engine_profile": ("engine_profile_smoke_torch", [],
                       "engine-profile smoke OK:"),
    "reqtrace": ("reqtrace_smoke_torch", [], "reqtrace smoke OK:"),
    "decode": ("decode_smoke_torch", [], "decode smoke OK:"),
    "decode_disagg": ("decode_smoke_torch", ["--disagg"],
                      "decode smoke OK (disagg):"),
    "chaos": ("chaos_soak_torch", ["--scenario", "prefill-replica-kill"],
              "prefill-replica-kill OK:"),
    "loadgen": ("loadgen_torch", ["--duration", "2", "--engine", "paged",
                                  "--tag-requests"], "client-side latency"),
}


@pytest.fixture
def env():
    """The twins set GROVE_XPROF and friends for their own run: put the
    environment back afterwards."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.mark.parametrize("name", TWINS)
def test_twin_main_exits_0_on_the_cpu(name, env, capsys):
    import importlib
    module, args, ok = TWINS[name]
    mod = importlib.import_module(module)
    assert mod.main(["--device", "cpu"] + args) == 0
    out = capsys.readouterr().out
    assert ok in out, out[-2000:]


def test_twin_without_a_card_refuses_the_cuda_default(env):
    """No fallback: the default device is the card, and without one the
    twin raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import decode_smoke_torch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_smoke_torch.main([])


def test_chaos_list_names_the_scenario(capsys):
    import chaos_soak_torch
    assert chaos_soak_torch.main(["--list"]) == 0
    assert "prefill-replica-kill" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chaos_soak_torch.main([])


def test_decode_twin_pins_the_jax_smokes_sets():
    """The decode gate's workload and pinned build sets (which the twin and
    chip_smoke.py's phase 17 run) equal tools/decode_smoke.py's own."""
    import decode_smoke

    from grove_tpu_torch.serving import decode_gate
    names = ("EXPECTED_LOWERINGS", "EXPECTED_WITH_PREFIX", "EXPECTED_SPEC",
             "EXPECTED_QUANT", "EXPECTED_DISAGG_PREFILL",
             "EXPECTED_DISAGG_DECODE", "PROMPT_LENS", "MAX_NEW")
    assert sorted(decode_gate.PINS) == sorted(names)
    for name in names:
        assert decode_gate.PINS[name] == getattr(decode_smoke, name), name
        assert getattr(decode_gate, name) == getattr(decode_smoke, name)
