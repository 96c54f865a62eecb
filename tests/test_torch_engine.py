"""The port's lanes engine against the JAX package's DecodeEngine, its own
run/step and capacity invariants, the engine factory, and the rule that the
port imports neither JAX nor the JAX package."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.serving import engine as jengine
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving.slo import EngineTelemetry

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "grove_tpu_torch"


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_engine(jp, **kw):
    return jengine.DecodeEngine(J_CFG, jp, xprof=False, reqtrace=False, **kw)


def _port_engine(tp, **kw):
    return tengine.DecodeEngine(T_CFG, tp, device="cpu", **kw)


def _by_rid(eng):
    return {r.rid: list(r.generated) for r in eng.completed}


def test_admit_prompts_greedy_tokens_match_jax(params):
    jp, tp = params
    prompts = np.random.default_rng(1).integers(
        0, J_CFG.vocab_size, (3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    je = _jax_engine(jp, batch=3, host_sync_interval=4)
    te = _port_engine(tp, batch=3, host_sync_interval=4)
    je.admit_prompts(jnp.asarray(prompts), max_new_tokens=10,
                     lengths=jnp.asarray(lengths))
    te.admit_prompts(torch.from_numpy(prompts), max_new_tokens=10,
                     lengths=torch.from_numpy(lengths))
    je.run(12)
    te.run(12)
    assert len(te.completed) == 3
    assert _by_rid(te) == _by_rid(je)
    for r in te.completed:
        assert len(r.generated) == 10


def test_queue_through_prefill_worker_matches_jax(params):
    """submit + admit_from_queue(PrefillWorker), with more requests than
    lanes so that lanes are recycled; tokens keyed by request id."""
    jp, tp = params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, J_CFG.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 11, 7)]
    jw = jengine.PrefillWorker(J_CFG, jp, batch=2, max_prompt=16)
    tw = tengine.PrefillWorker(T_CFG, tp, batch=2, max_prompt=16,
                               device="cpu")
    out = {}
    for side, eng, worker in (("jax", _jax_engine(jp, batch=2), jw),
                              ("port", _port_engine(tp, batch=2), tw)):
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        for _ in range(100):
            eng.admit_from_queue(worker)
            if len(eng.completed) == len(prompts):
                break
            eng.step()
        assert sorted(r.rid for r in eng.completed) == rids
        assert all(len(r.generated) == 6 for r in eng.completed)
        out[side] = _by_rid(eng)
    assert out["port"] == out["jax"]


def test_run_block_matches_step_loop(params):
    """run() (K-step windows, deferred drain) gives the same tokens and
    bookkeeping as a step() loop."""
    _, tp = params
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, T_CFG.vocab_size, (2, 6)).astype(np.int32))
    stepper = _port_engine(tp, batch=2, host_sync_interval=4)
    stepper.admit_prompts(prompts, max_new_tokens=12)
    for _ in range(14):
        stepper.step()
    stepper.sync()
    runner = _port_engine(tp, batch=2, host_sync_interval=4)
    runner.admit_prompts(prompts, max_new_tokens=12)
    runner.run(14)  # 3 full windows + 2 single steps
    assert len(runner.completed) == len(stepper.completed) == 2
    assert _by_rid(runner) == _by_rid(stepper)
    assert torch.equal(runner._tokens, stepper._tokens)


def test_run_untracked_block_path_matches_step(params):
    _, tp = params
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, T_CFG.vocab_size, (2, 6)).astype(np.int32))
    a = _port_engine(tp, batch=2, host_sync_interval=4)
    a.admit_prompts(prompts)
    a.run(8)
    b = _port_engine(tp, batch=2, host_sync_interval=4)
    b.admit_prompts(prompts)
    for _ in range(8):
        b.step()
    b.sync()
    assert torch.equal(a._tokens, b._tokens)
    assert a.steps == b.steps == 8


def test_run_respects_cache_capacity(params):
    """A tracked lane near max_len completes through the single-step path
    before the cache write could clamp: the same bookkeeping as JAX."""
    jp, tp = params
    s = T_CFG.max_seq_len - 6  # about 5 decode steps of room
    prompts = np.random.default_rng(8).integers(
        0, T_CFG.vocab_size, (2, s)).astype(np.int32)
    je = _jax_engine(jp, batch=2, host_sync_interval=4)
    te = _port_engine(tp, batch=2, host_sync_interval=4)
    je.admit_prompts(jnp.asarray(prompts), max_new_tokens=1000)
    te.admit_prompts(torch.from_numpy(prompts), max_new_tokens=1000)
    je.run(24)
    te.run(24)
    assert len(te.completed) == 2  # freed at capacity, not clamped
    for r in te.completed:
        assert r.prompt_len + len(r.generated) - 1 <= T_CFG.max_seq_len
    assert _by_rid(te) == _by_rid(je)


def test_step_fetches_to_host_once_per_window(params, monkeypatch):
    """step() only launches device work; the host sees tokens once per
    window of host_sync_interval steps (through one .cpu())."""
    _, tp = params
    eng = _port_engine(tp, batch=2, host_sync_interval=4)
    eng.admit_prompts(torch.zeros((2, 6), dtype=torch.int32),
                      max_new_tokens=20)
    fetches = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        fetches.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    def no_item(self):
        raise AssertionError("a host sync (.item()) in the step path")

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    for _ in range(3):
        eng.step()
    assert fetches == []
    eng.step()
    assert fetches == [(4, 2)]  # the whole [window, batch] block at once


def test_release_lane_and_insert(params):
    _, tp = params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, T_CFG.vocab_size, size=5) for _ in range(2)]
    pw = tengine.PrefillWorker(T_CFG, tp, batch=2, max_prompt=16,
                               device="cpu")
    eng = _port_engine(tp, batch=1, host_sync_interval=8)
    rid = eng.submit(prompts[0], max_new_tokens=32)
    eng.admit_from_queue(pw)
    for _ in range(3):
        eng.step()  # 3 tokens pending, not yet drained
    req = eng.release_lane(0)
    assert req is not None and req.done and req.rid == rid
    assert len(req.generated) == 4  # prefill token + 3 decoded
    assert eng.free_lanes() == [0]
    assert int(eng.cache.lengths[0]) == 0
    assert eng.release_lane(0) is None  # idempotent on a free lane
    res = pw.prefill(prompts)
    eng.insert(0, res[1])
    assert eng.free_lanes() == []
    with pytest.raises(ValueError):
        eng.insert(0, res[0])


def test_request_stamps_and_metric_hook(params):
    _, tp = params
    seen = []
    pw = tengine.PrefillWorker(T_CFG, tp, batch=1, max_prompt=8, device="cpu")
    eng = _port_engine(tp, batch=1, metric_hook=seen.append)
    eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
    eng.submit(np.array([4, 5]), max_new_tokens=2)
    assert seen == [1, 2]
    eng.admit_from_queue(pw)
    req = eng._requests[0]
    assert 0 < req.enqueue_ts <= req.admit_ts <= req.first_token_ts
    assert eng.queue_depth == 1 and eng.kv_lane_utilization == 1.0


def test_sample_tokens_greedy_and_top_k():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0]])
    greedy = tengine.SamplerConfig()
    assert tengine.sample_tokens(logits, None, greedy).tolist() == [4]
    cfgk = tengine.SamplerConfig(temperature=0.5, top_k=2)
    gen = torch.Generator().manual_seed(0)
    picks = {int(tengine.sample_tokens(logits, gen, cfgk)[0])
             for _ in range(30)}
    assert picks <= {3, 4} and len(picks) == 2


def test_make_engine_modes(params, monkeypatch):
    _, tp = params
    eng = tengine.make_engine(T_CFG, tp, mode="lanes", batch=2, device="cpu",
                              block_size=16)  # paged knobs are ignored
    assert isinstance(eng, tengine.DecodeEngine) and eng.batch == 2
    monkeypatch.setenv("GROVE_ENGINE", "lanes")
    assert isinstance(tengine.make_engine(T_CFG, tp, device="cpu"),
                      tengine.DecodeEngine)
    monkeypatch.delenv("GROVE_ENGINE")
    assert isinstance(tengine.make_engine(T_CFG, tp, device="cpu"),
                      tengine.PagedDecodeEngine)  # default: paged
    monkeypatch.setenv("GROVE_ENGINE", "bogus")
    with pytest.raises(ValueError):
        tengine.make_engine(T_CFG, tp, device="cpu")
    tel = EngineTelemetry()
    eng = tengine.make_engine(T_CFG, tp, mode="lanes", device="cpu",
                              telemetry=tel)
    assert eng.telemetry is tel  # the observatories are ported
    worker = tengine.PrefillWorker(T_CFG, tp, max_prompt=8, prefill_chunk=4,
                                   device="cpu")
    res = worker.prefill([np.arange(1, 7, dtype=np.int32)])
    assert res[0].length == 6 and res[0].k.shape[1] == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tengine.make_engine(T_CFG, tp, mode="lanes")  # device=None


def test_engine_quant_int8_runs(params):
    _, tp = params
    eng = tengine.make_engine(T_CFG, tp, mode="lanes", batch=2, quant="int8",
                              device="cpu")
    assert hasattr(eng.params["layers"]["wq"], "materialize")
    eng.admit_prompts(torch.zeros((2, 4), dtype=torch.int32),
                      max_new_tokens=3)
    eng.run(4)
    assert [len(r.generated) for r in eng.completed] == [3, 3]


# ---- import guard ----

# The port's serving modules the import rule must be seen to cover.
OBSERVED_MODULES = ("handoff", "metrics", "slo", "metrics_push", "reqtrace",
                    "xprof", "checkpoint")
# ... and its training modules.
TRAINING_MODULES = ("train.py", "models/moe.py", "models/llama.py")
# What no file of the port imports: JAX, its libraries, the JAX package.
BANNED_IMPORTS = ("jax", "jaxlib", "optax", "orbax", "grove_tpu")


def _port_modules():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    """AST scan: no file of the port (nor chip_smoke.py) imports jax,
    optax, orbax or the JAX package; the scan covers the handoff module,
    the observatories (the metrics sink, slo, metrics_push, reqtrace,
    xprof), the checkpoints and the training modules."""
    bad = []
    for name in OBSERVED_MODULES:
        assert PKG / "serving" / f"{name}.py" in _port_modules(), name
    for name in TRAINING_MODULES:
        assert PKG / name in _port_modules(), name
    for path in _port_modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in BANNED_IMPORTS:
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    mods = [m.removesuffix(".__init__") for m in mods]
    for name in OBSERVED_MODULES:
        assert f"grove_tpu_torch.serving.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED_IMPORTS!r}]\n"
        "print(len(sys.modules))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
