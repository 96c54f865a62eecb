"""The port's checkpoints (grove_tpu_torch/serving/checkpoint.py) on the CPU:
the twins of tests/test_moe_checkpoint.py's round trip and of
tests/test_disruption.py's engine warm restart, JAX params carried across
and saved bitwise, the atomic step rule, ``like=`` refusing another shape,
warm restarts A -> B -> A into live engines (paged with bf16 and int8
weights, greedy and self-draft spec, and the lanes engine) whose tokens
equal fresh engines' tokens, the rebinding pitfall the in-place copy
avoids, engines built on params straight from a train step, and the
responder driven through a disruption barrier.

Every comparison here is bitwise: a checkpoint holds the bits, and a
restored engine runs the same functions on them.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from grove_tpu.api.config import OperatorConfiguration
from grove_tpu.disruption import register_responder, unregister_responder
from grove_tpu.disruption.reclaim import ReclaimController
from grove_tpu.models import llama as jllama
from grove_tpu.serving import quant as jquant
from grove_tpu_torch import train
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.models import moe as tmoe
from grove_tpu_torch.serving import checkpoint as ckpt
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving.quant import (QTensor, flatten_params,
                                          quantize_params)
from test_disruption import (_deploy_workload, _drive, _manual_cluster,
                             _notice_slice)

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], max_seq_len=64)
GEOM = dict(batch=4, max_len=48, block_size=8, prefill_chunk=8,
            host_sync_interval=4, device="cpu")
PROMPT_LENS = (5, 19, 3, 11, 7)
MAX_NEW = 6


def _params(seed, cfg=CFG):
    return tllama.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _leaves(tree):
    return list(flatten_params(tree)[0].items())


def _assert_bitwise(a, b):
    fa, qa = flatten_params(a)
    fb, qb = flatten_params(b)
    assert list(fa) == list(fb) and qa == qb
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def drive(eng, want: int, max_iters: int = 3000) -> None:
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        if (eng._active.size if isinstance(eng, tengine.DisaggServing)
                else eng._sched.live):
            eng.step()
    eng.sync()
    assert len(eng.completed) >= want, (len(eng.completed), want)


def serve(eng) -> list[list[int]]:
    """The prompts once more through ``eng``: each request's tokens, in
    the order admitted (request ids keep counting across calls). A lanes
    engine takes its first ``batch`` prompts as one right-padded batch."""
    n0 = len(eng.completed)
    if isinstance(eng, tengine.DecodeEngine):
        prompts = _prompts()[:eng.batch]
        toks = np.zeros((eng.batch, max(map(len, prompts))), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        eng.admit_prompts(torch.from_numpy(toks), max_new_tokens=MAX_NEW,
                          lengths=torch.tensor([len(p) for p in prompts]))
        for _ in range(4 * MAX_NEW):
            if len(eng.completed) >= n0 + len(prompts):
                break
            eng.step()
        eng.sync()
        assert len(eng.completed) == n0 + len(prompts)
    else:
        for p in _prompts():
            eng.submit(p, max_new_tokens=MAX_NEW)
        drive(eng, n0 + len(PROMPT_LENS))
    return [list(r.generated)
            for r in sorted(eng.completed[n0:], key=lambda r: r.rid)]


def builds(eng) -> int:
    """Executables an engine has built: bucket steps and chunks, and every
    build in the observatory's compile table."""
    n = sum(eng.xprof.compile.counts().values()) if eng.xprof else 0
    return n + len(getattr(eng, "_steps", ())) + \
        len(getattr(eng, "_specs", ())) + len(getattr(eng, "_prefills", ()))


# ---- the twins of the JAX package's checkpoint tests ----


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_moe_checkpoint.py's round trip, on the port's MoE params."""
    cfg = dataclasses.replace(tmoe.MOE_CONFIGS["moe-test-tiny"],
                              dtype=torch.float32)
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, params, step=3)
    assert ckpt.latest_step(path) == 3
    restored = ckpt.load_params(path, step=3, like=params)
    _assert_bitwise(params, restored)
    assert sorted(os.listdir(path)) == ["3"]
    assert sorted(os.listdir(os.path.join(path, "3"))) == [
        "manifest.json", "params.pt"]


def test_engine_checkpoint_warm_restart_roundtrip(tmp_path):
    """tests/test_disruption.py's engine warm restart: save_engine steps
    forward, warm_restart lands the latest params back in the engine's own
    tensor, and engine_responder wires it into the barrier."""
    class FakeEngine:
        def __init__(self, v):
            self.params = {"w": torch.full((4,), v, dtype=torch.float32)}

        def idle(self):
            return True

        def reset_prefix_cache(self):
            return 0

    path = str(tmp_path / "ckpt")
    engine = FakeEngine(1.0)
    ckpt.save_engine(path, engine)                  # step 0
    engine.params["w"].fill_(2.0)
    responder = ckpt.engine_responder(engine, path)
    responder(None)                                 # step 1 (barrier hook)
    assert ckpt.latest_step(path) == 1
    engine.params["w"].zero_()
    held = engine.params["w"]
    step = ckpt.warm_restart(path, engine)
    assert step == 1
    assert engine.params["w"] is held               # copied in place
    assert torch.equal(held, torch.full((4,), 2.0))
    assert ckpt.warm_restart(path, engine, step=0) == 0
    assert torch.equal(held, torch.full((4,), 1.0))
    with pytest.raises(FileNotFoundError):
        ckpt.warm_restart(str(tmp_path / "empty"), engine)


def test_warm_restart_needs_an_engine_that_says_it_is_idle(tmp_path):
    """An object with params but no ``idle()`` is not taken for idle: the
    restart raises before any weight is written."""

    class Bare:
        params = {"w": torch.ones(4)}

    ckpt.save_params(str(tmp_path), {"w": torch.zeros(4)}, step=0)
    with pytest.raises(AttributeError, match="idle"):
        ckpt.warm_restart(str(tmp_path), Bare())
    assert torch.equal(Bare.params["w"], torch.ones(4))


@pytest.mark.parametrize("quant", [False, True])
def test_jax_params_carried_across_save_and_load_bitwise(tmp_path, quant):
    """JAX params (bf16; int8 leaves too) -> params_from_numpy -> save ->
    load: every leaf is JAX's, bit for bit, and int8 leaves stay
    ``QTensor``s."""
    jp = jllama.init_params(jllama.CONFIGS["test-tiny"],
                            jax.random.PRNGKey(0))
    if quant:
        jp = jquant.quantize_params(jp)
    host = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(host, device="cpu")
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, tp, step=0)
    back = ckpt.load_params(path, 0, device="cpu")
    _assert_bitwise(tp, back)
    assert isinstance(back["layers"]["wq"], QTensor) == quant

    def same_bits(a, t):
        if hasattr(a, "q"):
            same_bits(a.q, t.q)
            same_bits(a.scale, t.scale)
            return
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        assert t.view(torch.uint8).numpy().tobytes() == a.tobytes()

    for name, a in host.items():
        if isinstance(a, dict):
            for n, leaf in a.items():
                same_bits(leaf, back[name][n])
        else:
            same_bits(a, back[name])


def test_moe_tree_converts_unchanged():
    """convert.params_from_numpy carries a JAX MoE tree across as it is (a
    dict of arrays): the same keys and shapes, the values bitwise."""
    from grove_tpu.models import moe as jmoe

    jp = jmoe.init_params(jmoe.MOE_CONFIGS["moe-test-tiny"],
                          jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))


def test_half_written_step_is_not_counted(tmp_path, monkeypatch):
    """A step is written under a temporary name that is not all digits and
    renamed whole: a save that dies half way leaves no step and no
    temporary directory, and a stray temporary directory is not a step."""
    path = str(tmp_path / "ckpt")
    params = _params(0)
    ckpt.save_params(path, params, step=0)
    os.makedirs(os.path.join(path, ".1.partial-x"))
    assert ckpt.latest_step(path) == 0

    def dies(obj, f, *args, **kwargs):
        f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_params(path, params, step=2)
    assert sorted(os.listdir(path)) == [".1.partial-x", "0"]
    assert ckpt.latest_step(path) == 0
    monkeypatch.undo()
    with pytest.raises(FileExistsError):
        ckpt.save_params(path, params, step=0)


def test_like_with_another_shape_or_structure_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    params = _params(0)
    ckpt.save_params(path, params, step=0)
    bigger = _params(0, dataclasses.replace(CFG, d_ff=256))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_params(path, 0, like=bigger)
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_params(path, 0, like=quantize_params(params))
    fewer = dict(params, layers={k: v for k, v in params["layers"].items()
                                 if k != "w_up"})
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_params(path, 0, like=fewer)
    # like= lands each leaf in like's dtype.
    f32 = ckpt.load_params(path, 0, like=_params(
        0, dataclasses.replace(CFG, dtype=torch.float32)))
    assert f32["lm_head"].dtype == torch.float32
    assert torch.equal(f32["lm_head"], params["lm_head"].float())


# ---- warm restart into live engines ----

ENGINES = {
    "paged_bf16": dict(quant=None),
    "paged_int8": dict(quant="int8"),
    "spec_self_bf16": dict(quant=None, spec_decode=True, spec_k=2,
                           draft_params="self"),
    "spec_self_int8": dict(quant="int8", spec_decode=True, spec_k=2,
                           draft_params="self"),
    "lanes_bf16": dict(quant=None, mode="lanes"),
}


def _engine(params, kind):
    kw = dict(ENGINES[kind])
    if kw.pop("mode", None) == "lanes":
        return tengine.make_engine(CFG, params, mode="lanes", batch=4,
                                   max_len=48, host_sync_interval=4,
                                   device="cpu", **kw)
    eng = tengine.make_engine(CFG, params, mode="paged", **GEOM, **kw)
    eng.warmup()
    return eng


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_warm_restart_a_b_a_into_a_live_engine(tmp_path, kind):
    """An engine on params A serves; B's checkpoint is copied into it in
    place and it serves B's tokens (a fresh engine's on B); A's step
    restored, A's tokens again, bitwise. The params dict and every leaf
    stay the engine's own, and nothing is built anew."""
    a, b = _params(1), _params(2)
    live = _engine(a, kind)
    tok_a = serve(live)
    ckpt.save_engine(str(tmp_path / "a"), live)                 # step 0
    fresh_b = _engine(b, kind)
    tok_b = serve(fresh_b)
    assert tok_b != tok_a
    ckpt.save_engine(str(tmp_path / "b"), fresh_b)
    tree, held = live.params, _leaves(live.params)
    n_built = builds(live)

    assert ckpt.warm_restart(str(tmp_path / "b"), live) == 0
    assert serve(live) == tok_b
    assert ckpt.warm_restart(str(tmp_path / "a"), live, step=0) == 0
    assert serve(live) == tok_a
    assert live.params is tree
    assert all(t is u for (_, t), (_, u) in zip(held, _leaves(live.params)))
    if getattr(live, "_self_draft", False):
        assert live._draft_params is live.params
    assert builds(live) == n_built


def test_warm_restart_a_disaggregated_pair_tier_by_tier(tmp_path):
    a, b = _params(1), _params(2)

    def pair(p):
        eng = tengine.make_disagg(CFG, p, **GEOM)
        eng.warmup()
        return eng

    live = pair(a)
    fresh_b = pair(b)
    live.prefill.params = dict(live.prefill.params)   # tiers hold two dicts
    tok_a, tok_b = serve(live), serve(fresh_b)
    ckpt.save_engine(str(tmp_path / "b"), fresh_b)
    ckpt.save_engine(str(tmp_path / "a"), live)
    ckpt.warm_restart(str(tmp_path / "b"), live)
    assert serve(live) == tok_b
    ckpt.warm_restart(str(tmp_path / "a"), live)
    assert serve(live) == tok_a


def _busy_engine(kind, params):
    """An engine holding KV that ``params`` wrote: a live paged sequence,
    an occupied lane, or a finished prefill waiting in a prefill tier's
    outbox (its sequence already detached from the scheduler)."""
    prompt = _prompts()[1]
    if kind == "lanes":
        eng = _engine(params, "lanes_bf16")
        eng.admit_prompts(torch.from_numpy(np.tile(prompt, (eng.batch, 1))),
                          max_new_tokens=MAX_NEW)
        return eng
    if kind == "paged":
        eng = _engine(params, "paged_bf16")
        eng.submit(prompt, max_new_tokens=MAX_NEW)
        eng.admit_from_queue()
        eng.step()
        return eng
    eng = tengine.PrefillEngine(CFG, params, **GEOM)
    eng.submit(prompt, max_new_tokens=MAX_NEW)
    for _ in range(len(prompt)):
        eng.admit_from_queue()
        eng.step()
        if eng.outbox:
            break
    assert eng.outbox and not eng._sched.live
    return eng


@pytest.mark.parametrize("kind", ["paged", "lanes", "prefill_outbox"])
def test_warm_restart_refuses_an_engine_with_sequences_in_flight(tmp_path,
                                                                 kind):
    eng = _busy_engine(kind, _params(1))
    assert not eng.idle()
    ckpt.save_engine(str(tmp_path), eng)
    before = [t.clone() for _, t in _leaves(eng.params)]
    with pytest.raises(RuntimeError, match="idle"):
        ckpt.warm_restart(str(tmp_path), eng)
    assert all(torch.equal(t, u) for t, (_, u) in
               zip(before, _leaves(eng.params)))


def test_warm_restart_raises_on_another_structure(tmp_path):
    eng = _engine(_params(1), "paged_bf16")
    ckpt.save_params(str(tmp_path), quantize_params(_params(2)), step=0)
    before = [t.clone() for _, t in _leaves(eng.params)]
    with pytest.raises(ValueError, match="structure"):
        ckpt.warm_restart(str(tmp_path), eng)
    assert all(torch.equal(t, u) for t, (_, u) in
               zip(before, _leaves(eng.params)))


def test_warm_restart_of_a_prefill_worker(tmp_path):
    a, b = _params(1), _params(2)
    prompts = _prompts()[:2]

    def worker(p):
        return tengine.PrefillWorker(CFG, p, batch=2, max_prompt=32,
                                     device="cpu")

    live = worker(a)
    k_a = live.prefill(prompts)[0].k
    ckpt.save_engine(str(tmp_path), worker(b))
    ckpt.warm_restart(str(tmp_path), live)
    got = live.prefill(prompts)
    want = worker(b).prefill(prompts)
    assert [r.next_token for r in got] == [r.next_token for r in want]
    assert all(torch.equal(g.k, w.k) for g, w in zip(got, want))
    assert not torch.equal(got[0].k, k_a)


def test_rebinding_params_leaves_the_engine_serving_the_old_weights():
    """The pitfall the in-place copy avoids: the engine's steps and chunks
    closed over the params they were built on, so ``engine.params = B``
    changes nothing it serves (prefix cache off: every prompt prefills)."""
    a, b = _params(1), _params(2)
    eng = tengine.make_engine(CFG, a, mode="paged", prefix_cache=False,
                              **GEOM)
    eng.warmup()
    tok_a = serve(eng)
    fresh_b = tengine.make_engine(CFG, b, mode="paged", prefix_cache=False,
                                  **GEOM)
    fresh_b.warmup()
    tok_b = serve(fresh_b)
    assert tok_b != tok_a
    eng.params = b
    assert serve(eng) == tok_a


def test_warm_restart_drops_the_prefix_cache(tmp_path):
    """Cached prefixes hold KV the old weights wrote: after a warm restart
    none is matched (a repeat of the same prompts prefills them anew)."""
    eng = _engine(_params(1), "paged_bf16")
    serve(eng)
    assert eng._prefix.nodes > 0
    cached = eng._alloc.cached_blocks
    reclaimed = eng._alloc.reclaimed_total
    assert cached > 0 and eng.idle()
    ckpt.save_engine(str(tmp_path), eng)
    ckpt.warm_restart(str(tmp_path), eng)
    assert eng._prefix.nodes == 0
    assert eng._alloc.cached_blocks == 0
    assert eng._alloc.reclaimed_total == reclaimed + cached
    eng._alloc.check()


# ---- trained params in engines ----


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_on_params_from_train_step_serves_as_on_clones(quant):
    """Params straight from ``train_step`` (leaves that require grad) serve
    the same tokens as their detached clones: every dispatch runs under
    no_grad, so no kernel wrapper sees an input that requires grad."""
    tp = _params(3)
    opt = train.make_optimizer(tp)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (2, 16)).astype(np.int32))
    train.train_step(CFG, tp, opt, tokens)
    assert tp["lm_head"].requires_grad
    clones = {k: ({n: w.detach().clone() for n, w in v.items()}
                  if isinstance(v, dict) else v.detach().clone())
              for k, v in tp.items()}
    out = []
    for p in (tp, clones):
        eng = tengine.make_engine(CFG, p, mode="paged", quant=quant, **GEOM)
        eng.warmup()
        out.append(serve(eng))
    assert out[0] == out[1]


def test_engine_shares_the_trainers_tensors(tmp_path):
    """An engine (dense weights) keeps the tensors it was built on: an
    optimizer step changes what it serves, and a warm restart into it
    overwrites the trainer's weights."""
    tp = _params(3)
    opt = train.make_optimizer(tp)
    eng = tengine.make_engine(CFG, tp, mode="paged", prefix_cache=False,
                              **GEOM)
    eng.warmup()
    assert eng.params["lm_head"] is tp["lm_head"]
    ckpt.save_engine(str(tmp_path), eng)                       # step 0
    before = serve(eng)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, CFG.vocab_size, (2, 16)).astype(np.int32))
    for _ in range(3):
        train.train_step(CFG, tp, opt, tokens)
    assert serve(eng) != before
    ckpt.warm_restart(str(tmp_path), eng, step=0)
    assert serve(eng) == before
    saved = ckpt.load_params(str(tmp_path), 0, device="cpu")
    assert torch.equal(tp["lm_head"].detach(), saved["lm_head"])


# ---- the disruption barrier ----


def test_engine_responder_acks_a_barrier_with_a_new_step(tmp_path):
    """The port's responder under grove_tpu.disruption's contract: a spot
    notice's barrier runs it (tests/test_disruption.py's drive), the
    barrier acks, a new step exists on disk, and a relanded engine
    warm-restarts from it to the same tokens."""
    path = str(tmp_path / "ckpt")
    eng = _engine(_params(1), "paged_bf16")
    want = serve(eng)
    ckpt.save_engine(path, eng)                                # step 0
    cluster = _manual_cluster()
    with cluster:
        client = cluster.client
        gang = _deploy_workload(client)
        register_responder(gang.meta.name, ckpt.engine_responder(eng, path))
        try:
            rc = ReclaimController(client, cluster.manager.store,
                                   OperatorConfiguration().disruption)
            _notice_slice(client, gang.status.assigned_slice)
            _drive(rc, lambda: rc.counters["completed"] >= 1,
                   desc="evacuation after the engine's checkpoint")
            assert rc.payload()["recent"][0]["barrier"] == "acked"
        finally:
            unregister_responder(gang.meta.name)
    assert ckpt.latest_step(path) == 1
    relanded = _engine(_params(2), "paged_bf16")
    assert ckpt.warm_restart(path, relanded) == 1
    assert serve(relanded) == want
