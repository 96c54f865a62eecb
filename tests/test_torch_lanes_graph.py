"""The lanes engine's decode over static buffers (CUDA graphs on the card)
against the JAX package's ``DecodeEngine``.

On the card ``DecodeEngine`` replays one captured graph per (batch,
max_len, sampled) for ``step`` and one for ``run``'s K-step windows, which
read and advance the token buffer ``_tokens`` and the cache's length
buffer ``cache.lengths`` in place; on the CPU the same functions run
eagerly over the same buffers. These tests hold the port's greedy tokens
exactly to JAX's (test-tiny in f32, the same numpy params, keyed by
request id) over a schedule that crosses every seam of those buffers: a
``run`` whose remainder is not a multiple of K, ``release_lane`` and
``insert`` while a pending window is open, ``admit_from_queue`` through a
``PrefillWorker``, lanes finishing mid-window and a second
``admit_prompts`` on the same engine; the cache and its length buffer
stay the same objects across every call; ``warmup`` leaves the lanes as
they were; the sampled path (``top_k = 1`` is greedy, a seed repeats, two
seeds differ); and the host-sync rule of the lanes dispatch. The card-only
cases skip inside their bodies without CUDA: graph replays bitwise equal
to an eager loop of the model functions, and no capture after the first
window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.models import llama as jllama
from grove_tpu.serving import engine as jengine
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.ops.kvcache import KVCache
from grove_tpu_torch.serving import engine as tengine

from test_torch_host_sync import _method, host_syncs

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
K = 4


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _prompts(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, T_CFG.vocab_size, (b, s)).astype(np.int32)


class _Port:
    """The port's side of the schedule, checking after every call that the
    cache and its length buffer are the objects the graphs hold."""

    def __init__(self, tree, **kw):
        self.eng = tengine.DecodeEngine(
            T_CFG, params_from_numpy(tree, device="cpu"), device="cpu", **kw)
        self.worker = tengine.PrefillWorker(
            T_CFG, self.eng.params, batch=2, max_prompt=16, device="cpu")
        self.mod = tengine
        self.held = (self.eng.cache, self.eng.cache.lengths,
                     self.eng._tokens, self.eng._window)

    def array(self, a):
        return torch.from_numpy(a)

    def check(self):
        e = self.eng
        now = (e.cache, e.cache.lengths, e._tokens, e._window)
        assert all(a is b for a, b in zip(now, self.held))


class _Jax:
    def __init__(self, tree, **kw):
        jp = jax.tree.map(jnp.asarray, tree)
        self.eng = jengine.DecodeEngine(J_CFG, jp, xprof=False,
                                        reqtrace=False, **kw)
        self.worker = jengine.PrefillWorker(J_CFG, jp, batch=2,
                                            max_prompt=16)
        self.mod = jengine

    def array(self, a):
        return jnp.asarray(a)

    def check(self):
        pass


def _schedule(side) -> dict[int, list[int]]:
    """The same calls on either package; returns tokens by request id."""
    eng, check = side.eng, side.check
    first = _prompts(3, 10, 1)
    eng.admit_prompts(side.array(first), max_new_tokens=11,
                      lengths=side.array(np.array([10, 6, 8], np.int32)))
    check()
    eng.run(6)                       # one K-step block and two single steps
    check()
    eng.step()
    eng.step()                       # a window of two steps pending
    check()
    eng.release_lane(1)              # drains the open window first
    check()
    eng.step()                       # another window opens
    res = side.worker.prefill([_prompts(1, 7, 2)[0]])
    req = side.mod.Request(rid=100, prompt=_prompts(1, 7, 2)[0],
                           max_new_tokens=6)
    eng.insert(1, res[0], req)       # spliced while that window is open
    check()
    for _ in range(5):               # lane 1 finishes mid-window
        eng.step()
    check()
    eng.run(9)                       # two blocks and one single step
    check()
    for p in _prompts(3, 5, 3):
        eng.submit(p, max_new_tokens=7)
    for _ in range(60):
        eng.admit_from_queue(side.worker)
        check()
        if len(eng.completed) >= 7:
            break
        eng.step()
        check()
    eng.sync()
    assert len(eng.completed) == 7 and not eng._active.any()
    eng.admit_prompts(side.array(_prompts(3, 12, 4)), max_new_tokens=10)
    check()                          # a second admission, another shape
    eng.run(10)
    check()
    eng.sync()
    assert len(eng.completed) == 10
    return {r.rid: list(r.generated) for r in eng.completed}


def test_schedule_tokens_match_jax_exactly(params):
    jp, tree = params
    kw = dict(batch=3, host_sync_interval=K)
    want = _schedule(_Jax(tree, **kw))
    got = _schedule(_Port(tree, **kw))
    assert got == want
    assert set(got) == {0, 1, 2, 100, 3, 4, 5, 6, 7, 8}


def test_warmup_leaves_the_lanes_as_they_were(params):
    """``warmup`` builds (and runs) the step and the block over live lanes
    and restores their buffers: the tokens are those of an engine that
    never warmed up, and a second warmup builds nothing."""
    _, tree = params
    kw = dict(batch=3, host_sync_interval=K)
    plain, warmed = _Port(tree, **kw), _Port(tree, **kw)
    prompts = _prompts(3, 9, 5)
    for side in (plain, warmed):
        side.eng.admit_prompts(torch.from_numpy(prompts), max_new_tokens=12)
    assert warmed.eng.warmup() == 2
    assert warmed.eng.warmup() == 0
    warmed.check()
    assert warmed.eng.steps == 0
    for side in (plain, warmed):
        side.eng.run(11)
        side.eng.sync()
    assert [r.generated for r in warmed.eng.completed] == \
        [r.generated for r in plain.eng.completed]
    if warmed.eng.xprof is not None:
        counts = warmed.eng.xprof.compile.counts()
        assert counts["step"] == counts["step_block"] == 1


def _sampled_tokens(tree, **sampler):
    side = _Port(tree, batch=2, host_sync_interval=K,
                 sampler=tengine.SamplerConfig(**sampler))
    side.eng.admit_prompts(torch.from_numpy(_prompts(2, 8, 6)),
                           max_new_tokens=9)
    side.eng.run(7)
    side.eng.step()
    side.eng.sync()
    side.check()
    assert len(side.eng.completed) == 2
    return [r.generated for r in side.eng.completed]


def test_sampled_lanes(params):
    _, tree = params
    greedy = _sampled_tokens(tree)
    assert _sampled_tokens(tree, temperature=1.0, top_k=1, seed=3) == greedy
    a = _sampled_tokens(tree, temperature=1.0, top_k=40, seed=3)
    assert _sampled_tokens(tree, temperature=1.0, top_k=40, seed=3) == a
    assert _sampled_tokens(tree, temperature=1.0, top_k=40, seed=4) != a


# The lanes dispatch: what step() and run()'s windows run between fetches.
LANES_DISPATCH = ("step", "_launch", "_dispatch", "_decode", "_block",
                  "_keep_lengths", "_choose")


@pytest.mark.parametrize("name", LANES_DISPATCH)
def test_lanes_dispatch_path_has_no_host_sync(name):
    assert host_syncs(_method(tengine.DecodeEngine, name)) == []


def test_run_fetches_once_for_its_windows():
    """``run``'s one fetch of every window ([w, batch] rows, then the
    bookkeeping): one ``.cpu()`` in its body, the single steps' drains and
    ``sync`` aside."""
    found = host_syncs(_method(tengine.DecodeEngine, "run"))
    assert [s.split(": ")[1] for s in found] == [".cpu()"], found


# ---- on the card ----

def _card_engine(cfg, params, **kw):
    return tengine.DecodeEngine(cfg, params, batch=4, max_len=64,
                                host_sync_interval=K, device="cuda", **kw)


def test_graph_replays_equal_an_eager_loop_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(tllama.CONFIGS["test-tiny"], max_seq_len=64)
    params = tllama.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                "cuda")
    prompts = torch.from_numpy(_prompts(4, 8, 7)).cuda()
    eng = _card_engine(cfg, params)
    eng.admit_prompts(prompts, max_new_tokens=14)
    eng.run(13)                      # three blocks and one single step
    eng.sync()
    assert eng.graphs_captured == 2
    got = [r.generated for r in sorted(eng.completed, key=lambda r: r.rid)]
    with torch.no_grad():
        cache = KVCache.create(cfg.n_layers, 4, 64, cfg.n_kv_heads,
                               cfg.head_dim, cfg.dtype, "cuda")
        logits, cache = tllama.prefill(cfg, params, prompts, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        want = [tok]
        for _ in range(13):
            logits, cache = tllama.decode_step(cfg, params, tok, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(tok)
    want = torch.stack(want).T.cpu().tolist()
    assert got == want


def test_no_capture_after_the_first_window_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(tllama.CONFIGS["test-tiny"], max_seq_len=64)
    params = tllama.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                                "cuda")
    eng = _card_engine(cfg, params)
    eng.admit_prompts(torch.from_numpy(_prompts(4, 8, 8)).cuda(),
                      max_new_tokens=40)
    eng.run(K)
    eng.step()
    captured = eng.graphs_captured
    assert captured == 2
    for _ in range(3):
        eng.run(2 * K + 1)
    eng.release_lane(0)
    for _ in range(3):
        eng.step()
    eng.sync()
    assert eng.graphs_captured == captured
