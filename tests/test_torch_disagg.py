"""The port's disaggregated serving (GROVE_DISAGG=1): the PrefillEngine ->
PagedDecodeEngine pair over the KV block handoff.

- against the JAX package's ``make_disagg`` pair on one workload with the
  prefix cache on: tokens keyed by request id and the handoff counts;
- twins of tests/test_disagg_serving.py (port pair against the port's mono
  engine, bitwise greedy tokens): prefix cache on and off, int8 KV blocks,
  decode-tier preemption, one-token requests, handoff backpressure and the
  factory switch;
- the port's chaos scenario ``run_prefill_replica_kill``
  (grove_tpu_torch/chaos/scenario.py, the twin of grove_tpu/chaos/
  scenario.py's): the prefill tier dies with a payload stranded in its
  outbox, and ``replace_prefill`` recovers, as in JAX's run;
- on the card only: pair == mono over a bf16 model.
"""

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
from grove_tpu_torch.serving import engine as tengine
from grove_tpu_torch.serving.handoff import HandoffPayload
from grove_tpu_torch.serving.quant import kv_block_bytes

# Without the repo's conftest (on the machine with the card) JAX would take
# the GPU, whose f32 products run at reduced precision.
jax.config.update("jax_platforms", "cpu")
# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
GEOM = dict(batch=4, block_size=8, prefill_chunk=8, host_sync_interval=4)
HANDOFF_COUNTS = ("requests", "blocks", "shared_blocks", "bytes",
                  "deferred")


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(J_CFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def drive(eng, want: int, max_iters: int = 3000) -> None:
    """Engine-agnostic drain (the JAX tests' loop): the pair and the mono
    engine share the submit/admit/step/completed surface."""
    for _ in range(max_iters):
        eng.admit_from_queue()
        if len(eng.completed) >= want:
            break
        eng.step()
    eng.sync()
    assert len(eng.completed) >= want, (len(eng.completed), want)


def mixed_prompts(seed: int, n: int = 5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 28, size=n)
    return [rng.integers(1, J_CFG.vocab_size, size=int(k)).astype(np.int32)
            for k in lens]


def by_rid(eng) -> dict:
    return {r.rid: list(r.generated) for r in eng.completed}


def assert_rid_parity(dis, mono) -> None:
    """Greedy sampling makes the comparison exact: same submit order, same
    rids, the same tokens request by request."""
    assert by_rid(dis) == by_rid(mono)


def _port_pair(tp, **kw):
    return tengine.make_disagg(T_CFG, tp, device="cpu", **{**GEOM, **kw})


def _port_mono(tp, **kw):
    return tengine.PagedDecodeEngine(T_CFG, tp, device="cpu",
                                     **{**GEOM, **kw})


def _warm_then_repeat(eng, prompts, max_new: int = 6) -> int:
    """The JAX tests' two-phase submission: the longest prompt retires
    (registering its blocks in both tiers' trees) before the rest and a
    repeat of it arrive, so the shared-prefix handoff is deterministic.
    Returns the number of requests."""
    base = max(prompts, key=len)
    rest = [t for t in prompts if t is not base]
    eng.submit(base, max_new_tokens=max_new)
    drive(eng, 1)
    for t in rest + [base.copy()]:
        eng.submit(t, max_new_tokens=max_new)
    drive(eng, len(prompts) + 1)
    return len(prompts) + 1


def _clean(dis) -> None:
    dis.decode._alloc.check()
    dis.prefill._alloc.check()
    assert dis.decode._alloc.used_blocks == 0
    assert dis.prefill._alloc.used_blocks == 0


# ---- against the JAX pair ----

@pytest.fixture(scope="module")
def jax_pair(params):
    """The JAX package's pair on the warm-prefix workload, once."""
    jp, _ = params
    dis = jengine.make_disagg(J_CFG, jp, prefix_cache=True, xprof=False,
                              reqtrace=False, **GEOM)
    _warm_then_repeat(dis, mixed_prompts(42))
    return {"tokens": by_rid(dis), "handoff": dis.handoff_view(),
            "produced": dis.prefill.handoffs_produced}


def test_pair_matches_jax_pair(params, jax_pair):
    """Tokens keyed by rid and the handoff counts (requests, blocks moved,
    blocks shared from the decode tier's prefix tree, bytes, deferrals)
    equal the JAX pair's."""
    _, tp = params
    dis = _port_pair(tp, prefix_cache=True)
    _warm_then_repeat(dis, mixed_prompts(42))
    assert by_rid(dis) == jax_pair["tokens"]
    got, want = dis.handoff_view(), jax_pair["handoff"]
    assert {k: got[k] for k in HANDOFF_COUNTS} == \
        {k: want[k] for k in HANDOFF_COUNTS}
    assert got["block_bytes"] == want["block_bytes"]
    assert dis.prefill.handoffs_produced == jax_pair["produced"]
    assert got["shared_blocks"] > 0
    _clean(dis)


# ---- twins of tests/test_disagg_serving.py ----

@pytest.mark.parametrize("prefix_cache", [True, False])
def test_disagg_matches_mono_tokens(params, prefix_cache):
    """Mixed prompt lengths, prefix cache on and off; with it on, the
    repeated prompt's matched blocks never cross the seam."""
    _, tp = params
    prompts = mixed_prompts(42)
    mono = _port_mono(tp, prefix_cache=prefix_cache)
    dis = _port_pair(tp, prefix_cache=prefix_cache)
    n = _warm_then_repeat(mono, prompts)
    _warm_then_repeat(dis, prompts)
    assert_rid_parity(dis, mono)
    hv = dis.handoff_view()
    assert hv["requests"] == n
    assert hv["bytes"] == hv["blocks"] * hv["block_bytes"]
    if prefix_cache:
        assert hv["shared_blocks"] > 0
    else:
        assert hv["shared_blocks"] == 0
    _clean(dis)


def test_disagg_int8_kv_blocks_transfer_quantized(params):
    """int8 blocks and their scales move as they are (the payload's block
    bytes are the int8 footprint), and tokens match the int8 mono engine
    bitwise."""
    _, tp = params
    prompts = mixed_prompts(43)
    mono = _port_mono(tp, kv_quant="int8")
    dis = _port_pair(tp, kv_quant="int8")
    for t in prompts:
        mono.submit(t, max_new_tokens=6)
        dis.submit(t, max_new_tokens=6)
    drive(mono, len(prompts))
    drive(dis, len(prompts))
    assert_rid_parity(dis, mono)
    hv = dis.handoff_view()
    assert hv["block_bytes"] == kv_block_bytes(T_CFG, GEOM["block_size"],
                                               "int8")
    assert hv["bytes"] == hv["blocks"] * hv["block_bytes"]
    dis.decode._alloc.check()


def test_disagg_parity_under_decode_preemption(params):
    """A tight decode pool preempts after adoption; the victims cross back
    over the seam and re-prefill on the prefill tier. Tokens still match a
    roomy mono run bitwise."""
    _, tp = params
    prompts = mixed_prompts(44, n=6)
    mono = _port_mono(tp)
    dis = _port_pair(tp, num_blocks=9, prefill_num_blocks=33)
    for t in prompts:
        mono.submit(t, max_new_tokens=12)
        dis.submit(t, max_new_tokens=12)
    drive(mono, len(prompts))
    drive(dis, len(prompts))
    assert dis.decode._sched.preemptions_total > 0, \
        "pool was not tight enough to exercise the recompute seam"
    assert_rid_parity(dis, mono)
    _clean(dis)


def test_one_token_requests_complete_on_prefill_tier(params):
    """max_new_tokens == 1 completes at the prefill tier's _finish_prefill,
    as in the mono engine: no payload ships, no decode slot burns."""
    _, tp = params
    dis = _port_pair(tp)
    mono = _port_mono(tp)
    t = mixed_prompts(45, n=1)[0]
    dis.submit(t, max_new_tokens=1)
    mono.submit(t, max_new_tokens=1)
    drive(dis, 1)
    drive(mono, 1)
    assert len(dis.prefill.completed) == 1 and not dis.decode.completed
    assert dis.prefill.handoffs_produced == 0
    assert_rid_parity(dis, mono)
    _clean(dis)


def test_handoff_backpressure_defers_not_drops(params):
    """More concurrent work than decode slots: refused adoptions stay at
    the outbox head (blocks still owned by the payload) and land on later
    ticks; every request completes and nothing leaks. (12 new tokens, not
    the JAX test's 6: at 6 the decode slots free up before a payload has
    to wait, and nothing defers.)"""
    _, tp = params
    prompts = mixed_prompts(46, n=8)
    dis = _port_pair(tp, prefill_slots=8)
    for t in prompts:
        dis.submit(t, max_new_tokens=12)
    drive(dis, len(prompts))
    assert len(dis.completed) == len(prompts)
    assert dis.handoff_view()["deferred"] > 0
    dis.decode._alloc.check()
    dis.prefill._alloc.check()
    assert not dis.decode._alloc._refs and not dis.prefill._alloc._refs


def test_make_engine_honors_grove_disagg(params, monkeypatch):
    """GROVE_DISAGG=1 routes the paged factory path to the pair, 0 and
    unset build the mono engine, and the lanes engine ignores the flag."""
    _, tp = params
    monkeypatch.setenv("GROVE_ENGINE", "paged")
    monkeypatch.setenv("GROVE_DISAGG", "1")
    eng = tengine.make_engine(T_CFG, tp, batch=2, block_size=8,
                              prefill_slots=3, device="cpu")
    assert isinstance(eng, tengine.DisaggServing)
    assert isinstance(eng.prefill, tengine.PrefillEngine)
    assert isinstance(eng.decode, tengine.PagedDecodeEngine)
    assert eng.prefill.batch == 3 and eng.decode.batch == 2
    assert eng.params is eng.decode.params
    assert eng.cache is eng.decode.kv and eng.prefill.kv is not eng.cache
    monkeypatch.setenv("GROVE_DISAGG", "0")
    eng = tengine.make_engine(T_CFG, tp, batch=2, block_size=8,
                              device="cpu")
    assert isinstance(eng, tengine.PagedDecodeEngine) \
        and not isinstance(eng, tengine.PrefillEngine)
    monkeypatch.delenv("GROVE_DISAGG")
    eng = tengine.make_engine(T_CFG, tp, batch=2, block_size=8,
                              device="cpu")
    assert isinstance(eng, tengine.PagedDecodeEngine) \
        and not isinstance(eng, tengine.PrefillEngine)
    monkeypatch.setenv("GROVE_DISAGG", "1")
    monkeypatch.setenv("GROVE_ENGINE", "lanes")
    assert isinstance(tengine.make_engine(T_CFG, tp, batch=2, max_len=48,
                                          device="cpu"),
                      tengine.DecodeEngine)


# ---- the port's own surfaces ----

def test_pair_refuses_mismatched_tiers(params):
    _, tp = params
    pre = tengine.PrefillEngine(T_CFG, tp, device="cpu", **GEOM)
    with pytest.raises(AssertionError, match="quant"):
        tengine.DisaggServing(pre, _port_mono(tp, kv_quant="int8"))
    with pytest.raises(AssertionError, match="block"):
        tengine.DisaggServing(pre, _port_mono(tp, block_size=4))
    with pytest.raises(AssertionError, match="speculative"):
        tengine.DisaggServing(pre, _port_mono(tp, spec_decode=True))


def test_make_disagg_shares_params_and_drops_spec_knobs(params):
    """int8 weights are quantized once: both tiers read the same tensors.
    The speculative knobs are dropped, and the prefill tier never
    speculates."""
    _, tp = params
    dis = _port_pair(tp, quant="int8", spec_decode=True, spec_k=5)
    wq_pre = dis.prefill.params["layers"]["wq"]
    wq_dec = dis.decode.params["layers"]["wq"]
    assert wq_pre.q is wq_dec.q and wq_pre.scale is wq_dec.scale
    assert not dis.prefill.spec_decode and not dis.decode.spec_decode
    assert dis.prefill.quant == dis.decode.quant == "int8"


def test_warmup_builds_each_tier_its_own_steps(params):
    """The prefill tier builds prefill chunks only, the decode tier decode
    steps only, and the handoff copy once; traffic then builds nothing."""
    _, tp = params
    dis = _port_pair(tp)
    built = dis.warmup()
    widths = dis.decode._sched.width_buckets
    batches = dis.decode._sched.batch_buckets
    assert not dis.prefill._steps and sorted(dis.prefill._prefills) == widths
    assert not dis.decode._prefills
    assert len(dis.decode._steps) == len(batches) * len(widths)
    assert built == len(widths) + len(batches) * len(widths) + 1
    assert dis.warmup() == 0
    n_pre, n_dec = len(dis.prefill._prefills), len(dis.decode._steps)
    for t in mixed_prompts(47):
        dis.submit(t, max_new_tokens=5)
    drive(dis, 5)
    assert len(dis.prefill._prefills) == n_pre
    assert len(dis.decode._steps) == n_dec
    _clean(dis)


def test_release_is_idempotent_and_only_path_to_unref(params):
    """A payload holds its source blocks from detach until release; a
    second release is a no-op."""
    _, tp = params
    dis = _port_pair(tp)
    dis.submit(mixed_prompts(48, n=1)[0], max_new_tokens=4)
    dis.admit_from_queue()
    while not dis.prefill.outbox:
        dis.prefill.step()
    payload = dis.prefill.outbox[0]
    assert isinstance(payload, HandoffPayload)
    assert payload.nbytes == len(payload.blocks) * payload.block_bytes
    src = dis.prefill._alloc
    assert all(src.refcount(b) == 1 for b in payload.blocks)
    assert dis.prefill.queue_depth == 1
    drive(dis, 1)
    assert not dis.prefill.outbox and payload._released
    assert all(src.refcount(b) == 0 for b in payload.blocks)
    payload.release()
    src.check()


def test_payload_views(params):
    _, tp = params
    dis = _port_pair(tp)
    for t in mixed_prompts(49, n=3):
        dis.submit(t, max_new_tokens=3)
    drive(dis, 3)
    view = dis.payload()
    assert view["engine"] == "disagg" and view["outbox"] == 0
    assert view["handoff"]["requests"] == 3
    assert view["decode"]["handoff"]["requests"] == 3
    assert view["prefill"]["schedule"]["allocator"]["adopted_total"] == 0
    assert view["decode"]["schedule"]["allocator"]["adopted_total"] == \
        view["handoff"]["blocks"]
    assert dis.queue_depth == 0 and not dis._active.any()


# ---- chaos: prefill-replica-kill ----

def test_prefill_replica_kill_recovers():
    """The port's chaos scenario, ``grove_tpu_torch.chaos.scenario``'s
    ``run_prefill_replica_kill``: the decode tier holds live work, then the
    prefill tier ticks without the pump until a payload is stranded in its
    outbox, then the tier is replaced. The scenario asserts inside that the
    decode allocator is clean right after the kill and after the drain and
    that the tokens equal the mono engine's by request id; its report
    says every stranded payload was rescued. The report has the JAX
    scenario's keys, and the scheduling counts (which depend on the prompt
    lengths, not the weights) are JAX's."""
    from grove_tpu.chaos.scenario import run_prefill_replica_kill as jrun
    from grove_tpu_torch.chaos import run_prefill_replica_kill

    report = run_prefill_replica_kill(device="cpu")
    assert report["ok"] and report["tokens_bitwise_identical"]
    assert report["rescued"] >= report["outbox_at_kill"] > 0
    assert report["completed"] == report["prompts"] == 6
    assert report["decode_allocator"]["used"] == 0
    want = jrun()
    assert set(report) == set(want)
    for key in ("prompts", "max_new", "seed", "outbox_at_kill",
                "blocks_in_flight", "prefilling_at_kill",
                "decode_live_at_kill", "rescued", "completed"):
        assert report[key] == want[key], key
    assert {k: report["handoff"][k] for k in HANDOFF_COUNTS} == \
        {k: want["handoff"][k] for k in HANDOFF_COUNTS}


# ---- on the card ----

def test_pair_matches_mono_bf16_on_card():
    """Pair == mono over a bf16 model on the card: the kernels' rows do not
    depend on the batch or the table width, so adoption at other ticks than
    the mono engine's promotion leaves the greedy tokens unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(T_CFG, dtype=torch.bfloat16)
    tp = tllama.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    prompts = mixed_prompts(50, n=8)
    out = []
    for make in (tengine.PagedDecodeEngine, tengine.make_disagg):
        eng = make(cfg, tp, device="cuda", **GEOM)
        eng.warmup()
        for t in prompts:
            eng.submit(t, max_new_tokens=10)
        drive(eng, len(prompts))
        out.append(by_rid(eng))
    assert out[0] == out[1]
