"""Tensor-parallel serving on the CPU: the port's paged engine, spec and the
disaggregated pair under a tp mesh over gloo worlds of 2 and 4 processes
(tests/torch_tp_worlds.py runs the ranks), against the JAX package's
``PagedDecodeEngine`` under ``build_mesh(MeshPlan(tp=t), jax.devices()[:t])``
and against the port at tp = 1, on test-tiny in f32 with
tools/decode_smoke.py's workload served twice.

- greedy tokens by request id equal JAX's tp = t engine's and the port's
  tp = 1 tokens, with f32 weights, int8 weights and an int8 pool;
- ``prefill_chunk_paged`` and ``decode_step_paged`` logits from each rank's
  slices agree with JAX's full-width ones within f32 1e-4 (the ranks sum
  partial products in another order), are the same on every rank, and
  each forward runs 2 n_layers + 2 collectives. With int8 weights JAX's
  functions run over the dequantized weights (``materialize()``, the
  values the port's W8A16 product uses): JAX's own int8 run of these
  functions differs from that by about 2e-2 at test-tiny in f32, since
  XLA lowers the mixed bf16/f32 products inside its layer scan at lower
  precision, while the port's differs from it by about 2e-6;
- the sampled path chooses the same tokens on every rank; spec self-draft
  equals greedy bitwise; prefix cache off equals on; the pair equals mono;
  each rank's pools hold n_kv / tp heads;
- test-tiny's tiny draft has one kv head, so it cannot shard: the port
  raises at tp = 2 as JAX does (JAX by an assert);
- checkpoints of tp engines and pairs: one step of rank files that loads
  as the whole model, bitwise the unsharded params and what orbax
  restores from JAX's tp engine; A -> B -> A restarts; steps of the other
  world's plan and of one CPU restored, and the other way round; a save
  that dies on one rank leaves no step; a restart into another shape
  raises on every rank before anything is written.

The two worlds run once, together, from a module fixture; a hung
collective fails the fixture at its time limit instead of stalling the
suite."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worlds as worlds
from grove_tpu.models import llama as jllama
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu.serving import engine as jengine
from grove_tpu.serving import quant as jquant
from grove_tpu.serving.kvcache import PagedKV as JPagedKV
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.serving import checkpoint as ckpt
from grove_tpu_torch.serving import engine as tengine

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)

J_CFG = dataclasses.replace(jllama.CONFIGS["test-tiny"], dtype=jnp.float32,
                            max_seq_len=64)
T_CFG = dataclasses.replace(tllama.CONFIGS["test-tiny"], dtype=torch.float32,
                            max_seq_len=64)
TPS = (2, 4)
# Scenarios held against the JAX engine under the same mesh.
JAX_SCENARIOS = ("greedy", "int8_weights", "int8_kv")
TOL = 1e-4


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(J_CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def runs(jparams, tparams, tmp_path_factory):
    """Both gloo worlds, run at once: {tp: [rank results], "dirs": {tp:
    the world's directory}}. Each world's directory holds the params and
    two steps saved on one CPU: ``one/`` (A in f32) and ``one_q/`` (B in
    int8)."""
    from grove_tpu_torch.serving.quant import quantize_params
    dirs = {}
    for t in TPS:
        d = tmp_path_factory.mktemp(f"tp{t}")
        worlds.save_params(str(d / "params.npz"),
                           jax.tree.map(np.asarray, jparams))
        ckpt.save_params(str(d / "one"), tparams)
        ckpt.save_params(str(d / "one_q"),
                         quantize_params(worlds.other_params()))
        dirs[t] = str(d)
    out = worlds.run_worlds(dirs, timeout=240)
    out["dirs"] = dirs
    return out


def _knobs(name):
    kw = dict(worlds.SERVED[name])
    quant = kw.pop("quant", None)
    return kw, quant


@pytest.fixture(scope="module")
def jax_tokens(jparams):
    """JAX's engine under a tp = t mesh, each scenario: {(t, name): ...}."""
    out = {}
    for t in TPS:
        mesh = jbuild_mesh(JMeshPlan(tp=t), jax.devices()[:t])
        for name in JAX_SCENARIOS:
            kw, quant = _knobs(name)
            eng = jengine.PagedDecodeEngine(
                J_CFG, jparams, mesh=mesh, quant=quant, xprof=False,
                reqtrace=False, **worlds.GEOM, **kw)
            out[t, name] = worlds.serve_twice(eng)
    return out


@pytest.fixture(scope="module")
def tp1_tokens(tparams):
    """The port at tp = 1 (no mesh), in this process."""
    out = {}
    for name in JAX_SCENARIOS + ("spec_self",):
        kw, quant = _knobs(name)
        eng = tengine.PagedDecodeEngine(T_CFG, tparams, quant=quant,
                                        device="cpu", xprof=False,
                                        reqtrace=False, **worlds.GEOM, **kw)
        out[name] = worlds.serve_twice(eng)
    return out


def _tokens(res):
    return {int(k): v for k, v in res["tokens"].items()}


def _ranks_agree(ranks, get):
    vals = [get(r) for r in ranks]
    assert all(v == vals[0] for v in vals[1:])
    return vals[0]


# ---- served tokens ----

@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("name", JAX_SCENARIOS)
def test_tokens_equal_jax_tp_engine(runs, jax_tokens, t, name):
    got = _ranks_agree(runs[t], lambda r: _tokens(r["served"][name]))
    assert got == jax_tokens[t, name]
    assert sorted(got) == list(range(2 * len(worlds.PROMPT_LENS)))
    assert all(len(v) == worlds.MAX_NEW for v in got.values())


@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("name", JAX_SCENARIOS + ("spec_self",))
def test_tokens_equal_port_at_tp1(runs, tp1_tokens, t, name):
    got = _ranks_agree(runs[t], lambda r: _tokens(r["served"][name]))
    assert got == tp1_tokens[name]


@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("name", ("prefix_off", "spec_self", "disagg"))
def test_variant_equals_greedy_under_the_mesh(runs, t, name):
    """Prefix cache off, spec self-draft and the disaggregated pair give the
    greedy engine's tokens bitwise under the same mesh."""
    for r in runs[t]:
        assert _tokens(r["served"][name]) == _tokens(r["served"]["greedy"])


@pytest.mark.parametrize("t", TPS)
def test_sampled_tokens_equal_on_every_rank(runs, t):
    got = _ranks_agree(runs[t], lambda r: _tokens(r["served"]["sampled"]))
    assert all(len(v) == worlds.MAX_NEW for v in got.values())
    assert got != _tokens(runs[t][0]["served"]["greedy"])


@pytest.mark.parametrize("t", TPS)
def test_each_rank_pool_holds_its_heads(runs, t):
    n_kv, L, d = T_CFG.n_kv_heads // t, T_CFG.n_layers, T_CFG.head_dim
    nb = worlds.GEOM["batch"] * -(-worlds.GEOM["max_len"]
                                  // worlds.GEOM["block_size"]) + 1
    bs = worlds.GEOM["block_size"]
    for r in runs[t]:
        s = r["served"]
        assert s["greedy"]["pool"] == [L, nb, bs, n_kv, d]
        assert s["int8_kv"]["pool"] == [L, nb, bs, n_kv, d]
        assert s["int8_kv"]["scale"] == [L, nb, bs, n_kv]
        assert not s["spec_self"]["draft_pool"]
        assert s["disagg"]["pools"] == [[L, nb, bs, n_kv, d]] * 2
        assert s["disagg"]["shared_params"]
    assert [r["tp_rank"] for r in runs[t]] == list(range(t))


@pytest.mark.parametrize("t", TPS)
def test_tiny_draft_cannot_shard_one_kv_head(runs, t, jparams, tparams):
    """test-tiny's draft has n_kv = 1: both packages refuse it under tp > 1
    (the port with ValueError, JAX with its assert) and serve it at tp = 1."""
    for r in runs[t]:
        assert "draft n_kv_heads 1 must divide" in r["served"]["spec_tiny"]
    with pytest.raises(AssertionError, match="draft n_kv_heads"):
        jengine.PagedDecodeEngine(
            J_CFG, jparams, spec_decode=True, xprof=False, reqtrace=False,
            mesh=jbuild_mesh(JMeshPlan(tp=t), jax.devices()[:t]),
            **worlds.GEOM)
    eng = tengine.PagedDecodeEngine(T_CFG, tparams, spec_decode=True,
                                    device="cpu", xprof=False,
                                    reqtrace=False, **worlds.GEOM)
    assert eng.draft_kv is not None


# ---- the model functions ----

def _materialized(tree):
    """An int8 tree's dequantized weights, as f32 dense leaves."""
    return {k: _materialized(v) if isinstance(v, dict)
            else v.materialize().astype(jnp.float32)
            if isinstance(v, jquant.QTensor) else v
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_logits(jparams):
    """JAX's chunk and decode logits at full width, each variant."""
    chunk, step = worlds.logit_inputs()
    tables = jnp.asarray(worlds.TABLES, jnp.int32)
    out = {}
    for variant in worlds.LOGIT_VARIANTS:
        p = (_materialized(jquant.quantize_params(jparams))
             if variant == "int8_weights" else jparams)
        kv = JPagedKV.create(J_CFG.n_layers, worlds.NB, worlds.BS,
                             J_CFG.n_kv_heads, J_CFG.head_dim, J_CFG.dtype,
                             quant="int8" if variant == "int8_kv" else "off")
        pools = (kv.k, kv.v)
        scales = ({} if kv.k_scale is None
                  else dict(k_scale=kv.k_scale, v_scale=kv.v_scale))
        got = jllama.prefill_chunk_paged(
            J_CFG, p, jnp.asarray(chunk), *pools, tables,
            jnp.int32(0), jnp.int32(worlds.CHUNK - 1), **scales)
        c_logits, rest = got[0], got[1:]
        pools = rest[:2]
        if scales:
            scales = dict(k_scale=rest[2], v_scale=rest[3])
        s_logits = jllama.decode_step_paged(
            J_CFG, p, jnp.asarray(step), *pools, tables,
            jnp.full((2,), worlds.CHUNK, jnp.int32), **scales)[0]
        out[variant] = (np.asarray(c_logits), np.asarray(s_logits))
    return out


@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("variant", worlds.LOGIT_VARIANTS)
def test_paged_logits_match_jax(runs, jax_logits, t, variant):
    want_chunk, want_step = jax_logits[variant]
    got_chunk = _ranks_agree(runs[t], lambda r: r["logits"][variant]["chunk"])
    got_step = _ranks_agree(runs[t], lambda r: r["logits"][variant]["step"])
    np.testing.assert_allclose(np.asarray(got_chunk, np.float32), want_chunk,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.asarray(got_step, np.float32), want_step,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", TPS)
def test_collectives_per_forward(runs, t):
    """The embedding's sum, two sums per layer and the logits' gather."""
    for r in runs[t]:
        for variant in worlds.LOGIT_VARIANTS:
            assert r["logits"][variant]["collectives"] == \
                [2 * T_CFG.n_layers + 2] * 2


def test_mesh_axes_over_a_world_of_four(runs):
    """``build_mesh(MeshPlan(dp=2, tp=2))`` over the world of 4: rank r
    sits at dp = r // 2, tp = r % 2; the dp group sums ranks {0, 2} and
    {1, 3}, the tp group {0, 1} and {2, 3}, and the tp gather joins in
    rank order; an axis of size 1 has no group."""
    for r, res in enumerate(runs[4]):
        m = res["mesh"]
        assert m["coords"] == {"dp": r // 2, "pp": 0, "ep": 0, "sp": 0,
                               "tp": r % 2}
        assert m["sizes"] == {"dp": 2, "tp": 2}
        assert m["dp_sum"] == [float((r % 2 + 1) + (r % 2 + 3))] * 2
        lo = r - r % 2
        assert m["tp_sum"] == [float(lo + 1 + lo + 2)] * 2
        assert m["tp_gather"] == [[lo + 1.0, lo + 1.0, lo + 2.0, lo + 2.0]]


# ---- checkpoints of a tp engine ----

def _flat(tree):
    """Leaves by path; a ``QTensor`` (or the dict JAX's restore makes of
    one) as ``path/q`` and ``path/scale``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _flat(v).items()})
        elif hasattr(v, "q"):
            out[f"{k}/q"], out[f"{k}/scale"] = v.q, v.scale
        else:
            out[k] = v
    return out


def _assert_bitwise(got, want):
    got, want = _flat(got), _flat(want)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def _step_dir(runs, t, name):
    return os.path.join(runs["dirs"][t], "ckpt", name)


@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("name", ("mono", "pair", "int8"))
def test_tp_step_holds_the_whole_model(runs, tparams, t, name):
    """A tp engine, a tp pair (through its disruption responder) and an
    int8 tp engine each save exactly one step, collectively: each rank's
    slices in ``rank{r}.pt`` and the plan in the manifest. Loaded without
    ``like``, it is bitwise the unsharded params (quantized where the
    engine quantized them)."""
    from grove_tpu_torch.serving.quant import quantize_params
    for r in runs[t]:
        assert r["checkpoints"]["written"][name] == ["0"]
    d = os.path.join(_step_dir(runs, t, name), "0")
    assert sorted(os.listdir(d)) == sorted(
        ["manifest.json"] + [f"rank{i}.pt" for i in range(t)])
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["plan"]["tp"] == t
    want = quantize_params(tparams) if name == "int8" else tparams
    _assert_bitwise(ckpt.load_params(_step_dir(runs, t, name), 0,
                                     device="cpu"), want)


@pytest.fixture(scope="module")
def jax_restored(jparams, tmp_path_factory):
    """What JAX's orbax round trip restores from its tp = t engine's
    ``save_engine``, carried across with ``params_from_numpy``."""
    from grove_tpu.serving import checkpoint as jckpt
    out = {}
    for t in TPS:
        mesh = jbuild_mesh(JMeshPlan(tp=t), jax.devices()[:t])
        for quant in (None, "int8"):
            eng = jengine.PagedDecodeEngine(
                J_CFG, jparams, mesh=mesh, quant=quant, xprof=False,
                reqtrace=False, **worlds.GEOM)
            path = str(tmp_path_factory.mktemp(f"jax{t}{quant}"))
            step = int(os.path.basename(jckpt.save_engine(path, eng)))
            back = jckpt.load_params(path, step)
            out[t, quant] = params_from_numpy(jax.tree.map(np.asarray, back),
                                              device="cpu")
    return out


@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("quant", (None, "int8"))
def test_tp_step_equals_jax_orbax_restore(runs, jax_restored, t, quant):
    """The port's whole tree from the tp world's step is, leaf for leaf and
    bit for bit, what orbax restores from JAX's tp engine's save."""
    name = "int8" if quant else "mono"
    got = ckpt.load_params(_step_dir(runs, t, name), 0, device="cpu")
    _assert_bitwise(got, jax_restored[t, quant])


@pytest.mark.parametrize("t", TPS)
@pytest.mark.parametrize("kind", ("mono", "pair"))
def test_tp_warm_restart_a_b_a(runs, t, kind):
    """A -> B -> A into a live tp engine (and a live tp pair): the tokens
    after each restart are bitwise those of fresh tp engines on B and on
    A, on every rank."""
    for r in runs[t]:
        c = r["checkpoints"]
        fresh_a = c["fresh"]["a" if kind == "mono" else "pair_a"]
        assert c["restarts"][kind] == [[0, c["fresh"]["b"]], [0, fresh_a]]
        assert c["fresh"]["a"] != c["fresh"]["b"]


@pytest.mark.parametrize("t", TPS)
def test_tp_restores_the_other_plans_step(runs, t):
    """A step saved by the other world's plan (tp = 2 or 4), f32 and int8,
    restores into this world's live engines: the tokens are bitwise those
    of fresh engines here on the same weights."""
    (peer,) = [d for w, d in runs["dirs"].items() if w != t]
    for r in runs[t]:
        c = r["checkpoints"]
        assert c["across"][peer] == [c["fresh"]["b"], c["fresh"]["q_a"]]


@pytest.mark.parametrize("t", TPS)
def test_tp_restores_a_one_card_step(runs, t):
    """A step saved on one CPU (f32 weights A, int8 weights B) restores into
    the tp engines bitwise."""
    for r in runs[t]:
        c = r["checkpoints"]
        assert c["one_card"] == [c["fresh"]["a"], c["fresh"]["q_b"]]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _one_cpu_tokens(params, quant=None):
    eng = tengine.PagedDecodeEngine(T_CFG, params, quant=quant, device="cpu",
                                    xprof=False, reqtrace=False,
                                    **worlds.GEOM)
    return eng, worlds.serve_once(eng)


@pytest.mark.parametrize("t", TPS)
def test_one_cpu_engine_restores_a_tp_step(runs, tparams, t):
    """The other way round: the tp world's steps (weights B in f32, A in
    int8) restore into one-CPU engines built on other weights, whose tokens
    then equal one-CPU engines built on the same weights, and the tp
    world's own."""
    b = worlds.other_params()
    # The engine keeps the caller's tensors, and a restart writes them.
    eng, _ = _one_cpu_tokens(_clone(tparams))
    assert ckpt.warm_restart(_step_dir(runs, t, "b"), eng) == 0
    got = worlds.serve_once(eng)
    assert got == _one_cpu_tokens(b)[1] == runs[t][0]["checkpoints"][
        "fresh"]["b"]
    eng, _ = _one_cpu_tokens(b, "int8")
    ckpt.warm_restart(_step_dir(runs, t, "int8"), eng)
    got = worlds.serve_once(eng)
    assert got == _one_cpu_tokens(tparams, "int8")[1] == runs[t][0][
        "checkpoints"]["fresh"]["q_a"]


@pytest.mark.parametrize("t", TPS)
def test_half_written_tp_step_is_not_counted(runs, t):
    """A save whose file dies half way on rank 1 raises on every rank
    (rank 1 its own error, the others that a rank failed) and leaves no
    step; the collective retry commits step 0 and no temporary
    directory is left."""
    for r in runs[t]:
        h = r["checkpoints"]["half"]
        if r["rank"] == 1:
            assert h["error"] == ["OSError", "disk full"]
        else:
            assert h["error"][0] == "RuntimeError"
            assert "another rank could not write" in h["error"][1]
        assert h["latest"] is None
        assert h["retry"] == ["0"]


@pytest.mark.parametrize("t", TPS)
def test_tp_restart_into_another_shape_raises_on_every_rank(runs, t):
    """A restart into engines of another shape raises on every rank before
    anything is written: where every rank's engine differs (ValueError on
    each), and where only rank 0's does (the others match, and raise
    without writing)."""
    for r in runs[t]:
        s = r["checkpoints"]["another_shape"]
        assert s["every"] == {"error": "ValueError", "unchanged": True}
        want = "ValueError" if r["rank"] == 0 else "RuntimeError"
        assert s["rank0"] == {"error": want, "unchanged": True}


def test_same_plan_reads_only_its_rank_file(runs, tparams, tmp_path):
    """``like=`` a rank's slices of the plan that wrote the step reads that
    rank's file alone; another plan's slices that overlap the missing
    rank's need its file."""
    from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from grove_tpu_torch.parallel.sharding import shard_params
    src = os.path.join(_step_dir(runs, 2, "mono"), "0")
    dst = tmp_path / "ck"
    shutil.copytree(src, dst / "0")
    os.remove(dst / "0" / "rank0.pt")
    like = shard_params(Mesh(MeshPlan(tp=2), rank=1), tparams)
    got = ckpt.load_params(str(dst), 0, like=like)
    assert got.layout == like.layout
    _assert_bitwise(got, like)
    with pytest.raises(FileNotFoundError):
        ckpt.load_params(str(dst), 0, like=shard_params(
            Mesh(MeshPlan(tp=4), rank=0), tparams))


@pytest.mark.parametrize("name", ("mono", "int8"))
@pytest.mark.parametrize("rank", (0, 1, 2, 3))
def test_another_plan_reads_only_the_overlapping_files(runs, tparams,
                                                       tmp_path, name, rank):
    """A tp = 4 rank restoring the tp = 2 world's step reads only the file
    whose blocks overlap its own (ranks 0 and 1 rank0.pt, ranks 2 and 3
    rank1.pt, replicated leaves included), and gets its slices bitwise; a
    whole-tree load needs every file."""
    from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from grove_tpu_torch.parallel.sharding import shard_params
    from grove_tpu_torch.serving.quant import quantize_params
    src = os.path.join(_step_dir(runs, 2, name), "0")
    dst = tmp_path / "ck"
    shutil.copytree(src, dst / "0")
    os.remove(dst / "0" / f"rank{1 - rank // 2}.pt")
    whole = quantize_params(tparams) if name == "int8" else tparams
    like = shard_params(Mesh(MeshPlan(tp=4), rank=rank), whole)
    got = ckpt.load_params(str(dst), 0, like=like)
    assert got.layout == like.layout
    _assert_bitwise(got, like)
    with pytest.raises(FileNotFoundError):
        ckpt.load_params(str(dst), 0, device="cpu")


@pytest.mark.parametrize("kw", (dict(dp=2, tp=2), dict(sp=2, tp=2),
                                dict(pp=2), dict(dp=2)), ids=str)
def test_only_a_tp_only_plan_is_checkpointed(tparams, tmp_path, kw):
    """An engine cut for a plan with dp, pp, ep or sp above 1 is refused by
    ``engine_responder`` at registration and by ``save_engine`` and
    ``warm_restart``, before anything is written."""
    import types

    from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from grove_tpu_torch.parallel.sharding import shard_params
    eng = types.SimpleNamespace(params=shard_params(
        Mesh(MeshPlan(**kw), rank=0), tparams))
    for call in (lambda: ckpt.engine_responder(eng, str(tmp_path)),
                 lambda: ckpt.save_engine(str(tmp_path), eng),
                 lambda: ckpt.warm_restart(str(tmp_path), eng, step=0)):
        with pytest.raises(ValueError, match="tp-only"):
            call()
    assert os.listdir(tmp_path) == []


# ---- in process ----

def test_a_mesh_without_its_group_is_refused(tparams):
    """No quiet tp = 1: a tp = 2 layout with no process group raises, and
    so does a tree sharded for another rank."""
    from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from grove_tpu_torch.parallel.sharding import shard_params
    with pytest.raises(ValueError, match="process group"):
        tengine.PagedDecodeEngine(T_CFG, tparams, device="cpu",
                                  mesh=Mesh(MeshPlan(tp=2)), **worlds.GEOM)
    other = shard_params(Mesh(MeshPlan(tp=2), rank=1), tparams)
    with pytest.raises(ValueError, match="sharded for"):
        tengine._sharded(Mesh(MeshPlan(tp=2), rank=0), other, None,
                         torch.device("cpu"))


def _leaves(tree):
    from grove_tpu_torch.serving.quant import flatten_params
    return flatten_params(tree)[0]


@pytest.mark.parametrize("quant", (None, "int8"))
def test_host_params_reach_the_device_as_the_rank_slices(tparams, quant):
    """Params in host memory are quantized and cut where they are, and only
    the rank's slices are moved to the engine's device (here ``meta``, a
    device other than the params'): every leaf there has its slice's shape,
    and the caller's tree is left as it was."""
    from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from grove_tpu_torch.parallel.sharding import shard_params
    from grove_tpu_torch.serving.quant import quantize_params
    before = {k: v.clone() for k, v in _leaves(tparams).items()}
    mesh = Mesh(MeshPlan(tp=2), rank=1)
    got = tengine._sharded(mesh, tparams, quant, torch.device("meta"))
    full = quantize_params(tparams) if quant else tparams
    want = _leaves(shard_params(mesh, full))
    got = _leaves(got)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta" and t.shape == want[k].shape, k
        assert t.dtype == want[k].dtype, k
    assert got["layers/wq" + ("/q" if quant else "")].shape[2] == \
        T_CFG.n_heads // 2
    for k, t in _leaves(tparams).items():
        assert t.device.type == "cpu" and torch.equal(t, before[k]), k


def test_params_on_the_engine_device_are_the_callers(tparams):
    """At tp = 1 on the params' own device nothing is copied: the engine
    keeps the caller's tensors."""
    got = tengine._sharded(tengine.single_device_mesh(), tparams, None,
                           torch.device("cpu"))
    assert got is tparams

