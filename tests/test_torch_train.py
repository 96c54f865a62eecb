"""The port's training path against the JAX package's on the same weights
(converted key for key) and the same tokens (numpy, from a seed): Llama's
and the dense MoE family's ``forward``, ``loss_fn`` and gradients
(``jax.grad``), three AdamW steps against ``optax.adamw(1e-3)``, the MoE
tests of tests/test_moe_checkpoint.py held against JAX, the load-balance
loss, ``train.entry`` against ``__graft_entry__.entry``, the parallel
argument rules that raise as JAX's, and every kernel wrapper refusing an input that
requires grad.

Tolerances, f32 at test-tiny and moe-test-tiny: logits 1e-4 (rtol and
atol; the frameworks order their sums differently), the loss 1e-5
relative, each gradient leaf 1e-4 relative to its max norm, the params
after three AdamW steps on JAX's gradients 1e-6 absolute, and after three
train steps 1e-4 absolute (but for elements whose first gradient is
rounding noise around zero: see that test). bf16: the logits to the
model-level bound max |diff| <= 5e-2 * max |logit| of
tests/test_torch_llama.py, the loss to 1e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from grove_tpu.models import llama as jllama
from grove_tpu.models import moe as jmoe
from grove_tpu.ops import attention as jattention
from grove_tpu.parallel.mesh import MeshPlan as JMeshPlan
from grove_tpu.parallel.mesh import build_mesh as jbuild_mesh
from grove_tpu_torch import train
from grove_tpu_torch.convert import params_from_numpy
from grove_tpu_torch.models import llama as tllama
from grove_tpu_torch.models import moe as tmoe
from grove_tpu_torch.ops import attention as tattention
from grove_tpu_torch.ops import flash, kvquant, norms, paged, w8a16
from grove_tpu_torch.parallel.mesh import Mesh, MeshPlan

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)

FAMILIES = {
    "llama": (jllama, tllama, jllama.CONFIGS["test-tiny"],
              tllama.CONFIGS["test-tiny"]),
    "moe": (jmoe, tmoe, jmoe.MOE_CONFIGS["moe-test-tiny"],
            tmoe.MOE_CONFIGS["moe-test-tiny"]),
}
B, S = 2, 32


def _cfgs(family, dtype="float32", **kw):
    _, _, jc, tc = FAMILIES[family]
    return (dataclasses.replace(jc, dtype=jnp.dtype(dtype), **kw),
            dataclasses.replace(tc, dtype=getattr(torch, dtype), **kw))


def _tokens(seed, vocab, b=B, s=S) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


def _port(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def case(request):
    """One family in f32: the JAX side's logits, loss, gradients and params
    after three AdamW steps, and the inputs."""
    jmod, tmod, _, _ = FAMILIES[request.param]
    jc, tc = _cfgs(request.param)
    jp = jmod.init_params(jc, jax.random.PRNGKey(0))
    toks = _tokens(1, jc.vocab_size)
    jt = jnp.asarray(toks)

    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_fn(jc, p, jt)))
    value, grads = value_and_grad(jp)
    tx = optax.adamw(1e-3)
    state, stepped, step_grads = tx.init(jp), jp, []
    for _ in range(3):
        g = value_and_grad(stepped)[1]
        step_grads.append(g)
        updates, state = tx.update(g, state, stepped)
        stepped = optax.apply_updates(stepped, updates)
    return dict(family=request.param, jmod=jmod, tmod=tmod, jc=jc, tc=tc,
                jp=jp, tokens=toks,
                logits=jax.jit(lambda p: jmod.forward(jc, p, jt))(jp),
                loss=float(value), grads=grads, step_grads=step_grads,
                stepped=stepped)


def test_forward_logits_match_jax(case):
    out = case["tmod"].forward(case["tc"], _port(case["jp"]),
                               torch.from_numpy(case["tokens"]))
    assert out.dtype == torch.float32
    assert out.shape == (B, S, case["tc"].vocab_size)
    np.testing.assert_allclose(_f32(out), _f32(case["logits"]),
                               rtol=1e-4, atol=1e-4)


def test_loss_matches_jax(case):
    loss = case["tmod"].loss_fn(case["tc"], _port(case["jp"]),
                                torch.from_numpy(case["tokens"]))
    assert loss.shape == ()
    assert abs(float(loss) - case["loss"]) <= 1e-5 * abs(case["loss"])


def test_every_gradient_leaf_matches_jax_grad(case):
    tp = _port(case["jp"])
    train.make_optimizer(tp)              # every leaf requires grad
    case["tmod"].loss_fn(case["tc"], tp,
                         torch.from_numpy(case["tokens"])).backward()
    leaves = jax.tree_util.tree_leaves_with_path(case["grads"])
    assert len(leaves) == len(train.param_leaves(tp))
    for path, g in leaves:
        tg = _leaf(tp, path).grad
        assert tg is not None, jax.tree_util.keystr(path)
        g = _f32(g)
        err = np.abs(_f32(tg) - g).max() / max(np.abs(g).max(), 1e-30)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


def test_adamw_matches_optax_on_the_same_gradients(case):
    """The optimizer alone: JAX's gradients of each of its three steps fed
    to the port's AdamW give optax's params to 1e-6."""
    tp = _port(case["jp"])
    opt = train.make_optimizer(tp, lr=1e-3)
    for g in case["step_grads"]:
        for path, leaf in jax.tree_util.tree_leaves_with_path(g):
            _leaf(tp, path).grad = torch.from_numpy(np.array(leaf))
        opt.step()
    for path, a in jax.tree_util.tree_leaves_with_path(case["stepped"]):
        np.testing.assert_allclose(_f32(_leaf(tp, path)), _f32(a), rtol=0,
                                   atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    # The moments stay in the params' dtype (optax's mu_dtype=None).
    for p in train.param_leaves(tp):
        st = opt.state[p]
        assert st["exp_avg"].dtype == p.dtype == st["exp_avg_sq"].dtype


def test_three_train_steps_match_optax(case):
    """Three ``train_step``s against three optax steps, each side on its
    own gradients: every param to 1e-4, but for the elements whose first
    gradient is zero within rounding on both sides (at most 1e-7 of its
    leaf's max norm: the gradient test holds leaves to 1e-4 of it). Adam's
    first update there is g / (|g| + 1e-8), rounding noise scaled by
    1e8, anywhere in [-lr, lr] on either side: those are held to 2 lr, and
    may be at most one in 1,000 of their leaf (or one element). A gradient
    that is exactly zero on both sides moves nothing: held to 1e-4."""
    tp = _port(case["jp"])
    opt = train.make_optimizer(tp, lr=1e-3)
    toks = torch.from_numpy(case["tokens"])
    losses, first = [], {}
    for i in range(3):
        losses.append(train.train_step(case["tc"], tp, opt, toks,
                                       loss=case["tmod"].loss_fn))
        if i == 0:
            first = {id(p): p.grad.clone() for p in train.param_leaves(tp)}
    assert all(not v.requires_grad for v in losses)
    assert abs(float(losses[0]) - case["loss"]) <= 1e-5 * case["loss"]
    g0 = dict(jax.tree_util.tree_leaves_with_path(case["step_grads"][0]))
    for path, a in jax.tree_util.tree_leaves_with_path(case["stepped"]):
        p = _leaf(tp, path)
        jg, tg = np.abs(_f32(g0[path])), np.abs(_f32(first[id(p)]))
        noise = ((jg <= 1e-7 * jg.max()) & (tg <= 1e-7 * jg.max())
                 & ((jg > 0) | (tg > 0)))
        err = np.abs(_f32(p) - _f32(a))
        name = jax.tree_util.keystr(path)
        assert err[~noise].max(initial=0) <= 1e-4, name
        assert err[noise].max(initial=0) <= 2e-3, name
        assert noise.sum() <= max(1, noise.size // 1000), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_forward_and_loss_within_the_model_bound(family):
    """bf16 weights and activations on both sides: the logits within the
    model-level bound and the loss within 1e-2 relative."""
    jmod, tmod, _, _ = FAMILIES[family]
    jc, tc = _cfgs(family, "bfloat16")
    jp = jmod.init_params(jc, jax.random.PRNGKey(3))
    toks = _tokens(4, jc.vocab_size)
    want = _f32(jmod.forward(jc, jp, jnp.asarray(toks)))
    got = tmod.forward(tc, _port(jp), torch.from_numpy(toks))
    assert got.dtype == torch.float32
    assert np.abs(_f32(got) - want).max() <= 5e-2 * np.abs(want).max()
    jl = float(jmod.loss_fn(jc, jp, jnp.asarray(toks)))
    tl = float(tmod.loss_fn(tc, _port(jp), torch.from_numpy(toks)))
    assert abs(tl - jl) <= 1e-2 * abs(jl)


def test_forward_takes_positions_as_jax():
    jc, tc = _cfgs("llama")
    jp = jllama.init_params(jc, jax.random.PRNGKey(5))
    toks = _tokens(6, jc.vocab_size)
    pos = np.broadcast_to(np.arange(7, 7 + S), (B, S)).astype(np.int32)
    want = jllama.forward(jc, jp, jnp.asarray(toks),
                          positions=jnp.asarray(pos))
    got = tllama.forward(tc, _port(jp), torch.from_numpy(toks),
                         positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


# ---- the MoE family (tests/test_moe_checkpoint.py's, held against JAX) ----


def test_moe_forward_shape_and_finite_as_jax():
    jc, tc = _cfgs("moe")
    jp = jmoe.init_params(jc, jax.random.PRNGKey(0))
    toks = _tokens(7, jc.vocab_size, 2, 16)
    want = jmoe.forward(jc, jp, jnp.asarray(toks))
    got = tmoe.forward(tc, _port(jp), torch.from_numpy(toks))
    assert got.shape == want.shape == (2, 16, tc.vocab_size)
    assert torch.isfinite(got).all() and bool(jnp.all(jnp.isfinite(want)))
    loss = tmoe.loss_fn(tc, _port(jp), torch.from_numpy(toks))
    assert torch.isfinite(loss)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_moe_routing_locality_as_jax():
    """Perturbing expert 0's weights changes only the tokens routed to it,
    the same tokens on both sides. One layer: with more, attention carries
    the change to every later token."""
    jc, tc = _cfgs("moe", n_layers=1)
    jp = jmoe.init_params(jc, jax.random.PRNGKey(0))
    toks = _tokens(8, jc.vocab_size, 1, 32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    mutated = dict(jp)
    mutated["layers"] = dict(jp["layers"])
    mutated["layers"]["we_down"] = jp["layers"]["we_down"].at[:, 0].mul(2.0)
    j_changed = np.any(np.asarray(jmoe.forward(jc, jp, jt))
                       != np.asarray(jmoe.forward(jc, mutated, jt)),
                       axis=-1)[0]
    tp = _port(jp)
    base = tmoe.forward(tc, tp, tt)
    tp["layers"]["we_down"][:, 0] *= 2.0
    t_changed = (tmoe.forward(tc, tp, tt) != base).any(dim=-1)[0].numpy()
    assert t_changed.any(), "no token used expert 0 at all (degenerate)"
    assert not t_changed.all(), "every token hit expert 0 (routing broken)"
    np.testing.assert_array_equal(t_changed, j_changed)


def test_router_load_balance_loss_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 16, 8)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1)[..., :2].astype(np.int32)
    want = float(jmoe.router_load_balance_loss(jnp.asarray(logits),
                                               jnp.asarray(idx), 8))
    got = tmoe.router_load_balance_loss(torch.from_numpy(logits),
                                        torch.from_numpy(idx), 8)
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    # Uniform routing is the least: E * sum(1/E * 1/E) = 1.
    flat = torch.zeros((1, 8, 8))
    uniform = torch.arange(8).reshape(1, 8, 1)
    assert float(tmoe.router_load_balance_loss(flat, uniform, 8)) == \
        pytest.approx(1.0)


def test_moe_init_params_shapes_and_no_dense_mlp():
    tc = tmoe.MOE_CONFIGS["moe-test-tiny"]
    gen = torch.Generator().manual_seed(0)
    tp = tmoe.init_params(tc, gen, device="cpu")
    jp = jmoe.init_params(dataclasses.replace(
        jmoe.MOE_CONFIGS["moe-test-tiny"]), jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    got = {k: ({n: (tuple(w.shape), str(w.dtype).removeprefix("torch."))
                for n, w in v.items()} if isinstance(v, dict)
               else (tuple(v.shape), str(v.dtype).removeprefix("torch.")))
           for k, v in tp.items()}
    assert got == want
    assert "w_gate" not in tp["layers"]


def test_moe_config_widths_are_jax():
    for name, jc in jmoe.MOE_CONFIGS.items():
        tc = tmoe.MOE_CONFIGS[name]
        want = {k: v for k, v in dataclasses.asdict(jc).items()
                if k != "dtype"}
        got = {k: v for k, v in dataclasses.asdict(tc).items()
               if k != "dtype"}
        assert got == want, name


# ---- entry points and options ----


def test_entry_forward_matches_graft_entry():
    """``train.entry()``'s forward on ``__graft_entry__.entry()``'s params
    and tokens (bf16, the flagship config) within the model-level bound,
    and its own params give finite logits of the same shape."""
    jfn, (jp, jt) = graft.entry()
    fn, (params, tokens) = train.entry(device="cpu")
    want = {k: v for k, v in dataclasses.asdict(graft._flagship_cfg()).items()
            if k != "dtype"}
    got = {k: v for k, v in dataclasses.asdict(
        train.flagship_config()).items() if k != "dtype"}
    assert got == want
    assert tuple(tokens.shape) == tuple(jt.shape)
    expect = _f32(jfn(jp, jt))
    out = _f32(fn(_port(jp), torch.from_numpy(np.array(jt))))
    assert np.abs(out - expect).max() <= 5e-2 * np.abs(expect).max()
    own = fn(params, tokens)
    assert own.shape == expect.shape and torch.isfinite(own).all()


def test_parallel_options_raise():
    """The argument rules that still raise, as they raise in JAX (its
    asserts, as AssertionError; an unknown strategy as ValueError): the ring
    with Ulysses, sp without a mesh, an unknown sp, custom positions under
    sp, and ``ep=True`` without an ep axis (or a mesh)."""
    jc, tc = _cfgs("llama")
    jmc, mc = _cfgs("moe")
    toks = np.zeros((1, 4), np.int32)
    jp = jllama.init_params(jc, jax.random.PRNGKey(0))
    jmp = jmoe.init_params(jmc, jax.random.PRNGKey(0))
    lp, mp = _port(jp), _port(jmp)
    pos = np.zeros((1, 4), np.int32)
    mesh = object()
    for exc, match, jcall, tcall in (
            (AssertionError, "conflicts",
             lambda t: jllama.forward(jc, jp, t, mesh=mesh, ring=True,
                                      sp="ulysses"),
             lambda t: tllama.forward(tc, lp, t, mesh=mesh, ring=True,
                                      sp="ulysses")),
            (AssertionError, "needs the mesh",
             lambda t: jllama.loss_fn(jc, jp, t, sp="ring"),
             lambda t: tllama.loss_fn(tc, lp, t, sp="ring")),
            (AssertionError, "needs the mesh",
             lambda t: jllama.forward(jc, jp, t, ring=True),
             lambda t: tllama.forward(tc, lp, t, ring=True)),
            (ValueError, "unknown sp strategy",
             lambda t: jllama.loss_fn(jc, jp, t, mesh=mesh, sp="megatron"),
             lambda t: tllama.loss_fn(tc, lp, t, mesh=mesh, sp="megatron")),
            (AssertionError, "custom positions",
             lambda t: jllama.forward(jc, jp, t, jnp.asarray(pos), mesh=mesh,
                                      sp="ulysses"),
             lambda t: tllama.forward(tc, lp, t, torch.from_numpy(pos),
                                      mesh=mesh, sp="ulysses")),
            (AssertionError, "ep path needs the mesh",
             lambda t: jmoe.forward(jmc, jmp, t, ep=True),
             lambda t: tmoe.forward(mc, mp, t, ep=True)),
            (AssertionError, "no ep axis",
             lambda t: jmoe.loss_fn(
                 jmc, jmp, t, ep=True,
                 mesh=jbuild_mesh(JMeshPlan(dp=2), jax.devices()[:2])),
             lambda t: tmoe.loss_fn(mc, mp, t, ep=True,
                                    mesh=Mesh(MeshPlan(dp=2))))):
        with pytest.raises(exc, match=match) as jerr:
            jcall(jnp.asarray(toks))
        with pytest.raises(exc, match=match) as terr:
            tcall(torch.from_numpy(toks))
        assert str(terr.value) == str(jerr.value)


def test_make_optimizer_has_optax_defaults():
    tc = _cfgs("llama")[1]
    tp = tllama.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    opt = train.make_optimizer(tp)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(train.param_leaves(tp))
    assert all(p.requires_grad for p in train.param_leaves(tp))


def test_softmax_max_is_detached_as_jax_stop_gradient():
    """A row whose max ties between two keys (duplicated keys): the port's
    gradients equal JAX's, and equal bitwise the same formulation with the
    max taken as a constant (no gradient path through it)."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((1, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    k[:, 1] = k[:, 0]                     # keys 0 and 1 tie for every query
    v = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    w = rng.standard_normal((1, 6, 4, 8)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattention.causal_attention(q, k, v) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    def grads(attn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        (attn(*ts) * torch.from_numpy(w)).sum().backward()
        return [t.grad for t in ts]

    def constant_max(q, k, v):
        qg = q.reshape(1, 6, 2, 2, 8)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg * 8 ** -0.5, k)
        mask = torch.arange(6)[:, None] >= torch.arange(6)[None, :]
        logits = torch.where(mask, logits, tattention.NEG_INF)
        m = logits.detach().amax(dim=-1, keepdim=True)
        probs = torch.exp(logits - m)
        probs = probs / probs.sum(dim=-1, keepdim=True)
        return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(
            1, 6, 4, 8)

    tg = grads(tattention.causal_attention)
    for a, b in zip(tg, grads(constant_max)):
        assert torch.equal(a, b)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


# ---- the kernel wrappers refuse inputs that require grad ----


def _wrapper_calls():
    """Each kernel wrapper with valid CPU inputs; ``rg`` marks the input
    that requires grad."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    b, s, h, n_kv, d, nb, bs, w = 2, 4, 4, 2, 8, 6, 4, 2
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    positions = torch.tensor([[0, 1, 2, 3], [2, 3, 4, 5]], dtype=torch.int32)
    cos, sin = torch.ones(16, d // 2), torch.zeros(16, d // 2)

    def pools():
        return randn(nb, bs, n_kv, d), randn(nb, bs, n_kv, d)

    def q8_pools():
        return (torch.zeros(nb, bs, n_kv, d, dtype=torch.int8),
                torch.zeros(nb, bs, n_kv, d, dtype=torch.int8),
                torch.ones(nb, bs, n_kv), torch.ones(nb, bs, n_kv))

    qi = torch.zeros(16, 8, dtype=torch.int8)
    sc = torch.ones(8, dtype=torch.bfloat16)
    return {
        "flash_causal_attention": lambda rg: flash.flash_causal_attention(
            rg(randn(b, 8, h, d)), randn(b, 8, n_kv, d), randn(b, 8, n_kv, d)),
        "rms_norm": lambda rg: norms.rms_norm(rg(randn(3, d)), torch.ones(d)),
        "add_rms_norm": lambda rg: norms.add_rms_norm(
            randn(3, d), rg(randn(3, d)), torch.ones(d)),
        "paged_decode_attention": lambda rg: paged.paged_decode_attention(
            rg(randn(b, 1, h, d)), *pools(), tables, lengths),
        "paged_chunk_attention": lambda rg: paged.paged_chunk_attention(
            rg(randn(b, s, h, d)), *pools(), tables, offsets),
        "paged_decode_attention_q8": lambda rg:
            paged.paged_decode_attention_q8(rg(randn(b, 1, h, d)),
                                            *q8_pools(), tables, lengths),
        "paged_chunk_attention_q8": lambda rg:
            paged.paged_chunk_attention_q8(rg(randn(b, s, h, d)),
                                           *q8_pools(), tables, offsets),
        "paged_rope_scatter": lambda rg: kvquant.paged_rope_scatter(
            *pools(), randn(b, s, h, d), rg(randn(b, s, n_kv, d)),
            randn(b, s, n_kv, d), cos, sin, tables, positions),
        "paged_rope_scatter_q": lambda rg: kvquant.paged_rope_scatter_q(
            *q8_pools(), rg(randn(b, s, h, d)), randn(b, s, n_kv, d),
            randn(b, s, n_kv, d), cos, sin, tables, positions),
        "paged_scatter": lambda rg: kvquant.paged_scatter(
            *pools(), randn(b, s, n_kv, d), rg(randn(b, s, n_kv, d)), tables,
            positions),
        "paged_scatter_q": lambda rg: kvquant.paged_scatter_q(
            *q8_pools(), rg(randn(b, s, n_kv, d)), randn(b, s, n_kv, d),
            tables, positions),
        "w8a16_matmul_group": lambda rg: w8a16.w8a16_matmul_group(
            rg(randn(3, 16, dtype=torch.bfloat16)), [(qi, sc), (qi, sc)]),
        "w8a16_matmul": lambda rg: w8a16.w8a16_matmul(
            randn(3, 16, dtype=torch.bfloat16), qi, rg(sc.clone())),
        "dense_matmul_group": lambda rg: w8a16.dense_matmul_group(
            randn(3, 16), [randn(16, 8), rg(randn(16, 8))]),
        "dense_matmul": lambda rg: w8a16.dense_matmul(
            rg(randn(3, 16)), randn(16, 8)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrapper_raises_on_an_input_that_requires_grad(name):
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(lambda t: t.requires_grad_(True))
    call(lambda t: t)                     # the same call without grad runs
    with torch.no_grad():                 # and so does it under no_grad
        call(lambda t: t.requires_grad_(True))
