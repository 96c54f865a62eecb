"""The port's flash attention: its plain version against the Pallas kernel
(interpret mode on the CPU), the prefill dispatch rules, the launch count,
and on a CUDA card the kernel against its plain version.

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_flash.py``); the Pallas
comparisons run on JAX's CPU platform, or skip where JAX is missing."""

import numpy as np
import pytest
import torch

from grove_tpu_torch.ops.attention import (active_prefill_attention,
                                           causal_attention,
                                           pick_causal_attention)
from grove_tpu_torch.ops.flash import (flash_causal_attention,
                                       flash_causal_attention_ref)

# Small shapes: one intra-op thread keeps these tests from crowding the
# timing-sensitive control-plane tests that run beside them in parallel.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pallas_flash():
    """The JAX package's Pallas kernel in interpret mode on JAX's CPU
    platform (a GPU JAX would take its f32 products at reduced precision),
    on numpy arrays."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    jnp = pytest.importorskip("jax.numpy")
    pallas = pytest.importorskip("grove_tpu.ops.pallas_flash")

    def run(q, k, v, bq, bk, dtype=None):
        return np.asarray(pallas.flash_causal_attention(
            *(jnp.asarray(x, dtype=dtype) for x in (q, k, v)), block_q=bq,
            block_k=bk, interpret=True).astype(jnp.float32))
    return run


def _qkv(seed, b, s, h, n_kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, n_kv, d)).astype(np.float32),
            rng.standard_normal((b, s, n_kv, d)).astype(np.float32))


# The shapes of tests/test_pallas_flash.py, at its bar (f32, 2e-5).
@pytest.mark.parametrize("b,s,h,n_kv,d,bq,bk", [
    (2, 64, 4, 2, 32, 16, 16),
    (1, 128, 8, 8, 16, 32, 64),   # MHA (group=1), uneven blocks
    (2, 32, 4, 1, 8, 32, 8),      # MQA, single q block
])
def test_plain_flash_matches_pallas_interpret(pallas_flash, b, s, h, n_kv,
                                             d, bq, bk):
    q, k, v = _qkv(0, b, s, h, n_kv, d)
    want = pallas_flash(q, k, v, bq, bk)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_causal_attention_ref(tq, tk, tv, block_k=bk).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # The wrapper takes the plain version for CPU tensors (its own blocks).
    np.testing.assert_allclose(flash_causal_attention(tq, tk, tv).numpy(),
                               want, rtol=2e-5, atol=2e-5)


def test_plain_flash_first_row_attends_self_only(pallas_flash):
    q, k, v = _qkv(1, 1, 16, 1, 1, 8)
    out = flash_causal_attention_ref(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), block_k=8)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), pallas_flash(q, k, v, 8, 8),
                               rtol=2e-5, atol=2e-5)


def test_plain_flash_ragged_length_matches_dense():
    """A length that does not tile into blocks masks its own edge."""
    q, k, v = _qkv(2, 2, 77, 6, 2, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(
        flash_causal_attention_ref(tq, tk, tv, block_k=32).numpy(),
        causal_attention(tq, tk, tv).numpy(), rtol=2e-5, atol=2e-5)


# ---- bfloat16: the plain version is the bf16 kernel's function ----

def _qkv_bf16(seed, b, s, h, n_kv, d):
    """Inputs made with numpy and rounded to bf16 once, as f32 arrays that
    both frameworks turn into the same bf16 values."""
    return tuple(torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                 for x in _qkv(seed, b, s, h, n_kv, d))


def _plain_bf16(q, k, v, **kw):
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_causal_attention_ref(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.fixture(scope="module")
def xla_attention():
    """The JAX package's XLA causal attention on bf16 inputs."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    jnp = pytest.importorskip("jax.numpy")
    attention = pytest.importorskip("grove_tpu.ops.attention")

    def run(q, k, v):
        return np.asarray(attention.causal_attention(
            *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
        ).astype(jnp.float32))
    return run


# Both outputs are rounded once to bf16 (one ulp is 2^-8 of the value), and
# the plain version also rounds P to bf16 (2^-9) before the P.V product,
# which the Pallas kernel's f32 product does not.
BF16_TOL = 2e-2


@pytest.mark.parametrize("b,s,h,n_kv,d,bq,bk", [
    (2, 64, 4, 2, 64, 32, 32),    # GQA, two q and two k blocks
    (1, 64, 4, 4, 8, 32, 16),     # MHA, d = 8, four k blocks
    (2, 32, 4, 1, 128, 32, 32),   # MQA, d = 128, one block
])
def test_plain_flash_bf16_matches_pallas_interpret(pallas_flash, b, s, h,
                                                  n_kv, d, bq, bk):
    q, k, v = _qkv_bf16(6, b, s, h, n_kv, d)
    want = pallas_flash(q, k, v, bq, bk, dtype="bfloat16")
    np.testing.assert_allclose(_plain_bf16(q, k, v, block_k=bk), want,
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("b,s,h,n_kv,d,bk", [
    (2, 77, 6, 2, 64, 32),        # GQA, ragged over three k blocks
    (1, 200, 4, 1, 128, 64),      # MQA, ragged over four k blocks
    (2, 96, 4, 4, 8, 32),         # MHA, d = 8
    (1, 130, 8, 2, 128, 128),     # GQA, ragged past one full block
])
def test_plain_flash_bf16_matches_xla(xla_attention, b, s, h, n_kv, d, bk):
    """Against the XLA formulation, which also rounds q * d^-0.5 to bf16
    before its f32-accumulated scores (a third rounding, within the same
    tolerance)."""
    q, k, v = _qkv_bf16(7, b, s, h, n_kv, d)
    np.testing.assert_allclose(_plain_bf16(q, k, v, block_k=bk),
                               xla_attention(q, k, v),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_flash_rounds_p_once_to_bf16():
    """P is rounded to bf16 for the P.V product while l keeps the f32 p:
    with equal scores over two keys, p = 1 for both and the output is the
    mean of the two v rows, rounded once."""
    q = torch.zeros((1, 2, 1, 8), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 1, 8), dtype=torch.bfloat16)
    v = torch.tensor([[1.0, 2.0, 3.0, -1.0, 0.5, 0.25, 8.0, -4.0],
                      [3.0, 2.0, 1.0, 1.0, 1.5, 0.75, 0.0, 4.0]],
                     dtype=torch.bfloat16).reshape(1, 2, 1, 8)
    out = flash_causal_attention_ref(q, k, v)
    torch.testing.assert_close(out[0, 1, 0].float(),
                               v[0].float().mean(dim=0)[0], rtol=0, atol=0)


def test_cpu_call_never_counts_a_launch():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 32, 2, 1, 8))
    before = flash_causal_attention.launches
    flash_causal_attention(q, k, v)
    assert flash_causal_attention.launches == before


def test_wrapper_rejects_mismatched_shapes():
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 32, 3, 2, 8))
    with pytest.raises(ValueError):
        flash_causal_attention(q, k, v)  # 3 heads do not group over 2


# ---- dispatch: a mirror of tests/test_attention_dispatch.py ----

@pytest.fixture
def flash_forced(monkeypatch):
    monkeypatch.setenv("GROVE_FLASH_ATTENTION", "1")


def test_selection_defaults_to_plain_off_cuda(monkeypatch):
    monkeypatch.delenv("GROVE_FLASH_ATTENTION", raising=False)
    assert active_prefill_attention(128, 64) == "plain"
    assert pick_causal_attention(128, 64, device="cpu") is None


def test_selection_on_cuda_tensors_picks_the_kernel(monkeypatch):
    monkeypatch.delenv("GROVE_FLASH_ATTENTION", raising=False)
    # Selection reads only the device type: no card is touched here.
    assert active_prefill_attention(128, 64, device="cuda") == "cuda-flash"


def test_selection_forced_off(monkeypatch):
    monkeypatch.setenv("GROVE_FLASH_ATTENTION", "0")
    assert pick_causal_attention(128, 64) is None
    assert pick_causal_attention(128, 64, device="cuda") is None


def test_selection_forced_on_uses_plain_flash_off_cuda(flash_forced):
    assert active_prefill_attention(128, 64) == "flash-plain"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_selection_rejects_unfit_shapes(flash_forced, device):
    # seq not tiling into full 128-blocks -> plain.
    assert pick_causal_attention(129, 64, device=device) is None
    assert pick_causal_attention(64, 64, device=device) is None
    # head_dim off the 8-grid -> plain.
    assert pick_causal_attention(128, 12, device=device) is None
    # chunked prefill (tensor or nonzero offset) -> plain.
    assert pick_causal_attention(128, 64, q_offset=torch.tensor(4),
                                 device=device) is None
    assert pick_causal_attention(128, 64, q_offset=4, device=device) is None


def test_flash_selected_prefill_matches_plain(flash_forced, monkeypatch):
    """Attention picked for prefill (plain flash here) equals the plain
    formulation on a prefill-shaped input."""
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 128, 8, 4, 8))
    attn = pick_causal_attention(128, 8)
    assert attn is not None
    np.testing.assert_allclose(attn(q, k, v).numpy(),
                               causal_attention(q, k, v).numpy(),
                               rtol=2e-5, atol=2e-5)


# ---- the kernel itself (needs a CUDA card) ----

@pytest.mark.parametrize("b,s,h,n_kv,d,dtype,tol", [
    (2, 64, 4, 2, 32, torch.float32, 1e-4),
    (3, 200, 8, 1, 64, torch.float32, 1e-4),
    (4, 128, 16, 8, 128, torch.bfloat16, 2e-2),
    (2, 128, 8, 8, 64, torch.bfloat16, 2e-2),    # MHA, d = 64
    (2, 64, 4, 2, 8, torch.bfloat16, 2e-2),      # d = 8
    (3, 200, 12, 4, 128, torch.bfloat16, 2e-2),  # ragged over 4 k tiles, g = 3
])
def test_kernel_matches_plain_on_cuda(b, s, h, n_kv, d, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, n_kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, n_kv, d), generator=gen, device="cuda").to(dtype)
    before = flash_causal_attention.launches
    out = flash_causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_causal_attention.launches == before + 1
    ref = flash_causal_attention_ref(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
