"""The rms_norm wrapper (grove_tpu_torch/ops/norms.py) without the JAX
package: its routing and checks on the CPU, and on a CUDA card the kernel
against its plain version and each row's bits independent of how many rows
the call holds (what speculative decoding's verify chunk rests on).

On the machine with the card this file runs without the repo's conftest
(``python -m pytest --noconftest tests/test_torch_rms_norm.py``).
Tolerances: f32 1e-5 (another order of the row's sum); bf16 one output
ulp, 2^-7 relative (a sum in another order may move a value across a
rounding boundary). The row property is bitwise.
"""

import pytest
import torch

from grove_tpu_torch.ops import norms

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(7, 64), (2, 3, 2048), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_the_plain_version_and_counts_no_launch(shape, dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=gen) * 3).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1:], generator=gen)).to(dtype)
    before = norms.rms_norm.launches
    out = norms.rms_norm(x, w, 1e-5)
    assert torch.equal(out, norms.rms_norm_ref(x, w, 1e-5))
    assert out.dtype == dtype and out.shape == x.shape
    assert norms.rms_norm.launches == before


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="weight"):
        norms.rms_norm(x, torch.ones(4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        norms.rms_norm(x.to("meta"), torch.ones(8, device="meta"))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.parametrize("rows,d,xt,wt", [
    (32, 2048, torch.bfloat16, torch.bfloat16),
    (128, 2048, torch.bfloat16, torch.bfloat16),
    (7, 64, torch.float32, torch.float32),
    (5, 100, torch.float32, torch.bfloat16),
    (3, 2048, torch.bfloat16, torch.float32),
    (1, 1, torch.float32, torch.float32),
])
def test_kernel_matches_plain_on_cuda(rows, d, xt, wt):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((2, rows, d), generator=gen, device="cuda") * 3).to(xt)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(wt)
    before = norms.rms_norm.launches
    out = norms.rms_norm(x, w)
    ref = norms.rms_norm_ref(x, w)
    assert norms.rms_norm.launches == before + 1
    assert out.dtype == xt and out.shape == x.shape
    tol = 1e-5 if xt == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_do_not_depend_on_the_row_count_on_cuda(dtype):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4096, 2048), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((2048,), generator=gen,
                               device="cuda")).to(dtype)
    whole = norms.rms_norm(x, w)
    for m in (1, 2, 3, 4, 5, 8, 12, 16, 31, 32, 64, 128, 256, 1000):
        assert torch.equal(norms.rms_norm(x[:m], w), whole[:m]), m
    # A verify chunk's [b, c, d] against a decode step's [b, 1, d].
    chunk = x[:128].reshape(32, 4, 2048)
    assert torch.equal(norms.rms_norm(chunk, w)[:, 0],
                       norms.rms_norm(chunk[:, :1].contiguous(), w)[:, 0])


@pytest.mark.parametrize("shape", [(7, 64), (2, 3, 2048), (5, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_ref_is_the_add_then_the_norm(shape, dtype):
    """The plain version is the model's former composition bit for bit:
    ``x + delta`` (one rounding), then ``rms_norm_ref``; the CPU route is
    the plain version and counts no launch."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=gen) * 3).to(dtype)
    delta = torch.randn(shape, generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1:], generator=gen)).to(dtype)
    s, out = norms.add_rms_norm_ref(x, delta, w, 1e-5)
    assert torch.equal(s, x + delta)
    assert torch.equal(out, norms.rms_norm_ref(x + delta, w, 1e-5))
    before = (norms.rms_norm.launches, norms.add_rms_norm.launches)
    got = norms.add_rms_norm(x, delta, w, 1e-5)
    assert torch.equal(got[0], s) and torch.equal(got[1], out)
    assert got[1].dtype == dtype and got[1].shape == x.shape
    assert (norms.rms_norm.launches, norms.add_rms_norm.launches) == before


def test_add_rms_norm_rejects_bad_inputs():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="weight"):
        norms.add_rms_norm(x, x, torch.ones(4))
    with pytest.raises(ValueError, match="delta"):
        norms.add_rms_norm(x, x[:1], torch.ones(8))
    with pytest.raises(ValueError, match="delta"):
        norms.add_rms_norm(x, x.bfloat16(), torch.ones(8))
    with pytest.raises(ValueError, match="span devices"):
        norms.add_rms_norm(x, x.to("meta"), torch.ones(8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        norms.add_rms_norm(x.to("meta"), x.to("meta"),
                           torch.ones(8, device="meta"))


@pytest.mark.parametrize("rows,d,xt,wt", [
    (32, 2048, torch.bfloat16, torch.bfloat16),
    (128, 2048, torch.bfloat16, torch.bfloat16),
    (4096, 2048, torch.bfloat16, torch.bfloat16),
    (32, 512, torch.bfloat16, torch.bfloat16),
    (7, 64, torch.float32, torch.float32),
    (5, 100, torch.float32, torch.bfloat16),
    (3, 4096, torch.bfloat16, torch.float32),
    (3, 99, torch.bfloat16, torch.bfloat16),
    (1, 1, torch.float32, torch.float32),
])
def test_add_rms_norm_matches_plain_on_cuda(rows, d, xt, wt):
    """The fused kernel: s bitwise the add, out within one output ulp of
    the plain norm of s and bitwise the kernel's own rms_norm of s."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(xt)
    delta = torch.randn((rows, d), generator=gen, device="cuda").to(xt)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(wt)
    before = norms.add_rms_norm.launches
    s, out = norms.add_rms_norm(x, delta, w)
    assert norms.add_rms_norm.launches == before + 1
    ref_s, ref = norms.add_rms_norm_ref(x, delta, w)
    assert torch.equal(s, ref_s)
    assert torch.equal(out, norms.rms_norm(s, w))
    tol = 1e-5 if xt == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_add_rms_norm_rows_do_not_depend_on_the_row_count_on_cuda():
    """Rows of 1..256 and 4,096 rows bitwise the same rows in one call, and
    a verify chunk's [b, c, d] row 0 a decode step's [b, 1, d] row."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((4096, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    delta = torch.randn((4096, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (1 + 0.1 * torch.randn((2048,), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    s_all, whole = norms.add_rms_norm(x, delta, w)
    for m in (1, 2, 3, 5, 8, 31, 32, 33, 64, 128, 255, 256):
        s, out = norms.add_rms_norm(x[:m], delta[:m], w)
        assert torch.equal(out, whole[:m]) and torch.equal(s, s_all[:m]), m
    chunk, dc = x[:128].reshape(32, 4, 2048), delta[:128].reshape(32, 4, 2048)
    assert torch.equal(
        norms.add_rms_norm(chunk, dc, w)[1][:, 0],
        norms.add_rms_norm(chunk[:, :1].contiguous(), dc[:, :1].contiguous(),
                           w)[1][:, 0])
