"""The port's cosine-loss op against the JAX package's.

On the CPU the port runs its plain versions; they are held against the JAX
package's ``fused_cosine_loss`` (its jnp path here) and against the Pallas
kernel bodies themselves, run in interpret mode with the BlockSpecs of
``_pallas_forward`` / ``_pallas_backward``.  The CUDA kernels are held
against the plain versions on the card in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.ops import cosine_loss as jc
from semantic_embeddings_torch.ops import cosine_loss as tc

# f32 sums of 100 products taken in another order: a few ulp of the loss
# (which is O(1)) and of each dz element.
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _inputs(b, d=100, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(b, d)) * 3.0).astype(np.float32)
    t = rng.normal(size=(b, d)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return z, t


@pytest.mark.parametrize("b", [64, 37])
def test_forward_matches_jax(b):
    z, t = _inputs(b)
    ours = tc.fused_cosine_loss(torch.from_numpy(z), torch.from_numpy(t))
    ref = jc.fused_cosine_loss(jnp.asarray(z), jnp.asarray(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOSS_TOL)


@pytest.mark.parametrize("b", [64, 37])
def test_weighted_gradient_matches_jax(b):
    z, t = _inputs(b)
    w = np.linspace(0.1, 2.0, b).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    (tc.fused_cosine_loss(zt, tt) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda z: (jc.fused_cosine_loss(z, jnp.asarray(t)) * w).sum())(
        jnp.asarray(z))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref), **GRAD_TOL)
    assert tt.grad is None  # t is a constant: no gradient


def test_mean_gradient_matches_jax():
    z, t = _inputs(64)
    zt = torch.from_numpy(z).requires_grad_()
    tc.fused_cosine_loss(zt, torch.from_numpy(t)).mean().backward()
    ref = jax.grad(lambda z: jc.fused_cosine_loss(z, jnp.asarray(t)).mean())(
        jnp.asarray(z))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref), **GRAD_TOL)


def test_zero_rows_finite():
    z = torch.zeros(4, 16, requires_grad=True)
    t = torch.ones(4, 16) / 4.0
    loss = tc.fused_cosine_loss(z, t)
    loss.sum().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(z.grad).all()
    ref = jc.fused_cosine_loss(jnp.zeros((4, 16)), jnp.ones((4, 16)) / 4.0)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref), **LOSS_TOL)


def test_bf16_z():
    """bf16 z: the sums run in f32 on both sides and dz comes back in bf16;
    the two round dz to bf16 from f32 values a few ulp apart, so they agree
    to one bf16 ulp (2**-8 relative)."""
    z, t = _inputs(37)
    zb = torch.from_numpy(z).to(torch.bfloat16).requires_grad_()
    loss = tc.fused_cosine_loss(zb, torch.from_numpy(t))
    loss.sum().backward()
    assert loss.dtype == torch.float32 and zb.grad.dtype == torch.bfloat16
    z_bf16_as_f32 = zb.detach().float().numpy()
    zj = jnp.asarray(z_bf16_as_f32).astype(jnp.bfloat16)
    ref = jc.fused_cosine_loss(zj, jnp.asarray(t))
    ref_g = jax.grad(lambda z: jc.fused_cosine_loss(z, jnp.asarray(t)).sum())(zj)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref), **LOSS_TOL)
    np.testing.assert_allclose(zb.grad.float().numpy(),
                               np.asarray(ref_g.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("b", [64, 300])
def test_plain_versions_match_pallas_kernel_bodies(b):
    """The plain forward/backward against ``_fwd_kernel`` / ``_bwd_kernel``
    run by ``pallas_call`` in interpret mode, blocked as on the TPU."""
    from jax.experimental import pallas as pl

    z, t = _inputs(b)
    g = np.random.default_rng(1).random(b).astype(np.float32)
    d = z.shape[1]
    row_spec = pl.BlockSpec((jc._TILE, d), lambda i: (i, 0))
    col_spec = pl.BlockSpec((jc._TILE, 1), lambda i: (i, 0))
    grid = (pl.cdiv(b, jc._TILE),)
    loss_ref = pl.pallas_call(
        jc._fwd_kernel, grid=grid, in_specs=[row_spec, row_spec],
        out_specs=col_spec, out_shape=jax.ShapeDtypeStruct((b, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(z), jnp.asarray(t))[:, 0]
    dz_ref = pl.pallas_call(
        jc._bwd_kernel, grid=grid, in_specs=[row_spec, row_spec, col_spec],
        out_specs=row_spec, out_shape=jax.ShapeDtypeStruct((b, d), jnp.float32),
        interpret=True,
    )(jnp.asarray(z), jnp.asarray(t), jnp.asarray(g).reshape(b, 1))
    zt, tt, gt = map(torch.from_numpy, (z, t, g))
    np.testing.assert_allclose(tc._plain_forward(zt, tt).numpy(),
                               np.asarray(loss_ref), **LOSS_TOL)
    np.testing.assert_allclose(tc._plain_backward(zt, tt, gt).numpy(),
                               np.asarray(dz_ref), **GRAD_TOL)


def test_l2_normalize_matches_jax():
    z, _ = _inputs(37)
    z[3] = 0.0  # the eps floor keeps a zero row finite (and zero)
    ours = tc.l2_normalize(torch.from_numpy(z)).numpy()
    ref = np.asarray(jc.l2_normalize(jnp.asarray(z)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert (ours[3] == 0).all()


def test_cpu_tensors_launch_no_kernel():
    before = (tc.launches_fwd, tc.launches_bwd)
    z, t = _inputs(8)
    zt = torch.from_numpy(z).requires_grad_()
    tc.fused_cosine_loss(zt, torch.from_numpy(t)).mean().backward()
    assert (tc.launches_fwd, tc.launches_bwd) == before == (0, 0)


@pytest.mark.parametrize("case", tc.CHECK_CASES)
def test_plain_cosine_loss_matches_jax_on_check_inputs(case):
    """The reference that train steps through the kernels are held against,
    on the inputs at which the kernels are checked, against the JAX op."""
    shape, zero_rows = case
    z, t, g = tc.check_inputs(shape, torch.float32,
                              torch.Generator().manual_seed(0), zero_rows)
    assert not z[:zero_rows].any() and z[zero_rows:].abs().sum(1).all()
    torch.testing.assert_close(t.norm(dim=1), torch.ones(shape[0]))
    zt = z.clone().requires_grad_()
    total = (tc.PlainCosineLoss.apply(zt, t) * g).sum()
    total.backward()
    zj, tj, gj = (jnp.asarray(a.numpy()) for a in (z, t, g))
    ref, ref_g = jax.value_and_grad(
        lambda z: (jc.fused_cosine_loss(z, tj) * gj).sum())(zj)
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref_g), **GRAD_TOL)
    assert (tc.launches_fwd, tc.launches_bwd) == (0, 0)


def test_kernel_wrapper_rejects_cpu_tensors():
    z, t = map(torch.from_numpy, _inputs(4))
    with pytest.raises(ValueError, match="CUDA"):
        tc._launch_forward(z, t)
    with pytest.raises(ValueError, match="CUDA"):
        tc._launch_backward(z, t, torch.ones(4))
