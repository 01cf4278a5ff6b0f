"""The port's kernels as ``torch.library`` custom ops, on the CPU.

``torch.library.opcheck`` tests each op's registration (schema, fake
implementation, autograd, tracing with a dynamic batch); the ops are held
bitwise against their plain versions (their CPU implementations), against
the JAX package's functions and the Pallas kernels in interpret mode, and
traced through ``torch.export`` with a symbolic batch.  The ops' CUDA
implementations are held against the plain versions on the card in
``test_torch_cuda.py``.
"""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.ops import cosine_loss as jc
from semantic_embeddings_torch.ops import conv3x3 as cc
from semantic_embeddings_torch.ops import cosine_loss as tc
from tools.conv_filter_grad_prototype import conv3x3_filter_grad as j_filter_grad
from tools.fused_conv_bn_prototype import conv3x3_bn_stats as j_conv_bn_stats

OPS = torch.ops.semantic_embeddings_torch
DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _cosine_inputs(b, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy((rng.normal(size=(b, d)) * 3.0).astype(np.float32)).to(dtype)
    t = rng.normal(size=(b, d)).astype(np.float32)
    t = torch.from_numpy(t / np.linalg.norm(t, axis=1, keepdims=True))
    g = torch.from_numpy(rng.uniform(size=b).astype(np.float32))
    return z, t, g


def _conv_inputs(b, h, w, c, f, dtype, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(0, 0.1, (f, c, 3, 3)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(b, f, h, w)).astype(np.float32)).to(dtype)
    return x, k, dy


# -- the registrations --------------------------------------------------------


def test_the_four_ops_are_registered():
    for name in ("cosine_loss_fwd", "cosine_loss_bwd", "conv3x3_bn_stats",
                 "conv3x3_filter_grad"):
        assert hasattr(OPS, name), name
    assert len(OPS.conv3x3_bn_stats.default._schema.returns) == 3  # y, s, ss


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(7, 5), (1, 16)])
def test_opcheck_cosine_loss_fwd(shape, dtype):
    z, t, _ = _cosine_inputs(*shape, dtype)
    torch.library.opcheck(tc.cosine_loss_fwd, (z.requires_grad_(), t))


@pytest.mark.parametrize("dtype", DTYPES)
def test_opcheck_cosine_loss_bwd(dtype):
    z, t, g = _cosine_inputs(9, 6, dtype)
    torch.library.opcheck(tc.cosine_loss_bwd, (z, t, g))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 4, 3, 6), (3, 7, 7, 5, 10)])
def test_opcheck_conv3x3_bn_stats(shape, dtype):
    x, w, _ = _conv_inputs(*shape, dtype)
    torch.library.opcheck(cc.conv3x3_bn_stats_op,
                          (x.requires_grad_(), w.requires_grad_()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_opcheck_conv3x3_filter_grad(dtype):
    x, _, dy = _conv_inputs(2, 5, 4, 3, 6, dtype)
    torch.library.opcheck(cc.conv3x3_filter_grad, (x, dy))


def test_fakes_take_a_symbolic_batch_and_check_shapes():
    """On the meta device the ops run their fake implementations: shapes
    and dtypes only, and a mismatch raises."""
    z = torch.empty(5, 8, device="meta", dtype=torch.bfloat16)
    loss = OPS.cosine_loss_fwd(z, torch.empty(5, 8, device="meta"))
    assert loss.shape == (5,) and loss.dtype == torch.float32
    assert OPS.cosine_loss_bwd(z, z.float(), loss).dtype == torch.bfloat16
    x = torch.empty(4, 3, 9, 7, device="meta", dtype=torch.bfloat16)
    y, s, ss = OPS.conv3x3_bn_stats(x, torch.empty(6, 3, 3, 3, device="meta",
                                                   dtype=torch.bfloat16))
    assert (y.shape, y.dtype, s.shape, s.dtype) == ((4, 6, 9, 7), torch.bfloat16, (6,),
                                                    torch.float32)
    dw = OPS.conv3x3_filter_grad(x, torch.empty(4, 6, 9, 7, device="meta"))
    assert dw.shape == (6, 3, 3, 3) and dw.dtype == torch.float32
    with pytest.raises(RuntimeError, match="one shape"):
        OPS.cosine_loss_fwd(z, torch.empty(5, 7, device="meta"))
    with pytest.raises(RuntimeError, match="do not fit"):
        OPS.conv3x3_bn_stats(x, torch.empty(6, 4, 3, 3, device="meta"))


# -- the ops against their plain versions and the JAX package ------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_cosine_ops_equal_the_plain_versions_bitwise(dtype):
    z, t, g = _cosine_inputs(33, 20, dtype)
    assert torch.equal(OPS.cosine_loss_fwd(z, t), tc._plain_forward(z, t))
    assert torch.equal(OPS.cosine_loss_bwd(z, t, g), tc._plain_backward(z, t, g))
    zk, zp = z.clone().requires_grad_(), z.clone().requires_grad_()
    (tc.fused_cosine_loss(zk, t) * g).sum().backward()
    (tc.PlainCosineLoss.apply(zp, t) * g).sum().backward()
    assert torch.equal(zk.grad, zp.grad)
    assert (tc.launches_fwd, tc.launches_bwd) == (0, 0)


@pytest.mark.parametrize("b", [64, 37])
def test_cosine_op_and_its_autograd_match_jax(b):
    z, t, g = _cosine_inputs(b, 100, torch.float32)
    zt = z.clone().requires_grad_()
    loss = OPS.cosine_loss_fwd(zt, t)
    (loss * g).sum().backward()
    ref = jc.fused_cosine_loss(jnp.asarray(z.numpy()), jnp.asarray(t.numpy()))
    ref_dz = jax.grad(lambda z_: (jc.fused_cosine_loss(z_, jnp.asarray(t.numpy()))
                                  * g.numpy()).sum())(jnp.asarray(z.numpy()))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref_dz), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_ops_equal_the_plain_versions_bitwise(dtype):
    """The op's forward and backward (dw through the filter-gradient op)
    against the plain autograd.Function, bitwise."""
    x, w, _ = _conv_inputs(3, 7, 6, 5, 8, dtype)
    for out, ref in zip(OPS.conv3x3_bn_stats(x, w), cc._plain_conv_bn_stats(x, w)):
        assert torch.equal(out, ref)
    grads = []
    for op in (cc.conv3x3_bn_stats, cc.plain_conv3x3_bn_stats):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y, s, ss = op(xg, wg)
        (y.float().sin().sum() + s.sum() * 0.5 + ss.sum() * 0.01).backward()
        grads.append((xg.grad, wg.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    assert (cc.launches_conv_bn_stats, cc.launches_filter_grad) == (0, 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_ops_match_the_pallas_prototypes(dtype):
    """Both conv ops against the Pallas prototypes run in interpret mode
    (tolerances of tests/test_torch_conv3x3.py: sums of 72 / 512 products
    in two orders; bf16 y and dw within one bf16 ulp)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, w, dy = _conv_inputs(8, 8, 8, 4, 6, torch.float32)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    y_r, s_r, ss_r = j_conv_bn_stats(jnp.asarray(nhwc(x), jdt),
                                     jnp.asarray(w.permute(2, 3, 1, 0).numpy(), jdt),
                                     interpret=True)
    y, s, ss = OPS.conv3x3_bn_stats(x.to(tdt), w.to(tdt))
    y_tol = dict(rtol=0, atol=5e-6) if dtype == "f32" else dict(rtol=2**-7, atol=1e-6)
    s_tol = dict(rtol=1e-5, atol=1e-3) if dtype == "f32" else dict(rtol=1e-3, atol=3e-2)
    np.testing.assert_allclose(nhwc(y.float()), np.asarray(y_r, np.float32), **y_tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **s_tol)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_r), **s_tol)
    ref = j_filter_grad(jnp.asarray(nhwc(x), jdt), jnp.asarray(nhwc(dy), jdt),
                        batch_tile=4, interpret=True)
    dw = OPS.conv3x3_filter_grad(x.to(tdt), dy.to(tdt))
    tol = dict(rtol=0, atol=1e-4) if dtype == "f32" else dict(rtol=2**-8, atol=1e-3)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), np.asarray(ref), **tol)


# -- tracing --------------------------------------------------------------


class _LossAndConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(6, 3, 3, 3, generator=torch.Generator()
                                                .manual_seed(0)) * 0.2)

    def forward(self, x, t):
        y, s, ss = cc.conv3x3_bn_stats(x, self.w)
        z = y.mean(dim=(2, 3)) + s / y.shape[0] - ss * 1e-3
        return tc.fused_cosine_loss(z, t)


def test_export_keeps_the_op_nodes_with_a_symbolic_batch():
    """``torch.export`` traces through the fakes with a symbolic batch and
    keeps one node of each forward op; the loaded program equals the
    module at another batch."""
    module = _LossAndConv().eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 5)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        program = torch.export.export(module, (x, t),
                                      dynamic_shapes=({0: batch}, {0: batch}))
    targets = [str(n.target) for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
               if n.op == "call_function"]
    assert sum("conv3x3_bn_stats" in t for t in targets) == 1
    assert sum("cosine_loss_fwd" in t for t in targets) == 1
    assert not any("convolution" in t or "conv2d" in t for t in targets)
    x5 = torch.from_numpy(rng.normal(size=(5, 3, 5, 5)).astype(np.float32))
    t5 = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(program.module()(x5, t5), module(x5, t5))
