"""The depthwise op (``ops/depthwise.py``) and where it engages, on the CPU.

The op's CPU implementations are its plain versions (``F.conv2d`` and
``torch.nn.grad`` on the SAME-padded input); they and :class:`DepthwiseConv`'s
autograd are held against autograd through ``Conv2dSame``'s own call in f64,
and against the JAX package's depthwise conv (Flax's ``nn.Conv`` with
``feature_group_count`` = channels, as its NASNet-A builds it) for y, dx and
dw.  The engagement rule is held case by case, and the wiring through the
whole NASNet-A by pointing :data:`depthwise.KERNEL_DEVICES` at the CPU, so
that every depthwise conv takes the op's path here as it does on the card.
The CUDA kernels are held against f64 on the card in ``test_torch_cuda.py``
and ``chip_smoke.py`` (phase 4c).
"""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench.metrics.depthwise_conv_roofline import PASSES
from semantic_embeddings_torch.models import build_network, nasnet
from semantic_embeddings_torch.models.layers import Conv2dSame
from semantic_embeddings_torch.ops import depthwise
from semantic_embeddings_torch.parallel import spatial

OPS = torch.ops.semantic_embeddings_torch

#: (N, C, H, W, k, stride): each k at both strides; odd and even maps (the
#: asymmetric pads of stride 2 on even maps); 111 px scaled down to 13;
#: a map smaller than the filter
CASES = [(2, 3, 8, 8, 3, 1), (2, 3, 8, 8, 3, 2), (2, 4, 7, 9, 5, 1), (2, 4, 10, 6, 5, 2),
         (1, 5, 6, 6, 7, 1), (2, 3, 13, 13, 7, 2), (2, 2, 13, 13, 5, 2), (3, 2, 2, 3, 7, 2)]


def _inputs(n, c, h, w, k, stride, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, c, h, w))).to(dtype)
    wt = torch.from_numpy(rng.normal(size=(c, 1, k, k)) / k).to(dtype)
    g = torch.from_numpy(rng.normal(size=(n, c, depthwise.out_size(h, stride),
                                          depthwise.out_size(w, stride)))).to(dtype)
    return x, wt, g


def _conv(c, k, stride):
    conv = Conv2dSame(c, c, k, stride, use_bias=False, groups=c)
    return conv.double()


@pytest.mark.parametrize("case", CASES)
def test_ops_and_autograd_match_conv2d_same_autograd_in_f64(case):
    n, c, h, w, k, stride = case
    x, wt, g = _inputs(*case)
    conv = _conv(c, k, stride)
    with torch.no_grad():
        conv.weight.copy_(wt)
    xr = x.clone().requires_grad_()
    y_ref = conv(xr)  # CPU tensors: the module's own call (F.pad / F.conv2d)
    y_ref.backward(g)
    y = OPS.depthwise_conv_forward(x, wt, stride)
    dx = OPS.depthwise_conv_input_grad(g, wt, h, w, stride)
    dw = OPS.depthwise_conv_grad_weight(x, g, k, stride)
    assert y.shape == y_ref.shape and dx.shape == x.shape and dw.shape == wt.shape
    assert dw.dtype == torch.float64
    torch.testing.assert_close(y, y_ref.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dx, xr.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, conv.weight.grad, rtol=1e-12, atol=1e-12)
    xk, wk = x.clone().requires_grad_(), wt.clone().requires_grad_()
    yk = depthwise.DepthwiseConv.apply(xk, wk, stride)
    assert torch.equal(yk, y)
    yk.backward(g)
    assert torch.equal(xk.grad, dx) and torch.equal(wk.grad, dw)


def _jax_depthwise(x, wt, g, stride):
    """y, dx and dw of the JAX package's depthwise conv (NASNet-A's ``dw``
    layers: ``nn.Conv`` with ``feature_group_count`` = channels, SAME, no
    bias), in NCHW numpy arrays."""
    c, k = wt.shape[0], wt.shape[-1]
    layer = fnn.Conv(c, (k, k), strides=(stride, stride), padding="SAME",
                     feature_group_count=c, use_bias=False)
    kernel = jnp.asarray(wt.numpy().transpose(2, 3, 1, 0))  # (k, k, 1, C)
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))

    def f(xj, kernel):
        return layer.apply({"params": {"kernel": kernel}}, xj)

    y, vjp = jax.vjp(f, xj, kernel)
    dx, dk = vjp(jnp.asarray(g.numpy().transpose(0, 2, 3, 1)))
    return (np.asarray(y).transpose(0, 3, 1, 2), np.asarray(dx).transpose(0, 3, 1, 2),
            np.asarray(dk).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5], (2, 3, 9, 9, 3, 1)])
def test_ops_match_the_jax_package_depthwise_conv(case):
    n, c, h, w, k, stride = case
    x, wt, g = _inputs(*case, dtype=torch.float32, seed=1)
    y_j, dx_j, dw_j = _jax_depthwise(x, wt, g, stride)
    y = OPS.depthwise_conv_forward(x, wt, stride)
    dx = OPS.depthwise_conv_input_grad(g, wt, h, w, stride)
    dw = OPS.depthwise_conv_grad_weight(x, g, k, stride)
    # f32 on both sides, sums of at most k^2 (y, dx) or n * Ho * Wo (dw) terms
    np.testing.assert_allclose(y.numpy(), y_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), dx_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw_j, rtol=1e-5, atol=1e-4)


def test_fake_implementations_give_the_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 6, 11, 10)
        wt = torch.empty(6, 1, 5, 5)
        g = torch.empty(2, 6, 6, 5)
        assert OPS.depthwise_conv_forward(x, wt, 2).shape == (2, 6, 6, 5)
        assert OPS.depthwise_conv_input_grad(g, wt, 11, 10, 2).shape == (2, 6, 11, 10)
        dw = OPS.depthwise_conv_grad_weight(x, g, 5, 2)
        assert dw.shape == (6, 1, 5, 5) and dw.dtype == torch.float32


def test_opcheck_the_three_ops():
    x, wt, g = _inputs(2, 3, 7, 6, 3, 2, dtype=torch.float32)
    torch.library.opcheck(depthwise.depthwise_conv_forward, (x, wt, 2))
    torch.library.opcheck(depthwise.depthwise_conv_input_grad, (g, wt, 7, 6, 2))
    torch.library.opcheck(depthwise.depthwise_conv_grad_weight, (x, g, 3, 2))


def test_kernel_names_are_the_benchmark_readers_passes():
    for kind, pattern in PASSES.items():
        name = depthwise.KERNEL_NAMES["grad_weight" if kind == "weight_grad" else kind]
        assert [k for k, p in PASSES.items() if re.search(p, name)] == [kind]


@pytest.fixture
def on_cpu(monkeypatch):
    """The op's path engages for CPU tensors too."""
    monkeypatch.setattr(depthwise, "KERNEL_DEVICES", ("cpu", "cuda"))


def test_engages_only_where_the_kernels_apply(on_cpu, monkeypatch):
    conv = Conv2dSame(4, 4, 5, 2, use_bias=False, groups=4)
    x = torch.randn(2, 4, 9, 9)
    assert depthwise.engages(conv, x)
    assert not depthwise.engages(conv, x.to(torch.bfloat16))  # bf16 keeps ATen
    assert not depthwise.engages(conv, x.transpose(2, 3))  # not contiguous NCHW
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert not depthwise.engages(conv, x)
    monkeypatch.setattr(spatial, "active", lambda: True)
    assert not depthwise.engages(conv, x)
    monkeypatch.undo()
    monkeypatch.setattr(depthwise, "KERNEL_DEVICES", ("cuda",))
    assert not depthwise.engages(conv, x)  # CPU tensors keep the module's call
    monkeypatch.setattr(depthwise, "KERNEL_DEVICES", ("cpu", "cuda"))
    others = [Conv2dSame(4, 8, 3, 1, use_bias=False),  # groups == 1
              Conv2dSame(4, 4, 3, 1, use_bias=True, groups=4),  # a bias
              Conv2dSame(4, 4, 3, 1, use_bias=False, groups=4, padding="VALID"),
              Conv2dSame(4, 4, 1, 1, use_bias=False, groups=4),  # k not 3, 5 or 7
              Conv2dSame(4, 4, 3, 3, use_bias=False, groups=4),  # stride 3
              Conv2dSame(4, 8, 3, 1, use_bias=False, groups=4)]  # a channel multiplier
    dilated = Conv2dSame(4, 4, 3, 1, use_bias=False, groups=4)
    dilated.dilation = (2, 2)
    for other in others + [dilated]:
        assert not depthwise.engages(other, x)


def test_nasnet_a_through_the_op_matches_its_own_convs(on_cpu, monkeypatch):
    """``build_network("nasnet-a")`` at 32 px: every depthwise conv through
    :class:`DepthwiseConv` (220 a forward, each op once a pass) gives the
    outputs and gradients of the convs' own ``F.conv2d`` calls."""
    model = build_network(10, "nasnet-a", generator=torch.Generator().manual_seed(0)).module
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 32, 32, 3))).float()
    calls = {"forward": 0, "input_grad": 0, "grad_weight": 0}
    for kind in calls:
        name = f"depthwise_conv_{kind}"
        op = getattr(depthwise, name)

        def counting(*args, _op=op, _kind=kind):
            calls[_kind] += 1
            return _op(*args)

        monkeypatch.setattr(depthwise, name, counting)

    def run():
        model.zero_grad()
        y = model(x)
        y.square().sum().backward()
        return y.detach(), [p.grad.clone() for p in model.parameters()]

    before = nasnet.depthwise_convs
    y_op, g_op = run()
    assert calls == {"forward": 220, "input_grad": 220, "grad_weight": 220}
    assert nasnet.depthwise_convs - before == 220
    monkeypatch.setattr(depthwise, "KERNEL_DEVICES", ("cuda",))
    y_own, g_own = run()
    assert calls["forward"] == 220  # the module's own calls this time
    torch.testing.assert_close(y_op, y_own, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_op, g_own):
        scale = b.abs().max().item() or 1.0
        assert (a - b).abs().max().item() <= 1e-4 * scale
