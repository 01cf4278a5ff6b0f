"""The 1x1 convs' weight-gradient op and where it engages, on the CPU.

The op's CPU implementation is its plain version (``conv2d_weight`` upcast
to f32); it and :class:`Conv1x1`'s autograd are held against autograd
through ``F.conv2d`` in f64.  The engagement rule is held by pointing
:data:`conv1x1.KERNEL_DEVICES` at the CPU, so that the op's path runs here
as it runs on the card, and counting the op's calls.  The CUDA kernel is
held against f64 on the card in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semantic_embeddings_torch.models import build_network, resnet
from semantic_embeddings_torch.ops import conv1x1 as c1
from semantic_embeddings_torch.parallel import spatial

OPS = torch.ops.semantic_embeddings_torch


def _inputs(n, c, f, h, w, stride, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, c, h, w))).to(dtype)
    wt = torch.from_numpy(rng.normal(size=(f, c, 1, 1)) * np.sqrt(2 / c)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(n, f, c1.out_size(h, stride),
                                          c1.out_size(w, stride)))).to(dtype)
    return x, wt, g


@pytest.fixture
def on_cpu(monkeypatch):
    """The op's path engages for CPU tensors too; returns the list of the
    op's calls (``(C, F, stride)``) made through it."""
    calls, op = [], c1.conv1x1_filter_grad

    def counting(x, dy, stride):
        calls.append((x.shape[1], dy.shape[1], stride))
        return op(x, dy, stride)

    monkeypatch.setattr(c1, "KERNEL_DEVICES", ("cpu", "cuda"))
    monkeypatch.setattr(c1, "conv1x1_filter_grad", counting)
    return calls


@pytest.mark.parametrize("case", [(2, 64, 128, 8, 8, 1), (2, 64, 128, 8, 8, 2),
                                  (3, 5, 7, 7, 5, 2), (1, 3, 4, 1, 1, 1)])
def test_op_and_autograd_match_conv2d_autograd_in_f64(case):
    n, c, f, h, w, stride = case
    x, wt, g = _inputs(*case)
    xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
    F.conv2d(xr, wr, None, stride).backward(g)
    dw = OPS.conv1x1_filter_grad(x, g, stride)
    assert dw.shape == (f, c, 1, 1) and dw.dtype == torch.float64
    torch.testing.assert_close(dw, wr.grad, rtol=1e-12, atol=1e-12)
    xk, wk = x.clone().requires_grad_(), wt.clone().requires_grad_()
    y = c1.Conv1x1.apply(xk, wk, stride, c1.conv1x1_filter_grad)
    assert torch.equal(y, F.conv2d(x, wt, None, stride))
    y.backward(g)
    torch.testing.assert_close(xk.grad, xr.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(wk.grad, wr.grad, rtol=1e-12, atol=1e-12)


def test_op_reference_is_the_strided_matrix_product():
    x, _, g = _inputs(3, 5, 7, 7, 5, 2)
    torch.testing.assert_close(c1._plain_filter_grad(x, g, 2), c1.reference(x, g, 2),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stride", [1, 2])
def test_opcheck_conv1x1_filter_grad(stride, dtype):
    x, _, g = _inputs(2, 6, 10, 5, 4, stride, dtype)
    torch.library.opcheck(c1.conv1x1_filter_grad, (x, g, stride))


def test_fake_gives_the_weight_shape_and_checks_the_batch():
    x = torch.empty(4, 64, 14, 14, device="meta")
    dw = OPS.conv1x1_filter_grad(x, torch.empty(4, 128, 7, 7, device="meta"), 2)
    assert dw.shape == (128, 64, 1, 1) and dw.dtype == torch.float32
    with pytest.raises(RuntimeError, match="do not fit"):
        OPS.conv1x1_filter_grad(x, torch.empty(3, 128, 7, 7, device="meta"), 2)


def test_wrapper_rejects_cpu_tensors():
    x, _, g = _inputs(2, 64, 64, 4, 4, 1, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        c1._launch_filter_grad(x, g, 1)


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_block_gradients_unchanged_by_the_routing(on_cpu, stride):
    """A ResNet-50 bottleneck block with a projection shortcut, in f32: its
    output and every gradient through the op's path equal those through the
    modules' own calls (the same aten kernels on the CPU)."""
    gen = torch.Generator().manual_seed(0)
    block = resnet.BottleneckBlock(128, 64, stride=stride, project=True, generator=gen)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 128, 8, 8)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(2, 256, 8 // stride, 8 // stride)).astype(np.float32))

    def run():
        xg = x.clone().requires_grad_()
        block.zero_grad()
        y = block(xg)
        (y * r).sum().backward()
        return y.detach(), xg.grad, {n: p.grad.clone() for n, p in block.named_parameters()}

    y_op, dx_op, grads_op = run()
    assert sorted(on_cpu) == sorted([(128, 64, stride), (64, 256, 1), (128, 256, stride)])
    block.conv_1x1 = lambda conv, x_: conv(x_)
    y_ref, dx_ref, grads_ref = run()
    assert len(on_cpu) == 3
    assert torch.equal(y_op, y_ref)
    torch.testing.assert_close(dx_op, dx_ref, rtol=1e-6, atol=1e-6)
    for name, g in grads_ref.items():
        torch.testing.assert_close(grads_op[name], g, rtol=1e-6, atol=1e-6, msg=name)


def _step_calls(arch, calls, size=32):
    model = build_network(10, arch, generator=torch.Generator().manual_seed(0)).module
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, size, size, 3))
                         .astype(np.float32))
    model(x).float().sum().backward()
    return len(calls)


@pytest.mark.parametrize("arch, launches", [("resnet-50", 36), ("rn18", 4),
                                            ("densenet-100-12", 0), ("nasnet-a", 0),
                                            ("resnet-32", 0)])
def test_which_convs_take_the_op(on_cpu, arch, launches):
    """A train step takes the op at each of ResNet-50's 36 1x1 convs (16
    ``conv_a``, 16 ``conv_c``, 4 shortcuts) and rn18's 4 shortcuts; the
    other families keep their convs' own calls."""
    assert _step_calls(arch, on_cpu) == launches
    if arch == "resnet-50":
        assert sum(s == 2 for _, _, s in on_cpu) == 6


def test_bf16_spatial_inference_and_the_plain_reference_keep_todays_path(on_cpu):
    conv = resnet._conv(64, 128, 1, 2, torch.Generator().manual_seed(0))
    x = torch.randn(2, 64, 8, 8)
    assert c1.engages(conv, x)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert not c1.engages(conv, x)
    with torch.no_grad():
        assert not c1.engages(conv, x)
    assert not c1.engages(conv, x.double())
    before = spatial.set_grid(spatial.Grid(2, 2, 0, groups=False))
    try:
        assert not c1.engages(conv, x)
    finally:
        spatial.set_grid(before)
    conv.weight.requires_grad_(False)  # a frozen backbone
    assert not c1.engages(conv, x)
    conv.weight.requires_grad_(True)
    three = resnet._conv(64, 128, 3, 1, torch.Generator().manual_seed(0))
    assert not c1.engages(three, x)
    ragged = resnet._conv(64, 96, 1, 1, torch.Generator().manual_seed(0))
    assert not c1.engages(ragged, x)
    # the plain reference's path takes the plain version, not the op
    model = resnet.use_plain_conv_bn_stats(
        build_network(10, "rn18", generator=torch.Generator().manual_seed(0)).module)
    launches = c1.launches_filter_grad
    model(torch.randn(2, 32, 32, 3)).sum().backward()
    assert on_cpu == []
    assert c1.launches_filter_grad == launches
