"""``cls_base`` (the classification head on a named backbone module) and
``remat`` (residual blocks recomputed in the backward pass) against the JAX
package: the head on the same tap from the same weights, the same errors,
and a rematerialized step equal to a plain one, bitwise on the CPU, with
running statistics that move once a step, as the JAX ``remat=True``
model's do."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_common import (
    F32_OF_MAX,
    F64_OF_MAX,
    assert_close_of_max,
    flat,
    images,
    pair,
    torch_layout,
)
from semantic_embeddings_tpu.models import build_network as jbuild_network
from semantic_embeddings_tpu.models.cifar_resnet import SmallResNet as JSmallResNet
from semantic_embeddings_tpu.models.heads import EmbeddingModel as JEmbeddingModel
from semantic_embeddings_tpu.models.plainnet import PlainNet as JPlainNet
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.models import build_network, resnet
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.models.heads import EmbeddingModel
from semantic_embeddings_torch.models.layers import KerasBatchNorm
from semantic_embeddings_torch.models.plainnet import PlainNet

FILTERS = (8, "ap", 8, "gap", "fc12")
SIZE = 16


def _plain_pair(cls_base, output="l2norm"):
    jmodel = JEmbeddingModel(backbone=JPlainNet(10, filters=FILTERS), output=output,
                             cls_classes=5, cls_base=cls_base)
    tmodel = EmbeddingModel(PlainNet(10, filters=FILTERS), output=output, cls_classes=5,
                            cls_base=cls_base, input_shape=(SIZE, SIZE, 3))
    return jmodel, tmodel


@pytest.mark.parametrize("cls_base,width", [
    ("backbone/fc5", 12),  # a full path
    ("bn5", 12),           # a unique trailing name
    ("top", 10),
])
def test_cls_base_head_matches_jax(cls_base, width):
    """The head reads the tapped module's output, as wide as that output
    (12 for the dense layer inside the backbone, not the 10 of its top),
    in the eval forward (f32) and the train forward, where the head's
    statistics move alike (in float64: train-mode BN over a batch of 4
    amplifies f32 rounding past ``F32_OF_MAX``)."""
    jmodel, tmodel = _plain_pair(cls_base)
    assert tmodel.cls_bn.weight.shape == (width,) and tmodel.cls_top.in_features == width
    x = images((4, SIZE, SIZE, 3))
    variables = pair(jmodel, tmodel, x)
    tmodel.eval()
    with torch.no_grad():
        emb, prob = tmodel(torch.from_numpy(x))
    jemb, jprob = jmodel.apply(variables, jnp.asarray(x), train=False)
    assert_close_of_max(emb, jemb, F32_OF_MAX, "embedding")
    assert_close_of_max(prob, jprob, F32_OF_MAX, "prob")
    x64 = np.asarray(x, np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        (_, jprob), new = jax.device_get(jmodel.apply(v64, x64, train=True,
                                                      mutable=["batch_stats"]))
    model64 = copy.deepcopy(tmodel).double().train()
    with torch.no_grad():
        _, prob = model64.twin("linear", cls_input="l2norm")(torch.from_numpy(x64))
    assert_close_of_max(prob, jprob, F64_OF_MAX, "f64 train prob")
    want = torch_layout(new["batch_stats"], "batch_stats", model64)
    got = dict(model64.named_buffers())
    assert sorted(got) == sorted(want)
    for name, value in got.items():
        assert_close_of_max(value, want[name].numpy(), F64_OF_MAX, name)


@pytest.mark.parametrize("cls_base,match", [
    ("nothing", "matched no module"),
    ("conv_a", "ambiguous"),
    ("conv1", "needs a flat"),
])
def test_cls_base_errors_match_jax(cls_base, match):
    """No match, an ambiguous name and a 4-D tap raise ``ValueError`` in
    both packages, when the model is built (the JAX one at its init)."""
    if cls_base == "conv_a":
        jback = JSmallResNet(n=2, filters=(4, 8, 8), classes=10, top_activation=None)
        tback = SmallResNet(n=2, filters=(4, 8, 8), classes=10)
    else:
        jback, tback = JPlainNet(10, filters=FILTERS), PlainNet(10, filters=FILTERS)
    jmodel = JEmbeddingModel(backbone=jback, output="l2norm", cls_classes=5,
                             cls_base=cls_base)
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    with pytest.raises(ValueError, match=match):
        EmbeddingModel(tback, output="l2norm", cls_classes=5, cls_base=cls_base,
                       input_shape=(SIZE, SIZE, 3))


def test_cls_base_hooks_live_for_one_call():
    _, tmodel = _plain_pair("top")
    twin = tmodel.twin("linear", cls_input="l2norm")
    with torch.no_grad():
        tmodel.eval()(torch.zeros(2, SIZE, SIZE, 3))
        twin(torch.zeros(2, SIZE, SIZE, 3))
    assert all(not m._forward_hooks for m in tmodel.modules())
    with pytest.raises(RuntimeError):
        tmodel(torch.zeros(2, SIZE, SIZE, 4))  # a failing forward ...
    assert all(not m._forward_hooks for m in tmodel.modules())  # ... removes them too


# -- remat -----------------------------------------------------------------


def _step(model, x, r):
    """A train-mode forward, a loss and its gradients."""
    model.train()
    out = model(x)
    loss = (out * r).sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads


def _bn_calls(model):
    calls = []
    for m in model.modules():
        if isinstance(m, KerasBatchNorm):
            m.register_forward_hook(lambda *_: calls.append(1))
    return calls


@pytest.mark.parametrize("arch", ["small", "rn18"])
def test_remat_step_equals_plain_step_bitwise(arch):
    """SmallResNet and rn18 (its ``conv_b`` through the plain fused op on
    the CPU): with remat the blocks run their forward again in the backward
    (twice the block BN calls and fused-op calls), yet the loss, every
    gradient and every running statistic are bitwise those of a step
    without remat: the statistics moved once."""
    gen = torch.Generator().manual_seed(0)
    if arch == "small":
        make = lambda remat: SmallResNet(n=2, filters=(4, 8, 8), classes=10,  # noqa: E731
                                         remat=remat)
    else:
        make = lambda remat: build_network(10, "rn18", remat=remat).module  # noqa: E731
    plain, remat = make(False), make(True)
    variables = convert.state_dict_to_flax(plain)
    for m in (plain, remat):
        convert.load_flax_variables(m, variables)
    x = torch.randn(4, 32, 32, 3, generator=gen)
    r = torch.randn(4, 10, generator=gen)
    counts = {}
    for name, model in (("plain", plain), ("remat", remat)):
        bn_calls, fused_calls = _bn_calls(model), []
        for m in model.modules():
            if isinstance(m, resnet._Block):
                m.conv_bn_stats = lambda y, w, f=m.conv_bn_stats: (
                    fused_calls.append(1), f(y, w))[1]
        counts[name] = (_step(model, x, r), len(bn_calls), len(fused_calls))
    (loss_p, grads_p), bn_p, fused_p = counts["plain"]
    (loss_r, grads_r), bn_r, fused_r = counts["remat"]
    assert bn_r > bn_p and (fused_r == 2 * fused_p)
    assert torch.equal(loss_p, loss_r)
    for gp, gr in zip(grads_p, grads_r):
        assert torch.equal(gp, gr)
    for (name, a), (_, b) in zip(plain.named_buffers(), remat.named_buffers()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ["resnet-32", "rn18"])
def test_remat_running_stats_match_jax_remat(arch):
    """After one train step, the running statistics of the port's remat
    model equal those of the JAX package's ``remat=True`` model (moved once,
    from the same weights and batch)."""
    jmodule = jbuild_network(10, arch, remat=True).module
    tmodule = build_network(10, arch, remat=True).module
    x = images((4, 32, 32, 3))
    variables = pair(jmodule, tmodule, x)

    def loss(params):
        out, new = jmodule.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, train=True, mutable=["batch_stats"])
        return jnp.sum(out), new["batch_stats"]

    _, new = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    tmodule.train()
    tmodule(torch.from_numpy(x)).sum().backward()
    got = flat(convert.state_dict_to_flax(tmodule)["batch_stats"])
    want = flat(jax.device_get(new))
    assert sorted(got) == sorted(want)
    for key in want:
        assert_close_of_max(got[key], want[key], F32_OF_MAX, key)
