"""The port's layers and models against the JAX package's, from the same
weights (through ``semantic_embeddings_torch.convert``) and the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from semantic_embeddings_tpu.models import ModelSpec as JModelSpec
from semantic_embeddings_tpu.models.cifar_resnet import SmallResNet as JSmallResNet
from semantic_embeddings_tpu.models.heads import EmbeddingModel as JEmbeddingModel
from semantic_embeddings_tpu.models.layers import KerasBatchNorm as JKerasBatchNorm
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.models import ModelSpec, build_network
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.models.heads import EmbeddingModel
from semantic_embeddings_torch.models.layers import KerasBatchNorm, conv

# f32 convolutions and BN over small maps, summed in another order than
# XLA's: outputs of O(1) agree to ~1e-6; 1e-5 leaves room for the ~10
# layers the error passes through.
ATOL = 1e-5


def _randomize(variables, seed=0):
    """Every constant-initialized leaf (BN scale/bias/mean/var, biases)
    replaced by random values (variances positive), so that no leaf passes
    a comparison by being its initial constant."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        if name == "kernel":  # glorot draws: random, and keep outputs O(1)
            return a.astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.normal(size=a.shape) * 0.1).astype(np.float32)

    return walk(variables)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _pair(output="l2norm", cls_classes=5, cls_input="output", seed=0):
    """(jax model, variables, torch model) with equal random weights."""
    jbackbone = JSmallResNet(n=2, filters=(8, 16, 32), classes=10,
                             include_top=True, top_activation=None)
    jmodel = JEmbeddingModel(backbone=jbackbone, output=output,
                             cls_classes=cls_classes, cls_input=cls_input)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    variables = _randomize(variables, seed)
    tbackbone = SmallResNet(n=2, filters=(8, 16, 32), classes=10,
                            include_top=True)
    tmodel = EmbeddingModel(tbackbone, output=output, cls_classes=cls_classes,
                            cls_input=cls_input)
    convert.load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def _images(b=4, size=16, seed=1):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(
        np.float32)


def test_convert_covers_every_leaf_both_ways():
    _, variables, tmodel = _pair()
    back = convert.state_dict_to_flax(tmodel)
    want, got = _flat(variables), _flat(back)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(tmodel.state_dict()) == len(want)


def test_convert_raises_on_unmapped_leaves():
    _, variables, tmodel = _pair()
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((2, 2))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        convert.flax_to_state_dict(extra, tmodel)
    params = dict(variables["params"])
    del params["cls_top"]
    with pytest.raises(KeyError, match="cls_top"):
        convert.flax_to_state_dict(
            {"params": params, "batch_stats": variables["batch_stats"]}, tmodel)


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (1, 2)])
def test_tf_same_conv_matches_flax(size, kernel, stride):
    """TF SAME padding: a stride-2 3x3 conv on an even input pads (0, 1)."""
    x = _images(2, size)
    jconv = fnn.Conv(6, (kernel, kernel), strides=(stride, stride),
                     padding="SAME")
    v = _randomize(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jconv.apply(v, jnp.asarray(x)))
    tconv = conv(3, 6, kernel, stride)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(
            v["params"]["kernel"].transpose(3, 2, 0, 1).copy()))
        tconv.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        out = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 6, 6, 5), (16, 5)])
def test_keras_batchnorm_matches_flax(shape):
    """Train-mode output AND the updated running stats (Flax moves the
    running variance towards the biased batch variance), then eval mode."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    jbn = JKerasBatchNorm()
    v = _randomize(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref, new = jbn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ref_eval = jbn.apply(v, jnp.asarray(x), train=False)

    bn = KerasBatchNorm(shape[-1])
    p, s = v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]
    bn.load_state_dict({
        "weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
        "running_mean": torch.from_numpy(s["mean"]),
        "running_var": torch.from_numpy(s["var"])})
    xt = torch.from_numpy(x)
    if xt.ndim == 4:
        xt = xt.permute(0, 3, 1, 2)

    def nhwc(y):
        return (y.permute(0, 2, 3, 1) if y.ndim == 4 else y).detach().numpy()

    bn.eval()
    np.testing.assert_allclose(nhwc(bn(xt)), np.asarray(ref_eval), rtol=1e-5,
                               atol=1e-6)
    bn.train()
    np.testing.assert_allclose(nhwc(bn(xt)), np.asarray(ref), rtol=1e-5, atol=1e-5)
    new = new["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("output,cls_classes,cls_input", [
    ("linear", 0, "output"),
    ("l2norm", 0, "output"),
    ("linear", 5, "l2norm"),
    ("l2norm", 5, "output"),
])
def test_embedding_model_matches_flax(output, cls_classes, cls_input):
    """SmallResNet(n=2) + head, eval and train mode, plus the new BN stats."""
    jmodel, variables, tmodel = _pair(output, cls_classes, cls_input)
    x = _images()
    xt = torch.from_numpy(x)

    def as_list(out):
        return list(out) if isinstance(out, tuple) else [out]

    ref_eval = jmodel.apply(variables, jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        for a, b in zip(as_list(tmodel(xt)), as_list(ref_eval)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=ATOL)

    ref_train, new = jmodel.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        for a, b in zip(as_list(tmodel(xt)), as_list(ref_train)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=ATOL)
    got = _flat(convert.state_dict_to_flax(tmodel)["batch_stats"])
    want = _flat(new["batch_stats"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=ATOL,
                                   err_msg=k)


def test_twin_shares_parameters():
    _, _, tmodel = _pair("l2norm", 5)
    twin = tmodel.twin("linear", cls_input="l2norm")
    assert [p.data_ptr() for p in twin.parameters()] == [
        p.data_ptr() for p in tmodel.parameters()]
    assert tmodel.output == "l2norm" and twin.output == "linear"


def test_l2_penalty_matches_jax():
    """Kernels only (conv and dense weights), first match wins, including
    the trainer's ``^cls_top$`` rule prepended to the catch-all."""
    jmodel, variables, tmodel = _pair("l2norm", 5)
    # one spec whose filter list changes, as the CLI prepends ^cls_top$
    # after building it: the cached grouping must follow the change
    spec = ModelSpec("x", tmodel.backbone, [])
    for filters in ([(r".*", 2e-4)],
                    [(r"^cls_top$", 5e-4), (r".*", 2e-4)],
                    [(r"stage2", 1e-3)]):
        ref = JModelSpec("x", jmodel.backbone, list(filters)).l2_penalty(
            variables["params"])
        spec.l2_filters = list(filters)
        ours = spec.l2_penalty(tmodel)
        np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-6)


def test_l2_penalty_gradient_is_on_kernels_only():
    """d/dW of ``coef * sum(W**2)`` is ``2 * coef * W`` for each kernel, by
    its first matching rule; BN weights and biases get none."""
    _, _, tmodel = _pair("l2norm", 5)
    spec = ModelSpec("x", tmodel.backbone, [(r"^cls_top$", 5e-4), (r".*", 2e-4)])
    spec.l2_penalty(tmodel).backward()
    for name, p in tmodel.named_parameters():
        if name.endswith("weight") and p.ndim > 1:
            coef = 5e-4 if name.startswith("cls_top.") else 2e-4
            torch.testing.assert_close(p.grad, 2 * coef * p.detach(),
                                       rtol=1e-5, atol=1e-9, msg=name)
        else:
            assert p.grad is None or not p.grad.any(), name


@pytest.mark.parametrize("arch", ["resnet-110-wfc", "resnet-110-fc", "resnet-32"])
def test_build_network_matches_jax_shapes(arch):
    """Every parameter and BN statistic of ``build_network`` has the JAX
    package's shape (resnet-110-wfc: n=18 blocks of (32, 64, 128) filters
    and a 128 -> 100 top; resnet-32 has no top in embedding mode)."""
    from semantic_embeddings_tpu.models import build_network as jbuild_network

    jspec = jbuild_network(100, arch)
    shapes = jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    spec = build_network(100, arch)
    sd = spec.module.state_dict()
    want = {k: v.shape for k, v in convert.flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
        spec.module).items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert spec.l2_filters == jspec.l2_filters
    x = torch.zeros(2, 32, 32, 3)
    spec.module.eval()
    with torch.no_grad():
        out = spec.module(x)
    assert out.shape == (2, 64 if arch == "resnet-32" else 100)


@pytest.mark.parametrize("name", ["global_avg_pool", "global_max_pool"])
def test_global_pools_match_jax(name):
    from semantic_embeddings_tpu.models import layers as jlayers
    from semantic_embeddings_torch.models import layers

    x = _images(3, 5)
    ours = getattr(layers, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = getattr(jlayers, name)(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
