"""``build_network`` for every architecture name of the JAX package (plus
``-selu``, ``classification`` and ``no_softmax``) against the JAX build:
the same parameters and statistics, shape by shape, the same L2 rules and
input size, and the same L2 penalty on carried-over weights; and the layers
the new families added (initializers, grouped and strided SAME convs, SAME
pools, the zero padding of NASNet's reduction cells)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_zoo_common import flat, images, pair
from semantic_embeddings_tpu.models import ARCHITECTURES as JARCHITECTURES
from semantic_embeddings_tpu.models import ModelSpec as JModelSpec
from semantic_embeddings_tpu.models import build_network as jbuild_network
from semantic_embeddings_tpu.models import densenet as jdensenet
from semantic_embeddings_tpu.models import layers as jlayers
from semantic_embeddings_tpu.models import nasnet as jnasnet
from semantic_embeddings_tpu.models.pyramidnet import PyramidNet as JPyramidNet
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.models import ARCHITECTURES, ModelSpec, build_network, layers
from semantic_embeddings_torch.models import densenet
from semantic_embeddings_torch.models.pyramidnet import PyramidNet

BUILDS = [(arch, {}) for arch in JARCHITECTURES] + [
    ("resnet-110-selu", {}), ("simple-selu", {}),
    ("resnet-32", {"classification": True}), ("wrn-28-10", {"classification": True}),
    ("resnet-110", {"classification": True, "no_softmax": True}),
]


def _top_activation(module):
    if not getattr(module, "include_top", True):
        return "no top"
    return getattr(module, "top_activation", getattr(module, "final_activation", None))


def test_architecture_names_are_the_jax_packages():
    assert ARCHITECTURES == JARCHITECTURES


@pytest.mark.parametrize("arch,kw", BUILDS, ids=[
    arch + "".join(f"-{k}" for k in kw) for arch, kw in BUILDS])
def test_build_network_matches_jax(arch, kw):
    """Every parameter and BN statistic has the JAX build's name and shape
    (traced with ``jax.eval_shape``: nothing is initialised; the port's
    model lives on the meta device), hence the same parameter count; the
    same L2 rules, input size and top activation."""
    jspec = jbuild_network(100, arch, **kw)
    size = 32 if jspec.input_size == 32 else 64
    shapes = jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    with torch.device("meta"):
        spec = build_network(100, arch, **kw)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    # raises on any leaf without a counterpart, or of another shape
    converted = convert.flax_to_state_dict(zeros, spec.module)
    assert {k: v.shape for k, v in converted.items()} == {
        k: v.shape for k, v in spec.module.state_dict().items()}
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(zeros["params"]))
    assert sum(p.numel() for p in spec.module.parameters()) == n_jax
    assert spec.l2_filters == jspec.l2_filters
    assert spec.input_size == jspec.input_size
    assert _top_activation(spec.module) == _top_activation(jspec.module)


def _l2_case(name):
    if name == "simple":
        return jbuild_network(10, "simple").module, build_network(10, "simple").module, \
            "simple", 16
    if name == "densenet":
        kw = dict(classes=10, depth=10, growth_rate=4, bottleneck=True, reduction=0.5)
        return jdensenet.DenseNet(**kw), densenet.DenseNet(**kw), "densenet-bc-190-40", 16
    kw = dict(depth=20, alpha=24, bottleneck=True, classes=10)
    return JPyramidNet(**kw), PyramidNet(**kw), "pyramidnet-272-200", 16


@pytest.mark.parametrize("name", ["simple", "densenet", "pyramidnet"])
def test_l2_penalty_matches_jax(name):
    """The family's L2 rules (``simple``: every kernel but the top's;
    DenseNet: only the initial, bottleneck and transition convs; PyramidNet:
    every kernel) on the same weights, with the trainer's cls-head rule in
    front, in float64 in both frameworks (so that the sums of millions of
    squares agree to 1e-12, not to f32 rounding); and which kernels each
    rule picks."""
    jmodule, tmodule, arch, size = _l2_case(name)
    variables = pair(jmodule, tmodule, images((2, size, size, 3)))
    filters = [(r"^cls_top$", 5e-4)] + jbuild_network(10, arch).l2_filters
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])
        want = float(JModelSpec(arch, jmodule, filters).l2_penalty(params))
    got = ModelSpec(arch, tmodule, filters).l2_penalty(tmodule.double())
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-12)
    picked = {name for coef, mods in ModelSpec(arch, tmodule, filters)._l2_groups(tmodule)
              for name, m in tmodule.named_modules() if any(m is x for x in mods)}
    if name == "simple":
        assert "top" not in picked and "conv1" in picked and "fc14" in picked
    elif name == "densenet":
        assert picked == {"conv_init", "b0_l0_neck", "b1_l0_neck", "b2_l0_neck",
                          "b0_trans", "b1_trans"}
    else:
        assert "top" in picked and "stage3_block2.conv_c" in picked


# -- initializers ----------------------------------------------------------


@pytest.mark.parametrize("init,shape,std", [
    ("glorot_normal", (64, 32, 3, 3), np.sqrt(2.0 / (9 * 32 + 9 * 64))),
    ("lecun_normal", (64, 32, 3, 3), np.sqrt(1.0 / (9 * 32))),
    # depthwise: fan_in is the window alone (Flax's (5, 5, 1, C) kernel)
    ("lecun_normal", (256, 1, 5, 5), np.sqrt(1.0 / 25)),
])
def test_truncated_normal_inits_match_flax_distribution(init, shape, std):
    """Truncated at two standard deviations of the untruncated normal, the
    std after truncation sqrt(scale / fan), as jax's initializer of the
    same (H, W, I, O) kernel."""
    w = torch.empty(shape)
    layers.KERNEL_INITS[init](w, torch.Generator().manual_seed(0))
    w = w.numpy()
    o, i, h, k = shape
    ref = np.asarray(getattr(jax.nn.initializers, init)()(
        jax.random.PRNGKey(0), (h, k, i, o)))
    np.testing.assert_allclose(w.std(), std, rtol=0.03)
    np.testing.assert_allclose(ref.std(), std, rtol=0.03)
    bound = 2 * std / 0.87962566103423978
    assert np.abs(w).max() <= bound * (1 + 1e-6) and np.abs(ref).max() <= bound * (1 + 1e-6)
    assert np.abs(w).max() > 0.95 * bound


def test_keras_uniform_matches_jax_distribution():
    w = torch.empty(20000)
    layers.keras_uniform_(w, torch.Generator().manual_seed(0))
    ref = np.asarray(jlayers.keras_uniform(jax.random.PRNGKey(0), (20000,)))
    for a in (w.numpy(), ref):
        assert -0.05 <= a.min() < -0.0495 and 0.0495 < a.max() <= 0.05
        np.testing.assert_allclose(a.std(), 0.1 / np.sqrt(12), rtol=0.03)


# -- layers ----------------------------------------------------------------


@pytest.mark.parametrize("size", [9, 8])
@pytest.mark.parametrize("kernel,stride,groups", [(5, 2, 1), (7, 2, 1), (3, 2, 6), (5, 1, 6),
                                                  (7, 2, 6)])
def test_grouped_strided_same_conv_matches_flax(size, kernel, stride, groups):
    """TF SAME with more padding after than before, at stride 2 with 5x5
    and 7x7 kernels, plain and depthwise (``feature_group_count``)."""
    x = images((2, size, size, 6))
    jconv = fnn.Conv(6, (kernel, kernel), strides=(stride, stride), padding="SAME",
                     feature_group_count=groups, use_bias=False)
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jconv.apply(v, jnp.asarray(x)))
    tconv = layers.conv(6, 6, kernel, stride, use_bias=False, groups=groups)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(convert._kernel_to_torch(
            np.asarray(v["params"]["kernel"])).copy()))
        out = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("window,stride,count_include_pad", [
    (3, 1, False), (3, 2, False), (3, 2, True), (2, 2, False)])
def test_same_pools_match_flax(size, window, stride, count_include_pad):
    """SAME average pools dividing by the cells inside the image, or by the
    window; SAME max pools whose padding never wins."""
    x = images((2, size, size, 3))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def nhwc(y):
        return y.permute(0, 2, 3, 1).numpy()

    ref = jlayers.avg_pool(jnp.asarray(x), window, stride, "SAME", count_include_pad)
    got = layers.avg_pool(xt, window, stride, "SAME", count_include_pad)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-6, atol=1e-6)
    ref = jlayers.max_pool(jnp.asarray(x) - 10.0, window, stride, "SAME")
    got = layers.max_pool(xt - 10.0, window, stride, "SAME")
    np.testing.assert_array_equal(nhwc(got), np.asarray(ref))


@pytest.mark.parametrize("size", [7, 8])
def test_zero_pad_same_matches_nasnet(size):
    """A reduction cell's zero padding: its max pool sees zeros at the
    border, its 3x3/2 average divides by 9."""
    x = images((2, size, size, 3)) - 5.0
    ref = np.asarray(jnasnet._zeropad_same(jnp.asarray(x), 3, 2))
    got = layers.zero_pad_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    pooled = layers.max_pool(got, 3, 2)
    assert (pooled.amax(dim=(0, 1)) == 0).any()


@pytest.mark.parametrize("size,kernel,stride", [(4, 3, 2), (5, 3, 2), (4, 2, 2), (3, 3, 3),
                                                (4, 4, 2)])
def test_conv_transpose_matches_flax(size, kernel, stride):
    """Flax's ``ConvTranspose`` (SAME, kernel not flipped) through
    ``F.conv_transpose2d`` with the kernel flipped by ``convert``."""
    x = images((2, size, size, 3))
    jconv = fnn.ConvTranspose(5, (kernel, kernel), strides=(stride, stride), padding="SAME")
    v = jax.tree_util.tree_map(np.asarray, jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bias"] = np.random.default_rng(0).normal(size=5).astype(np.float32)
    ref = np.asarray(jconv.apply(v, jnp.asarray(x)))
    tconv = layers.ConvTranspose2dSame(3, 5, kernel, stride)
    convert.load_flax_variables(tconv, v)
    with torch.no_grad():
        out = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.shape[2] == size * stride
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
    back = flat(convert.state_dict_to_flax(tconv))
    np.testing.assert_array_equal(back["params/kernel"], v["params"]["kernel"])
