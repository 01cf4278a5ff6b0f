"""The port's model families (PlainNet, WideResNet, PyramidNet, DenseNet,
DenseNetFCN) against the JAX package's, at small sizes, from the same
weights and inputs: eval and train forwards, the new running statistics and
float64 gradients (tolerances in ``_torch_zoo_common``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_common import check_forward, check_gradients, images, pair, reference
from semantic_embeddings_tpu.models import densenet as jdensenet
from semantic_embeddings_tpu.models.plainnet import PlainNet as JPlainNet
from semantic_embeddings_tpu.models.pyramidnet import PyramidNet as JPyramidNet
from semantic_embeddings_tpu.models.wrn import WideResNet as JWideResNet
from semantic_embeddings_torch.models import densenet
from semantic_embeddings_torch.models.plainnet import PlainNet
from semantic_embeddings_torch.models.pyramidnet import PyramidNet
from semantic_embeddings_torch.models.wrn import WideResNet

SIZE, BATCH = 16, 4

FAMILIES = {
    # every spec kind: conv, both pools, global pooling, a dense layer
    "plainnet": (lambda: JPlainNet(10, filters=(8, "ap", 12, "mp", 16, "gap", "fc12")),
                 lambda: PlainNet(10, filters=(8, "ap", 12, "mp", 16, "gap", "fc12"))),
    # a dense layer on the flattened map (NHWC order), and SELU
    "plainnet-flat-selu": (
        lambda: JPlainNet(10, filters=(8, "ap", 8, "fc12"), activation="selu"),
        lambda: PlainNet(10, filters=(8, "ap", 8, "fc12"), activation="selu",
                         input_size=SIZE)),
    "plainnet-softmax": (
        lambda: JPlainNet(10, filters=(8, "mp", 8, "gap"), final_activation="softmax"),
        lambda: PlainNet(10, filters=(8, "mp", 8, "gap"), final_activation="softmax")),
    "wrn": (lambda: JWideResNet(classes=10, n_blocks=2, width=2, final_activation=None),
            lambda: WideResNet(classes=10, n_blocks=2, width=2, final_activation=None)),
    "pyramidnet-bottleneck": (
        lambda: JPyramidNet(depth=20, alpha=24, bottleneck=True, classes=10,
                            top_activation=None),
        lambda: PyramidNet(depth=20, alpha=24, bottleneck=True, classes=10,
                           top_activation=None)),
    "pyramidnet-basic-selu": (
        lambda: JPyramidNet(depth=14, alpha=12, bottleneck=False, classes=10,
                            top_activation=None, activation="selu"),
        lambda: PyramidNet(depth=14, alpha=12, bottleneck=False, classes=10,
                           top_activation=None, activation="selu")),
    "densenet-bc": (
        lambda: jdensenet.DenseNet(classes=10, depth=10, growth_rate=4, bottleneck=True,
                                   reduction=0.5, top_activation=None),
        lambda: densenet.DenseNet(classes=10, depth=10, growth_rate=4, bottleneck=True,
                                  reduction=0.5, top_activation=None)),
    "densenet": (
        lambda: jdensenet.DenseNet(classes=10, depth=10, growth_rate=4, nb_filter=6,
                                   top_activation=None),
        lambda: densenet.DenseNet(classes=10, depth=10, growth_rate=4, nb_filter=6,
                                  top_activation=None)),
    # the default softmax top, one layer a block
    "densenet-softmax": (
        lambda: jdensenet.DenseNet(classes=10, depth=7, growth_rate=4),
        lambda: densenet.DenseNet(classes=10, depth=7, growth_rate=4)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(torch module, variables, the JAX module's results) of one family."""
    jmake, tmake = FAMILIES[request.param]
    jmodule, tmodule = jmake(), tmake()
    x = images((BATCH, SIZE, SIZE, 3))
    variables = pair(jmodule, tmodule, x)
    return tmodule, variables, reference(jmodule, variables, x)


def test_family_forward_and_stats_match_jax(family):
    check_forward(*family)


def test_family_gradients_match_jax_f64(family):
    check_gradients(*family)


def test_family_parameter_count_and_width(family):
    tmodule, variables, ref = family
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in tmodule.parameters()) == n_jax
    assert tmodule.out_features == ref["eval"].shape[-1]


FCN = dict(classes=5, nb_dense_block=2, growth_rate=4, layers_per_block=2,
           init_conv_filters=6)


@pytest.mark.parametrize("upsampling", ["deconv", "subpixel", "upsampling"])
def test_densenet_fcn_matches_jax(upsampling):
    """The fully convolutional DenseNet down two blocks and back up, with
    each upsampling: the transposed conv's flipped kernel and SAME padding,
    the sub-pixel channel order and nearest-neighbour resizing."""
    jmodule = jdensenet.DenseNetFCN(**FCN, upsampling_type=upsampling)
    tmodule = densenet.DenseNetFCN(**FCN, upsampling_type=upsampling)
    x = images((2, 8, 8, 3))
    variables = pair(jmodule, tmodule, x)
    check_forward(tmodule, variables, reference(jmodule, variables, x, gradients=False))


def test_densenet_fcn_gradients_match_jax_f64():
    kw = dict(classes=5, nb_dense_block=1, growth_rate=3, layers_per_block=2,
              init_conv_filters=4, upsampling_type="deconv", top_activation=None)
    jmodule, tmodule = jdensenet.DenseNetFCN(**kw), densenet.DenseNetFCN(**kw)
    x = images((2, 6, 6, 3))
    variables = pair(jmodule, tmodule, x)
    check_gradients(tmodule, variables, reference(jmodule, variables, x))


@pytest.mark.parametrize("scale,shape", [(2, (2, 5, 3, 12)), (3, (1, 2, 4, 18))])
def test_sub_pixel_upscale_matches_jax(scale, shape):
    """Channel (i * s + j) * oc + c lands at offset (i, j) of channel c;
    ``F.pixel_shuffle`` orders the channels otherwise."""
    x = images(shape)
    want = np.asarray(jdensenet.sub_pixel_upscale(jnp.asarray(x), scale))
    got = densenet.sub_pixel_upscale(torch.from_numpy(x).permute(0, 3, 1, 2), scale)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    shuffled = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(shuffled, want)
