"""The port's ImageNet ResNets as built: ``convert``'s exact round trip,
every parameter's and statistic's shape and the BN settings against the JAX
build, the published backbone size, the layers they added (He-normal init,
the VALID stem conv and max-pool) and the CLI on the CPU.  Their numerics
against the JAX package's from the same weights: tests/test_torch_resnet.py."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from semantic_embeddings_tpu.embeddings import load_features, save_embeddings
from semantic_embeddings_tpu.models import build_network as jbuild_network
from semantic_embeddings_tpu.models import layers as jlayers
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.cli import learn_image_embeddings
from semantic_embeddings_torch.models import build_network, layers

CLASSES = 10


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch", ["rn18", "resnet-50"])
def test_convert_round_trips_exactly(arch):
    model = build_network(CLASSES, arch, generator=torch.Generator().manual_seed(0)).module
    variables = convert.state_dict_to_flax(model)
    flat = _flat(variables)
    for key in ("conv0/kernel", "top/kernel", "stage1_block1/bn_sc/BatchNorm_0/scale",
                "stage4_block2/conv_b/kernel"):
        assert "params/" + key in flat, key
    assert "batch_stats/stage4_block2/bn_b/BatchNorm_0/var" in flat
    again = build_network(CLASSES, arch, generator=torch.Generator().manual_seed(1)).module
    convert.load_flax_variables(again, variables)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    back = _flat(convert.state_dict_to_flax(again))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.fixture(scope="module")
def networks():
    """``build_network(100, arch)`` by name, each built once for the module
    (its tests only read them)."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = build_network(100, arch)
        return built[arch]

    return get


@pytest.mark.parametrize("arch", [
    "resnet-50", "resnet-101", "resnet-152", "rn18", "rn34", "rn50", "rn101"])
def test_build_network_matches_jax_shapes_and_settings(arch, networks):
    """Every parameter and BN statistic has the JAX package's shape; the BN
    epsilon (1.001e-5 for resnet-101/152, else 1e-3), the empty L2 filter
    list and the input size match."""
    jspec = jbuild_network(100, arch)
    shapes = jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    spec = networks(arch)
    want = {k: tuple(v.shape) for k, v in convert.flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
        spec.module).items()}
    assert {k: tuple(v.shape) for k, v in spec.module.state_dict().items()} == want
    assert spec.l2_filters == jspec.l2_filters == []
    assert spec.input_size == jspec.input_size == 224
    eps = {m.epsilon for m in spec.module.modules()
           if isinstance(m, layers.KerasBatchNorm)}
    assert eps == {jspec.module.bn_epsilon}


def test_resnet50_backbone_size(networks):
    """Published widths: 23,508,032 backbone parameters, plus the top."""
    module = networks("resnet-50").module
    n = sum(p.numel() for name, p in module.named_parameters()
            if not name.startswith("top."))
    assert n == 23_508_032


def test_he_normal_matches_flax_distribution():
    """Truncated at two standard deviations of the untruncated normal, with
    the variance 2 / fan_in after truncation, as jax's he_normal."""
    conv = layers.conv(64, 128, 3, kernel_init="he_normal",
                       generator=torch.Generator().manual_seed(0))
    w = conv.weight.detach().numpy()
    ref = np.asarray(jax.nn.initializers.he_normal()(
        jax.random.PRNGKey(0), (3, 3, 64, 128)))
    std = np.sqrt(2.0 / (9 * 64))
    np.testing.assert_allclose(w.std(), std, rtol=0.02)
    np.testing.assert_allclose(ref.std(), std, rtol=0.02)
    bound = 2 * std / 0.87962566103423978
    assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound * (1 + 1e-6)
    assert np.abs(w).max() > 0.95 * bound


@pytest.mark.parametrize("size", [8, 7])
def test_valid_conv_and_max_pool_match_flax(size):
    """The stem's VALID 7x7/2 conv and the pool's VALID 3x3/2 max-pool."""
    x = np.random.default_rng(2).normal(size=(2, size + 6, size + 6, 3)).astype(
        np.float32)
    jconv = fnn.Conv(5, (7, 7), strides=(2, 2), padding="VALID", use_bias=False)
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jconv.apply(v, jnp.asarray(x)))
    tconv = layers.conv(3, 5, 7, 2, use_bias=False, padding="VALID")
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        out = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    pooled = layers.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(pooled.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jlayers.max_pool(jnp.asarray(x), 3, 2)))


def test_cli_trains_resnet50_on_cpu(tmp_path):
    """One epoch of resnet-50 on 32-px synthetic images, as the JAX CLI
    runs it on the CPU: the ResNet's top emits the embedding's width."""
    rng = np.random.default_rng(0)
    e = rng.normal(size=(10, 16))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    save_embeddings(str(tmp_path / "emb.pickle"), list(range(10)), e)
    feat = str(tmp_path / "feat.pickle")
    state = learn_image_embeddings.main([
        "--dataset", "synthetic-10-32-16", "--data_root", str(tmp_path),
        "--embedding", str(tmp_path / "emb.pickle"), "--architecture", "resnet-50",
        "--loss", "inv_corr", "--cls_weight", "0.1", "--fused_loss",
        "--batch_size", "16", "--epochs", "1", "--feature_dump", feat,
        "--device", "cpu", "--no_progress"])
    assert state.step == 2 and state.epoch == 1
    _, feats = load_features(feat)
    assert feats.shape == (16, 16) and np.isfinite(feats).all()
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
