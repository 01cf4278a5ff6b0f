"""The port's ImageNet ResNets against the JAX package's, from the same
weights (through ``semantic_embeddings_torch.convert``) and the same inputs:
train- and eval-mode forward, gradients and the new BN running statistics;
plus the layers they added and the CLI on the CPU."""

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
from semantic_embeddings_torch.ops import conv3x3


def _randomize_bn(variables, seed=0):
    """BN scale/bias/mean/var replaced by random values (variances
    positive), so that no leaf passes a comparison by being its initial
    constant; conv and dense kernels keep their (random) init."""
    rng = np.random.default_rng(seed)
    draw = {
        "var": lambda s: rng.uniform(0.5, 2.0, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "mean": lambda s: rng.normal(size=s) * 0.1,
        "bias": lambda s: rng.normal(size=s) * 0.1,
    }

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        return (draw[name](a.shape) if name in draw else a).astype(np.float32)

    return walk(variables)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


SIZE, BATCH, CLASSES = 64, 2, 10


@pytest.fixture(scope="module", params=["rn18", "resnet-50"])
def case(request):
    """For one architecture at 64 px, batch 2: the JAX model's variables and
    its eval and train outputs in f32; in f64, its eval and train outputs,
    the new batch statistics and the gradients of sum(train output * R)."""
    arch = request.param
    module = jbuild_network(CLASSES, arch).module
    variables = jax.jit(lambda k: module.init(
        k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
    variables = _randomize_bn(jax.device_get(variables))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    r = rng.normal(size=(BATCH, CLASSES)).astype(np.float32)

    def train(params, stats, x, r):
        out, new = module.apply({"params": params, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, new["batch_stats"])

    def evaluate(variables, x):
        return module.apply(variables, x, train=False)

    want = {"f32": (jax.jit(evaluate)(variables, x),
                    jax.jit(train)(variables["params"], variables["batch_stats"],
                                   x, r)[1][0])}
    with jax.enable_x64(True):
        v64, x64, r64 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), (variables, x, r))
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(train, has_aux=True))(
            v64["params"], v64["batch_stats"], x64, r64)
        want["f64"] = (jax.jit(evaluate)(v64, x64), out)
        want = jax.device_get(want)
        stats, grads = jax.device_get((stats, grads))
    return dict(arch=arch, variables=variables, x=x, r=r, outputs=want,
                new_stats=stats, grads=grads)


def _torch_model(case):
    model = build_network(CLASSES, case["arch"]).module
    return convert.load_flax_variables(model, case["variables"])


# Tolerances, measured against each framework's own f64 result: in f32 the
# BNs over 8-32 elements per channel in stages 3-4 amplify rounding by
# 1 / sigma of their input, through 18-50 layers, so that JAX's own f32
# outputs differ from its f64 ones by up to 2.8e-5 (rn18) and 4.4e-4
# (resnet-50) here; the port's f32 outputs are held to 2e-3.  At batch 2
# the f32 gradients are dominated by that rounding (JAX's own differ from
# its f64 ones by up to 0.4 of a tensor's largest entry), so outputs, the
# new statistics and the gradients are held tightly in f64, where the two
# frameworks compute the same function to ~1e-12.
OUT_TOL = {"f32": dict(rtol=0, atol=2e-3), "f64": dict(rtol=0, atol=1e-10)}
STATS_TOL = dict(rtol=1e-10, atol=1e-12)
GRAD_REL = 1e-9


def test_forward_gradients_and_stats_match_jax(case):
    x = torch.from_numpy(case["x"])
    for precision, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        model = _torch_model(case).to(dtype)
        want_eval, want_train = case["outputs"][precision]
        model.eval()
        with torch.no_grad():
            np.testing.assert_allclose(model(x.to(dtype)).numpy(), want_eval,
                                       **OUT_TOL[precision])
        model.train()
        out = model(x.to(dtype))
        np.testing.assert_allclose(out.detach().numpy(), want_train,
                                   **OUT_TOL[precision])

    # the last model is the f64 one, after one train-mode forward
    want = _f64_by_torch_name(case["new_stats"], "batch_stats")
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(want)
    for name, got in buffers.items():
        torch.testing.assert_close(got, want[name], **STATS_TOL, msg=name)
    (out * torch.from_numpy(case["r"]).double()).sum().backward()
    params = dict(model.named_parameters())
    want = _f64_by_torch_name(case["grads"], "params")
    assert sorted(params) == sorted(want)
    for name, p in params.items():
        scale = want[name].abs().max().item()
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=GRAD_REL * scale, msg=name)


def _f64_by_torch_name(tree, collection):
    """A Flax collection (gradients or batch statistics) in the port's names
    and layouts, kept in f64 (``convert`` carries values in f32)."""
    out = {}
    for path, leaf in convert._flatten(tree):
        *modules, name = path
        key = ".".join([m for m in modules if m != convert._BN_LEVEL]
                       + [convert._TO_TORCH[collection, name]])
        a = np.array(leaf, np.float64)
        if name == "kernel":
            a = convert._kernel_to_torch(a)
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def test_forward_runs_the_fused_op_in_every_block(case):
    """Each block's conv_b + bn_b runs the fused op once per forward; with
    use_plain_conv_bn_stats the reference op gives the same result."""
    from semantic_embeddings_torch.models import resnet

    model = _torch_model(case)
    calls = []

    def counting(x, w):
        calls.append(tuple(w.shape))
        return conv3x3.conv3x3_bn_stats(x, w)

    for m in model.modules():
        if isinstance(m, resnet._Block):
            m.conv_bn_stats = counting
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        out = model(x)
    blocks = sum(resnet.STAGE_BLOCKS[50 if case["arch"] == "resnet-50" else 18])
    assert len(calls) == blocks and all(s[2:] == (3, 3) for s in calls)
    resnet.use_plain_conv_bn_stats(model)
    with torch.no_grad():
        torch.testing.assert_close(model(x), out, rtol=0, atol=0)


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


@pytest.mark.parametrize("arch", [
    "resnet-50", "resnet-101", "resnet-152", "rn18", "rn34", "rn50", "rn101"])
def test_build_network_matches_jax_shapes_and_settings(arch):
    """Every parameter and BN statistic has the JAX package's shape; the BN
    epsilon (1.001e-5 for resnet-101/152, else 1e-3), the empty L2 filter
    list and the input size match."""
    jspec = jbuild_network(100, arch)
    shapes = jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    spec = build_network(100, arch)
    want = {k: tuple(v.shape) for k, v in convert.flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
        spec.module).items()}
    assert {k: tuple(v.shape) for k, v in spec.module.state_dict().items()} == want
    assert spec.l2_filters == jspec.l2_filters == []
    assert spec.input_size == jspec.input_size == 224
    eps = {m.epsilon for m in spec.module.modules()
           if isinstance(m, layers.KerasBatchNorm)}
    assert eps == {jspec.module.bn_epsilon}


def test_resnet50_backbone_size():
    """Published widths: 23,508,032 backbone parameters, plus the top."""
    module = build_network(100, "resnet-50").module
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
