"""The port's ImageNet ResNets against the JAX package's, from the same
weights (through ``semantic_embeddings_torch.convert``) and the same inputs:
train- and eval-mode forward, gradients and the new BN running statistics.
How they are built (shapes, ``convert``, the layers they added) and the CLI
on the CPU: tests/test_torch_resnet_build.py."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.models import build_network as jbuild_network
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.models import build_network
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


@pytest.fixture(scope="module")
def loaded(case):
    """The port's model of ``case``'s architecture holding its JAX weights,
    built once for the module: each test takes a copy."""
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


def test_forward_gradients_and_stats_match_jax(case, loaded):
    x = torch.from_numpy(case["x"])
    for precision, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        model = copy.deepcopy(loaded).to(dtype)
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


def test_forward_runs_the_fused_op_in_every_block(case, loaded):
    """Each block's conv_b + bn_b runs the fused op once per forward; with
    use_plain_conv_bn_stats the reference op gives the same result."""
    from semantic_embeddings_torch.models import resnet

    model = copy.deepcopy(loaded)
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
