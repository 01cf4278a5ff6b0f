"""Shared by the model-zoo parity tests: one Flax module and its port from
the same weights (carried over by ``semantic_embeddings_torch.convert``),
held together in the eval and train forwards, the new BatchNorm running
statistics and, in float64, every parameter's gradient."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from semantic_embeddings_torch import convert

# f32 outputs (and the new running statistics) within this fraction of
# the largest |value| of the JAX result: two frameworks summing the same
# convolutions and BN reductions in other orders, through a few layers.
F32_OF_MAX = 1e-5
# f64 train outputs and statistics within this fraction of the largest
# |value|: the same function in float64 in both frameworks.
F64_OF_MAX = 1e-10
# f64 gradients within this fraction of each tensor's largest |gradient|,
# plus F64_GRAD_FLOOR of the model's largest (a gradient that is zero in
# exact arithmetic, such as a BN bias before another BN, comes out as
# rounding, ~1e-15): the same function in float64 in both frameworks.
F64_GRAD_OF_MAX = 1e-9
F64_GRAD_FLOOR = 1e-12


def randomize(variables, seed=0):
    """BN scale/bias/mean/var and every bias replaced by random values
    (variances positive), so that no leaf passes a comparison by being its
    initial constant; kernels keep their (random) initial draws."""
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


def flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


def torch_layout(tree, collection, model):
    """A Flax collection (gradients or statistics) in the port's names and
    layouts, in float64."""
    transposed = {name for name, m in model.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    out = {}
    for path, leaf in convert._flatten(tree):
        *modules, name = path
        modules = [m for m in modules if m != convert._BN_LEVEL]
        key = ".".join(modules + [convert._TO_TORCH[collection, name]])
        a = np.array(leaf, np.float64)
        if name == "kernel":
            a = convert._kernel_to_torch(a, ".".join(modules) in transposed)
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def assert_close_of_max(got, want, of_max, what=""):
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= of_max * scale, f"{what}: max |diff| {err:.3g} > {of_max} x {scale:.3g}"


def images(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def pair(jmodule, tmodule, x, seed=0):
    """The port's initial weights in the JAX package's tree (whose every
    leaf name and shape must be the Flax module's own, from
    ``jax.eval_shape`` of its init, so nothing is compiled), with the
    constant leaves randomized, loaded back into ``tmodule``; returns the
    variables."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 train=False))
    variables = convert.state_dict_to_flax(tmodule)
    want = flat(shapes, leaf=lambda s: tuple(s.shape))
    assert flat(variables, leaf=lambda a: a.shape) == want
    variables = randomize(variables, seed)
    convert.load_flax_variables(tmodule, variables)
    return variables


def reference(jmodule, variables, x, gradients=True, seed=2):
    """The JAX module's results on ``x``, in one compiled f32 program (eval
    output and sown taps, train output and new statistics) and, with
    ``gradients``, one f64 program: the train output, the new statistics
    and every parameter's gradient of sum(train output * R), R random from
    ``seed``."""

    def forward(v, x):
        out, taps = jmodule.apply(v, x, train=False, mutable=["intermediates"])
        train_out, new = jmodule.apply(v, x, train=True, mutable=["batch_stats"])
        return out, taps.get("intermediates", {}), train_out, new["batch_stats"]

    out, taps, train_out, stats = jax.device_get(jax.jit(forward)(variables, x))
    ref = dict(eval=out, taps={k: v[0] for k, v in taps.items()}, train=train_out,
               stats=stats, x=x)
    if not gradients:
        return ref
    r = np.random.default_rng(seed).normal(size=train_out.shape)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss(params, x):
            out, new = jmodule.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                     x, train=True, mutable=["batch_stats"])
            return jnp.sum(out * r), (out, new["batch_stats"])

        (_, (ref["train64"], ref["stats64"])), ref["grads"] = jax.device_get(
            jax.jit(jax.value_and_grad(loss, has_aux=True))(
                v64["params"], np.asarray(x, np.float64)))
    ref["r"] = r
    return ref


def check_forward(tmodule, variables, ref, of_max=F32_OF_MAX, train_of_max=F32_OF_MAX):
    """Eval and train forwards in f32, the eval forward's taps, and the
    running statistics after the train forward (``train_of_max`` for the
    train output, where train-mode BN over few values a channel amplifies
    f32 rounding; :func:`check_gradients` holds it in f64)."""
    convert.load_flax_variables(tmodule, variables)
    xt = torch.from_numpy(ref["x"])
    tmodule.eval()
    taps = {}
    with torch.no_grad():
        assert_close_of_max(tmodule(xt, taps) if ref["taps"] else tmodule(xt), ref["eval"],
                            of_max, "eval output")
    assert sorted(taps) == sorted(ref["taps"])
    for name, value in taps.items():
        assert_close_of_max(value, ref["taps"][name], of_max, f"tap {name}")
    tmodule.train()
    with torch.no_grad():
        assert_close_of_max(tmodule(xt), ref["train"], train_of_max, "train output")
    got = flat(convert.state_dict_to_flax(tmodule)["batch_stats"])
    want = flat(ref["stats"])
    assert sorted(got) == sorted(want)
    for key in want:
        assert_close_of_max(got[key], want[key], of_max, key)


def check_gradients(tmodule, variables, ref):
    """In float64 in both frameworks, from the same weights: the train
    output, the new running statistics and every parameter's gradient of
    sum(train output * R)."""
    model = copy.deepcopy(tmodule).float()
    convert.load_flax_variables(model, variables)
    model.double().train()
    x64 = torch.from_numpy(np.asarray(ref["x"], np.float64))
    out = model(x64)
    assert_close_of_max(out, ref["train64"], F64_OF_MAX, "f64 train output")
    stats = torch_layout(ref["stats64"], "batch_stats", model)
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(stats)
    for name, value in buffers.items():
        assert_close_of_max(value, stats[name].numpy(), F64_OF_MAX, f"f64 {name}")
    (out * torch.from_numpy(ref["r"])).sum().backward()
    want = torch_layout(ref["grads"], "params", model)
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(want)
    floor = F64_GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, p in params.items():
        atol = F64_GRAD_OF_MAX * want[name].abs().max().item() + floor
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=atol, msg=name)
