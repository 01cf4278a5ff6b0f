"""Bridge between the JAX package's Flax variables and the port's ``state_dict``.

The port's module names follow the Flax tree in every family (``conv0``,
``bn0``, ``stage{s}_block{b}/{conv,bn}_{a,b}``, ``b0_l3_grow``,
``cell_7/left1/dw0``, ``top``, ...), so leaves map by path:

- conv ``kernel`` (H, W, I/g, O) <-> ``weight`` (O, I/g, H, W) (depthwise:
  (H, W, 1, C) <-> (C, 1, H, W))
- transposed conv ``kernel`` (H, W, I, O) <-> ``weight`` (I, O, H, W)
  flipped in H and W (:class:`..models.layers.ConvTranspose2dSame`)
- dense ``kernel`` (in, out)     <-> ``weight`` (out, in)
- ``bias``                       <-> ``bias``
- BN ``scale`` / ``bias``        <-> ``weight`` / ``bias``
- BN ``mean`` / ``var`` (batch_stats) <-> ``running_mean`` / ``running_var``
- a parameter of the model itself (the learners' ``labelembeddings`` and
  ``cls_centroids``) <-> the parameter of that name, as it is

``KerasBatchNorm`` wraps a Flax ``nn.BatchNorm`` named ``BatchNorm_0``; that
level has no counterpart in the port.  Both directions raise on any leaf
left unmapped on either side.  Arrays cross as numpy; this module imports
no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_LEVEL = "BatchNorm_0"
_TO_TORCH = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for key, sub in tree.items():
            yield from _flatten(sub, prefix + (str(key),))
    else:
        yield prefix, tree


def _kernel_to_torch(a, transposed=False):
    if a.ndim == 4 and transposed:  # HWIO -> IOHW, flipped in H and W
        return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:  # (in, out) -> (out, in)
        return a.T
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def _kernel_to_flax(a, transposed=False):
    if a.ndim == 4 and transposed:  # IOHW flipped in H and W -> HWIO
        return a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if a.ndim == 4:  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def flax_to_state_dict(variables, model):
    """Returns a ``state_dict`` for ``model`` from Flax ``variables``
    (``{'params': ..., 'batch_stats': ...}`` of numpy-convertible leaves)."""
    from torch import nn

    target = model.state_dict()
    transposed = {name for name, m in model.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            *modules, name = path
            modules = [m for m in modules if m != _BN_LEVEL]
            torch_name = _TO_TORCH.get((collection, name))
            if torch_name is None and collection == "params" and not modules:
                torch_name = name  # a model's own parameter keeps its name
            key = ".".join(modules + [torch_name or name])
            if torch_name is None or key not in target:
                raise KeyError(
                    f"Flax leaf {collection}/{'/'.join(path)} has no "
                    f"counterpart in {type(model).__name__} (looked for {key!r})")
            a = np.array(leaf, dtype=np.float32)  # a writable copy
            if name == "kernel":
                a = _kernel_to_torch(a, ".".join(modules) in transposed)
            ref = target[key]
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(
                    f"{key}: Flax leaf of shape {a.shape} does not fit "
                    f"{tuple(ref.shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(ref.dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"state_dict entries with no Flax leaf: {missing}")
    return out


def load_flax_variables(model, variables):
    """Loads Flax ``variables`` into ``model`` in place; returns ``model``."""
    sd = flax_to_state_dict(variables, model)
    model.load_state_dict(sd, strict=True)
    return model


def state_dict_to_flax(model):
    """Returns ``{'params': ..., 'batch_stats': ...}`` nested dicts of numpy
    arrays, in the JAX package's tree layout, from ``model``."""
    from torch import nn

    from .models.layers import KerasBatchNorm

    kinds = {name: m for name, m in model.named_modules()}
    variables = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        *modules, name = key.split(".")
        module = kinds.get(".".join(modules))
        a = value.detach().cpu().float().numpy()
        if isinstance(module, KerasBatchNorm):
            collection, leaf = {
                "weight": ("params", "scale"),
                "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var"),
            }.get(name, (None, None))
            modules = modules + [_BN_LEVEL]
        elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            collection, leaf = {
                "weight": ("params", "kernel"),
                "bias": ("params", "bias"),
            }.get(name, (None, None))
            if leaf == "kernel":
                a = _kernel_to_flax(a, isinstance(module, nn.ConvTranspose2d))
        elif not modules and name in dict(model.named_parameters()):
            collection, leaf = "params", name
        else:
            collection = leaf = None
        if collection is None:
            raise KeyError(f"state_dict entry {key!r} has no Flax counterpart")
        node = variables[collection]
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return variables
