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
level has no counterpart in the port.  :func:`leaf_map` maps each entry of
a model's ``state_dict`` to its Flax leaf; the whole-tree functions are
built on it and raise on any leaf left unmapped on either side, while
:func:`flax_to_state_dict` also takes a part of a tree (a Keras
import).  :func:`flax_tree_to_state_dict` names a tree's leaves with no
model (a JAX checkpoint, before its model is built).  Arrays cross as
numpy; this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_LEVEL = "BatchNorm_0"
# a module's state_dict entries -> (collection, Flax leaf name)
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
_DENSE_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_TO_TORCH = {leaf: name for leaves in (_DENSE_LEAVES, _BN_LEAVES)
             for name, leaf in leaves.items()}


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


def leaf_map(model):
    """The per-leaf map: ``{state_dict name: (collection, Flax path,
    kind)}`` for every entry of ``model.state_dict()``, where ``kind`` is
    ``"kernel"`` (a conv or dense kernel), ``"kernel_t"`` (a transposed
    conv's) or ``None`` (the same layout on both sides).  Raises
    ``KeyError`` for an entry with no Flax counterpart."""
    from torch import nn

    from .models.layers import KerasBatchNorm

    kinds = dict(model.named_modules())
    own = dict(model.named_parameters(recurse=False))
    out = {}
    for key in model.state_dict():
        *modules, name = key.split(".")
        module = kinds.get(".".join(modules))
        kind = None
        if isinstance(module, KerasBatchNorm):
            collection, leaf = _BN_LEAVES.get(name, (None, None))
            modules = modules + [_BN_LEVEL]
        elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            collection, leaf = _DENSE_LEAVES.get(name, (None, None))
            if leaf == "kernel":
                kind = "kernel_t" if isinstance(module, nn.ConvTranspose2d) else "kernel"
        elif not modules and name in own:
            collection, leaf = "params", name
        else:
            collection = leaf = None
        if collection is None:
            raise KeyError(f"state_dict entry {key!r} has no Flax counterpart")
        out[key] = (collection, tuple(modules) + (leaf,), kind)
    return out


def leaf_to_tensor(leaf, kind, ref=None):
    """A Flax leaf (a numpy-convertible array, or a bfloat16 tensor of a
    msgpack file) as a tensor in the layout of its ``state_dict`` entry and
    the dtype of ``ref``, that entry (float32 without it)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.float().numpy()
    a = np.array(leaf, dtype=np.float32)  # a writable copy
    if kind:
        a = _kernel_to_torch(a, kind == "kernel_t")
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if ref is None else out.to(ref.dtype)


def flax_tree_to_state_dict(variables):
    """The ``state_dict`` that Flax ``variables`` give without a model: each
    leaf under the name :func:`leaf_map` gives it (the ``BatchNorm_0``
    level dropped, the leaf renamed), a kernel in a conv's or a dense
    layer's layout.  A transposed conv's kernel needs its model
    (:func:`flax_to_state_dict`); no model rebuilt from a checkpoint has
    one (``DenseNetFCN`` is no architecture of ``build_network``)."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            *modules, name = path
            modules = [m for m in modules if m != _BN_LEVEL]
            torch_name = _TO_TORCH.get((collection, name))
            if torch_name is None and collection == "params" and not modules:
                torch_name = name  # a parameter of the model itself keeps its name
            if torch_name is None:
                raise KeyError(f"Flax leaf {collection}/{'/'.join(path)} has no "
                               "state_dict name")
            out[".".join(modules + [torch_name])] = leaf_to_tensor(
                leaf, "kernel" if name == "kernel" else None)
    return out


def flax_shape(shape, kind):
    """The Flax leaf's shape of a ``state_dict`` entry of ``shape``."""
    shape = tuple(shape)
    if kind == "kernel_t":  # IOHW -> HWIO
        return shape[2:] + shape[:2]
    if kind and len(shape) == 4:  # OIHW -> HWIO
        return shape[2:] + (shape[1], shape[0])
    return shape[::-1] if kind else shape


def flax_to_state_dict(variables, model, complete=True):
    """Returns a ``state_dict`` for ``model`` from Flax ``variables``
    (``{'params': ..., 'batch_stats': ...}`` of numpy-convertible leaves),
    each leaf in its entry's layout and dtype.  Every leaf must have a
    counterpart of its shape in ``model`` (``KeyError`` / ``ValueError``);
    with ``complete`` every entry of ``model`` must have a leaf too, and
    without it the result holds the leaves' entries alone (a Keras import)."""
    target = model.state_dict()
    by_path = {(c, path): (key, kind) for key, (c, path, kind) in leaf_map(model).items()}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key, kind = by_path.get((collection, path), (None, None))
            if key is None:
                raise KeyError(
                    f"Flax leaf {collection}/{'/'.join(path)} has no counterpart "
                    f"in {type(model).__name__}")
            ref = target[key]
            if tuple(np.shape(leaf)) != flax_shape(ref.shape, kind):
                raise ValueError(
                    f"Shape mismatch at {collection}/{'/'.join(path)}: Flax leaf "
                    f"{tuple(np.shape(leaf))} vs model {flax_shape(ref.shape, kind)}")
            out[key] = leaf_to_tensor(leaf, kind, ref)
    missing = sorted(set(target) - set(out))
    if complete and missing:
        raise KeyError(f"state_dict entries with no Flax leaf: {missing}")
    return out


def load_flax_variables(model, variables):
    """Loads Flax ``variables`` into ``model`` in place; returns ``model``."""
    sd = flax_to_state_dict(variables, model)
    model.load_state_dict(sd, strict=True)
    return model


def state_dict_to_flax(model, tensors=None):
    """Returns ``{'params': ..., 'batch_stats': ...}`` nested dicts of numpy
    arrays, in the JAX package's tree layout, from ``model``; or, from
    ``tensors`` (``{state_dict name: tensor}``, e.g. the SGD velocity of
    each parameter), the leaves of those names."""
    variables = {"params": {}, "batch_stats": {}}
    state = model.state_dict() if tensors is None else tensors
    for key, (collection, path, kind) in leaf_map(model).items():
        if key not in state:
            continue
        node = variables[collection]
        for m in path[:-1]:
            node = node.setdefault(m, {})
        a = state[key].detach().cpu().float().numpy()
        if kind:
            a = _kernel_to_flax(a, kind == "kernel_t")
        node[path[-1]] = np.ascontiguousarray(a)
    return variables
