"""Train state and checkpointing (counterpart of the JAX package's
``train/state.py``).

A checkpoint is one ``torch.save`` file holding the model's ``state_dict``
(parameters and BN running statistics), the optimizer velocity, the progress
counters and a metadata dict.  It backs ``--snapshot`` (resume) and
``--model_dump``; ``--weight_dump`` writes the ``state_dict`` alone.
:func:`load_weights_by_name` restores any of them by name for
``--finetune`` and ``--init_weights``.

The JAX package's two file formats are read too (:func:`checkpoint_format`
tells the three apart by their first bytes): its model dump or snapshot, a
pickle of ``{"state": <Flax msgpack of the train state>, "metadata":
{...}}`` (:func:`read_jax_checkpoint`, unpickled with a restricted
unpickler), and its weight dump, the Flax msgpack of ``params``
(:func:`read_jax_weights`).  :func:`save_jax_checkpoint` and
:func:`save_jax_weights` write the same bytes the JAX package writes for
the same weights.  Resuming (``--snapshot``) stays within one package.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from . import flax_msgpack
from .optimizer import init_velocity


@dataclass
class TrainState:
    """The model (parameters and BN buffers), the SGD velocity (one tensor
    per parameter, in ``model.parameters()`` order), ``step`` and ``epoch``."""

    model: nn.Module
    velocity: list = field(default_factory=list)
    step: int = 0
    epoch: int = 0

    @property
    def params(self):
        return list(self.model.parameters())


def new_train_state(model):
    return TrainState(model=model, velocity=init_velocity(model.parameters()))


def save_checkpoint(path, state: TrainState, metadata=None):
    """Atomically writes a full training checkpoint."""
    payload = {
        "model": state.model.state_dict(),
        "velocity": list(state.velocity),
        "step": int(state.step),
        "epoch": int(state.epoch),
        "metadata": metadata or {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


_TORCH_MAGIC = b"PK\x03\x04"  # a torch.save file is a zip archive
_FORMATS = {
    "torch": "a checkpoint of this package (torch.save)",
    "jax_checkpoint": "a JAX package model dump or snapshot (a pickle around Flax msgpack)",
    "jax_weights": "a JAX package weight dump (Flax msgpack of params)",
}


def checkpoint_format(path):
    """``'torch'``, ``'jax_checkpoint'`` or ``'jax_weights'``, from the
    file's first bytes: a zip archive (``torch.save``); a pickle (``0x80``
    and a protocol byte from 2 to 5); a Flax msgpack map (``0x81``-``0x8f``,
    ``0xde``, ``0xdf``, or ``0x80`` alone: the empty map)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _TORCH_MAGIC:
        return "torch"
    if len(head) >= 2 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "jax_checkpoint"
    if head == b"\x80" or head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "jax_weights"
    raise ValueError(f"{path} is neither a checkpoint of this package nor one of the "
                     f"JAX package's (first bytes {head!r})")


class _MetadataUnpickler(pickle.Unpickler):
    """Unpickles a JAX checkpoint's payload: builtin containers and scalars,
    and the numpy scalars its metadata may hold; any other global raises."""

    ALLOWED = {("numpy", "dtype"), ("numpy._core.multiarray", "scalar"),
               ("numpy.core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a JAX checkpoint's payload")
        return super().find_class(module, name)


def read_jax_checkpoint(path):
    """``(state, metadata)`` of a JAX package model dump or snapshot:
    ``state`` is the restored train state (``params``, ``batch_stats``,
    ``velocity``, ``step``, ``epoch``) as nested dicts of numpy arrays, and
    numpy scalars in ``metadata`` become Python scalars."""
    with open(path, "rb") as f:
        payload = _MetadataUnpickler(f).load()
    if not isinstance(payload, dict) or not isinstance(payload.get("state"), bytes):
        raise ValueError(f"{path} is a pickle but not a JAX package checkpoint")
    state = flax_msgpack.msgpack_restore(payload["state"])
    metadata = {key: value.item() if isinstance(value, np.generic) else value
                for key, value in (payload.get("metadata") or {}).items()}
    return state, metadata


def read_jax_weights(path):
    """The ``params`` tree of a JAX package weight dump."""
    with open(path, "rb") as f:
        return flax_msgpack.msgpack_restore(f.read())


def save_jax_checkpoint(path, state: TrainState, metadata=None):
    """Writes ``state`` as the JAX package's ``save_checkpoint`` writes a
    train state of these weights: a pickle of ``{"state": <Flax msgpack of
    (params, batch_stats, velocity, step, epoch)>, "metadata": ...}``."""
    from .. import convert

    variables = convert.state_dict_to_flax(state.model)
    names = (n for n, _ in state.model.named_parameters())
    velocity = convert.state_dict_to_flax(state.model, dict(zip(names, state.velocity)))
    tree = {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "velocity": velocity["params"]}
    # jax.device_get's copy sorts each dict; to_bytes keeps the fields' order
    tree = {key: flax_msgpack.sorted_tree(value) for key, value in tree.items()}
    tree.update(step=int(state.step), epoch=int(state.epoch))
    payload = {"state": flax_msgpack.msgpack_serialize(tree, in_place=True),
               "metadata": metadata or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def save_jax_weights(path, model):
    """Writes ``model``'s parameters as the JAX package's ``save_weights``
    (``--weight_dump``) does: the Flax msgpack of ``params``."""
    from .. import convert

    with open(path, "wb") as f:
        f.write(flax_msgpack.msgpack_serialize(convert.state_dict_to_flax(model)["params"]))


def load_checkpoint(path, state: TrainState):
    """Restores a checkpoint into ``state`` (in place); returns
    ``(state, metadata)``.  A JAX package snapshot is refused: resuming
    stays within one package."""
    fmt = checkpoint_format(path)
    if fmt != "torch":
        raise ValueError(
            f"{path} is {_FORMATS[fmt]}: --snapshot resumes only from {_FORMATS['torch']}; "
            "start from its weights with --finetune instead")
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    if len(payload["velocity"]) != len(state.velocity):
        raise ValueError(
            f"checkpoint {path} holds {len(payload['velocity'])} velocity "
            f"tensors; the model has {len(state.velocity)} parameters")
    with torch.no_grad():
        for v, saved in zip(state.velocity, payload["velocity"]):
            v.copy_(saved)
    state.step = payload["step"]
    state.epoch = payload["epoch"]
    return state, payload.get("metadata", {})


def save_weights(path, model):
    """Weights-only dump (``--weight_dump``): the model's ``state_dict``."""
    torch.save(model.state_dict(), path)


_BACKBONE = "backbone."


def has_backbone(names):
    """Whether ``state_dict`` names hold a ``backbone`` module: an embedding
    or learner model's, not a bare network's (a classifier's)."""
    return any(n.startswith(_BACKBONE) for n in names)


def load_weights_by_name(path, model):
    """Restores into ``model``, in place, the tensors of the checkpoint at
    ``path`` whose names and shapes match, as Keras's ``load_weights(
    by_name=True, skip_mismatch=True)`` does for fine-tuning; the rest keep
    their values.  Prints what it loaded and the names it skipped on either
    side, and returns ``(loaded, skipped)`` name lists.

    What loads depends on the file, and this is a decision:

    - a checkpoint of this package (model dump, snapshot or weight dump):
      parameters and BatchNorm running statistics, as the reference's Keras
      ``load_weights`` restores a layer's weights and its moving statistics.
      Names match by layer: a bare network's ``conv0.weight`` (a
      classifier's dump) is a model's ``backbone.conv0.weight``, and back; a
      classifier's ``top`` is its softmax layer (the reference's ``prob``),
      which never loads into an embedding model's ``top`` or back;
    - a JAX package weight dump, or the ``params`` of its model dump or
      snapshot: exactly what the JAX package's ``load_weights_by_name``
      loads, the parameters whose Flax path and shape match (no running
      statistics: its ``--weight_dump`` holds none, so they keep their
      initial values, as in the JAX run; no renaming between a classifier
      and an embedding model).
    """
    fmt = checkpoint_format(path)
    if fmt == "jax_weights":
        return _load_flax_params_by_name(read_jax_weights(path), model, path)
    if fmt == "jax_checkpoint":
        return _load_flax_params_by_name(read_jax_checkpoint(path)[0].get("params", {}),
                                         model, path)
    source = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(source.get("model"), dict):  # a model dump or snapshot
        source = source["model"]
    target = model.state_dict()
    src_wrapped, dst_wrapped = has_backbone(source), has_backbone(target)

    def target_name(name):
        if src_wrapped == dst_wrapped:
            return name
        if src_wrapped:  # an embedding model's backbone into a bare network
            name = name[len(_BACKBONE):] if name.startswith(_BACKBONE) else None
            return None if name is None or name.startswith("top.") else name
        return None if name.startswith("top.") else _BACKBONE + name

    loaded, skipped = [], []
    with torch.no_grad():
        for name, value in source.items():
            dst = target_name(name)
            if dst in target and tuple(target[dst].shape) == tuple(value.shape):
                target[dst].copy_(value)
                loaded.append(dst)
            else:
                skipped.append(name)
    return _report(path, target, loaded, skipped)


def _report(path, target, loaded, skipped):
    untouched = sorted(set(target) - set(loaded))
    print(f"Loaded {len(loaded)} of {len(target)} tensors by name from {path}; "
          f"skipped in the checkpoint: {skipped}; left as initialized: {untouched}")
    return loaded, skipped + untouched


def _load_flax_params_by_name(params, model, path):
    """The JAX package's by-name restore: each parameter of ``model`` whose
    Flax path holds a leaf of its shape in ``params`` takes that leaf."""
    from .. import convert

    def leaf_at(path_):
        node = params
        for part in path_:
            node = node.get(part) if isinstance(node, dict) else None
        return node if hasattr(node, "shape") else None

    target = model.state_dict()
    loaded, used = [], set()
    with torch.no_grad():
        for key, (collection, flax_path, kind) in convert.leaf_map(model).items():
            leaf = leaf_at(flax_path) if collection == "params" else None
            if leaf is None or tuple(leaf.shape) != convert.flax_shape(target[key].shape, kind):
                continue
            target[key].copy_(convert.leaf_to_tensor(leaf, kind, target[key]))
            loaded.append(key)
            used.add(flax_path)
    skipped = ["/".join(p) for p, _ in convert._flatten(params) if p not in used]
    return _report(path, target, loaded, skipped)
