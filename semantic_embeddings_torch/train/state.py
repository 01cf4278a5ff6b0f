"""Train state and checkpointing (counterpart of the JAX package's
``train/state.py``).

A checkpoint is one ``torch.save`` file holding the model's ``state_dict``
(parameters and BN running statistics), the optimizer velocity, the progress
counters and a metadata dict.  It backs ``--snapshot`` (resume) and
``--model_dump``; ``--weight_dump`` writes the ``state_dict`` alone.
:func:`load_weights_by_name` restores any of them by name for
``--finetune`` and ``--init_weights``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
from torch import nn

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


def load_checkpoint(path, state: TrainState):
    """Restores a checkpoint into ``state`` (in place); returns
    ``(state, metadata)``."""
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
    """Restores into ``model``, in place, the tensors of the port checkpoint
    at ``path`` (a model dump, snapshot or weight dump) whose names and
    shapes match, as Keras's ``load_weights(by_name=True,
    skip_mismatch=True)`` does for fine-tuning; the rest keep their values.
    Prints what it loaded and the names it skipped on either side, and
    returns ``(loaded, skipped)`` name lists.

    Parameters and BatchNorm running statistics both load (Keras layer
    weights; the JAX package's copy restores parameters only).  Names match
    by layer: a bare network's ``conv0.weight`` (a classifier's dump) is a
    model's ``backbone.conv0.weight``, and back; a classifier's ``top`` is
    its softmax layer (the reference's ``prob``), which never loads into an
    embedding model's ``top`` or back.
    """
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
    untouched = sorted(set(target) - set(loaded))
    print(f"Loaded {len(loaded)} of {len(target)} tensors by name from {path}; "
          f"skipped in the checkpoint: {skipped}; left as initialized: {untouched}")
    return loaded, skipped + untouched
