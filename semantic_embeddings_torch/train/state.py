"""Train state and checkpointing (counterpart of the JAX package's
``train/state.py``).

A checkpoint is one ``torch.save`` file holding the model's ``state_dict``
(parameters and BN running statistics), the optimizer velocity, the progress
counters and a metadata dict.  It backs ``--snapshot`` (resume) and
``--model_dump``; ``--weight_dump`` writes the ``state_dict`` alone.
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
