"""Training runtime: losses, Keras-exact SGD, schedules, state, trainer."""

from . import losses, metrics
from .optimizer import (
    adagrad_update,
    clip_by_per_tensor_norm,
    decay_from_max_decay,
    effective_lr,
    init_velocity,
    sgd_update,
)
from .schedules import LR_SCHEDULES, get_lr_schedule
from .state import (
    TrainState,
    load_checkpoint,
    load_weights_by_name,
    new_train_state,
    save_checkpoint,
    save_weights,
)
from .trainer import (
    EMB_LOSSES,
    LOSS_OUTPUT,
    finish_step,
    fit,
    make_classifier_eval_step,
    make_classifier_train_step,
    make_eval_step,
    make_train_step,
    run_validation,
    trainable_indices,
)

__all__ = [
    "losses",
    "metrics",
    "adagrad_update",
    "clip_by_per_tensor_norm",
    "decay_from_max_decay",
    "effective_lr",
    "init_velocity",
    "sgd_update",
    "LR_SCHEDULES",
    "get_lr_schedule",
    "TrainState",
    "load_checkpoint",
    "load_weights_by_name",
    "new_train_state",
    "save_checkpoint",
    "save_weights",
    "EMB_LOSSES",
    "LOSS_OUTPUT",
    "finish_step",
    "fit",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_eval_step",
    "make_train_step",
    "run_validation",
    "trainable_indices",
]
