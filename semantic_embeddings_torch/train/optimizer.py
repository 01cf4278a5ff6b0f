"""Keras-exact SGD with momentum, per-tensor norm clipping and time decay
(counterpart of the JAX package's ``train/optimizer.py``).

The original trains with ``keras.optimizers.SGD(lr, decay, momentum=0.9,
nesterov, clipnorm=10)``, whose update differs from ``torch.optim.SGD``:

- ``clipnorm`` clips every raw gradient *tensor* to norm 10 individually,
  not the global norm.
- velocity: ``v <- momentum * v - lr * g``; plain momentum applies
  ``p += v``, Nesterov ``p += momentum * v_new - lr * g``.  torch's
  ``v <- m v + g; p <- p - lr v`` differs whenever lr changes, and SGDR
  changes it every epoch.
- ``decay`` is per-iteration inverse time decay on the base LR, applied by
  the epoch loop (:func:`effective_lr`).

DeViSE trains with ``keras.optimizers.Adagrad`` instead
(:func:`adagrad_update`; its accumulators take the velocities' place).

Parameters, velocities and gradients are lists of tensors in one order.
The update runs in place, as a few ``torch._foreach_*`` calls.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def clip_by_per_tensor_norm(grads, clipnorm):
    """Keras ``clipnorm``: clip each gradient tensor to the given L2 norm."""
    if not clipnorm or clipnorm <= 0:
        return list(grads)
    norms = torch._foreach_norm(grads)
    scales = [clipnorm / torch.clamp_min(n, clipnorm) for n in norms]
    return torch._foreach_mul(grads, scales)


def init_velocity(params):
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_update(params, velocity, grads, lr, momentum=0.9, nesterov=False,
               clipnorm=0.0):
    """One Keras-SGD step, in place on ``params`` and ``velocity``."""
    grads = clip_by_per_tensor_norm(grads, clipnorm)
    lr = float(lr)
    torch._foreach_mul_(velocity, momentum)
    torch._foreach_add_(velocity, grads, alpha=-lr)
    if nesterov:
        torch._foreach_add_(params, velocity, alpha=momentum)
        torch._foreach_add_(params, grads, alpha=-lr)
    else:
        torch._foreach_add_(params, velocity)


@torch.no_grad()
def adagrad_update(params, accum, grads, lr, epsilon=1e-7):
    """One Keras-Adagrad step (DeViSE), in place on ``params`` and the
    accumulators ``accum``: ``a += g**2; p -= lr * g / (sqrt(a) + eps)``."""
    torch._foreach_addcmul_(accum, grads, grads)
    denom = torch._foreach_sqrt(accum)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_addcdiv_(params, grads, denom, value=-float(lr))


def effective_lr(base_lr, decay, iterations):
    """Keras time-based decay: ``lr / (1 + decay * iterations)``."""
    if decay and decay > 0:
        return base_lr / (1.0 + decay * iterations)
    return base_lr


def decay_from_max_decay(max_decay, steps_per_epoch, epochs):
    """Derives the per-iteration decay from ``--max_decay``: the LR at the
    end of training is ``max_decay`` times the initial one."""
    if max_decay and max_decay > 0:
        return (1.0 / max_decay - 1.0) / (steps_per_epoch * epochs)
    return 0.0
