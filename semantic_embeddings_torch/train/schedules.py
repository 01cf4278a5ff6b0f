"""Learning-rate schedules: SGDR, CLR, piecewise, plateau, ResNet-paper.

A copy of the JAX package's numpy-only ``train/schedules.py`` (that
package's ``train/__init__`` imports JAX).  Host-side epoch/iteration logic
reproducing the original Keras callbacks (``sgdr_callback.py``,
``clr_callback.py``); the resulting scalar LR is passed to the train step
each batch.

Each schedule exposes:
- ``lr(epoch, global_iter)`` — LR for a given epoch / global iteration.
- ``per_batch`` — True if the LR changes within an epoch (CLR).
- ``observe(val_metrics)`` — epoch-end hook (plateau reduction).
"""

from __future__ import annotations

import numpy as np


class SGDRSchedule:
    """Cosine annealing with warm restarts, updated per epoch.

    Matches the reference callback semantics: epoch 0 of each cycle uses
    ``max_lr``; epoch ``e >= 1`` uses
    ``min + 0.5 (max-min) (1 + cos(pi (e+1) / cycle_len))``
    (the callback computes the next epoch's LR at epoch end with the
    incremented counter — ``sgdr_callback.py:63-66,75-87``).
    """

    per_batch = False

    def __init__(self, min_lr=1e-6, max_lr=0.1, base_len=12, mul=2):
        self.min_lr = min_lr
        self.max_lr = max_lr
        self.base_len = base_len
        self.mul = mul

    def cycle_position(self, epoch):
        """(cycle_index, epoch_within_cycle, cycle_length)."""
        cycle, length = 0, self.base_len
        e = epoch
        while e >= length:
            e -= length
            cycle += 1
            length = self.base_len * (self.mul ** cycle)
        return cycle, e, length

    def lr(self, epoch, global_iter=0):
        _, e, length = self.cycle_position(epoch)
        if e == 0:
            return self.max_lr
        return self.min_lr + 0.5 * (self.max_lr - self.min_lr) * (
            1 + np.cos(np.pi * (e + 1) / length)
        )

    def observe(self, val_metrics):
        pass

    def total_epochs(self, cycles=5):
        return sum(self.base_len * (self.mul ** i) for i in range(cycles))


class CLRSchedule:
    """Cyclical learning rate, updated per batch (``clr_callback.py:106-133``).

    Iteration 0 uses ``base_lr``; iteration ``i >= 1`` uses the triangular
    formula evaluated at ``i`` (the callback updates on_batch_end).
    """

    per_batch = True

    def __init__(self, base_lr=1e-5, max_lr=0.1, step_size=2000.0,
                 mode="triangular", gamma=1.0):
        self.base_lr = base_lr
        self.max_lr = max_lr
        self.step_size = float(step_size)
        self.mode = mode
        self.gamma = gamma

    def _scale(self, cycle, it):
        if self.mode == "triangular":
            return 1.0
        if self.mode == "triangular2":
            return 1.0 / (2.0 ** (cycle - 1))
        if self.mode == "exp_range":
            return self.gamma ** it
        raise ValueError(f"Unknown CLR mode: {self.mode}")

    def lr(self, epoch, global_iter=0):
        it = global_iter
        if it == 0:
            return self.base_lr
        cycle = np.floor(1 + it / (2 * self.step_size))
        x = np.abs(it / self.step_size - 2 * cycle + 1)
        amp = (self.max_lr - self.base_lr) * max(0.0, 1.0 - x)
        return self.base_lr + amp * self._scale(cycle, it)

    def observe(self, val_metrics):
        pass


class PiecewiseSchedule:
    """Explicit ``epoch:lr`` piecewise-constant schedule
    (``utils.py:329-344``)."""

    per_batch = False

    def __init__(self, points, initial_lr=0.1):
        # points: list of (zero-based epoch, lr-or-None), sorted by epoch.
        self.points = sorted(points, key=lambda p: p[0])
        self.initial_lr = initial_lr

    @classmethod
    def parse(cls, spec, initial_lr=0.1):
        """Parses ``"1:0.1,31:0.01,41:0.001,50"`` — the trailing bare number
        is the total epoch count."""
        points = []
        for part in spec.split(","):
            toks = part.split(":")
            epoch = int(toks[0]) - 1
            lr = float(toks[1]) if len(toks) > 1 else None
            points.append((epoch, lr))
        return cls(points, initial_lr)

    def lr(self, epoch, global_iter=0):
        # The governing point is the last one with point_epoch <= epoch; a
        # None LR means "keep the previous LR" (the reference's scheduler
        # gets the running LR as input, utils.py:331-337), which statelessly
        # resolves to the last non-None LR at or before that point.
        governing = None
        for i, (pe, _) in enumerate(self.points):
            if pe <= epoch:
                governing = i
            else:
                break
        if governing is None:
            return self.initial_lr
        for i in range(governing, -1, -1):
            if self.points[i][1] is not None:
                return self.points[i][1]
        return self.initial_lr

    def observe(self, val_metrics):
        pass

    @property
    def total_epochs(self):
        return self.points[-1][0] + 1


class PlateauSchedule:
    """ReduceLROnPlateau on val_loss (``utils.py:353-355``): factor 0.1,
    configurable patience / floor, min_delta 1e-4."""

    per_batch = False

    def __init__(self, initial_lr=0.1, patience=10, factor=0.1, min_lr=1e-4,
                 min_delta=1e-4, monitor="val_loss"):
        self.current_lr = initial_lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.monitor = monitor
        self.best = np.inf
        self.wait = 0

    def lr(self, epoch, global_iter=0):
        return self.current_lr

    def observe(self, val_metrics):
        value = val_metrics.get(self.monitor)
        if value is None:
            return
        if value < self.best - self.min_delta:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.current_lr = max(self.current_lr * self.factor, self.min_lr)
                self.wait = 0


class ResNetSchedule:
    """He et al. hand schedule (``utils.py:385-393``)."""

    per_batch = False

    def lr(self, epoch, global_iter=0):
        if epoch >= 120:
            return 0.001
        if epoch >= 80:
            return 0.01
        if epoch >= 1:
            return 0.1
        return 0.01

    def observe(self, val_metrics):
        pass


LR_SCHEDULES = ["SGD", "SGDR", "CLR", "ResNet-Schedule"]


def get_lr_schedule(schedule, num_samples, batch_size, schedule_args=None):
    """Builds a schedule by name; returns ``(schedule, suggested_epochs)``
    with the reference's defaults and epoch counts (``utils.py:288-399``)."""
    args = dict(schedule_args or {})
    name = schedule.lower()

    if name == "sgd":
        spec = args.get("sgd_schedule")
        if spec:
            sched = PiecewiseSchedule.parse(spec, initial_lr=args.get("sgd_lr", 0.1))
            return sched, sched.total_epochs
        return (
            PlateauSchedule(
                initial_lr=args.get("sgd_lr", 0.1),
                patience=args.get("sgd_patience", 10),
                min_lr=args.get("sgd_min_lr", 1e-4),
            ),
            200,
        )

    if name == "sgdr":
        sched = SGDRSchedule(
            min_lr=1e-6,
            max_lr=args.get("sgdr_max_lr", 0.1),
            base_len=args.get("sgdr_base_len", 12),
            mul=args.get("sgdr_mul", 2),
        )
        return sched, sched.total_epochs(cycles=5)

    if name == "clr":
        step_len = args.get("clr_step_len", 12)
        sched = CLRSchedule(
            base_lr=args.get("clr_min_lr", 1e-5),
            max_lr=args.get("clr_max_lr", 0.1),
            step_size=step_len * (num_samples // batch_size),
            mode="triangular",
        )
        return sched, step_len * 20

    if name == "resnet-schedule":
        return ResNetSchedule(), 164

    raise ValueError(f"Unknown learning rate schedule: {schedule}")
