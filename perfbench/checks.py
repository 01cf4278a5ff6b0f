"""How ``correct`` is decided: the program's first three steps against the
plain reference's, from the same weights, images, batches and
augmentation draws.

The numbers compared, each beside its limit from ``checks/<cell>.json``:

- ``loss_gap_<k>``: |program's loss - reference's| / |reference's| at step k;
- ``grad_gap``: over the parameters, the worst gap between the norm of the
  first gradient as the program's optimizer took it and the reference's,
  over the larger of the reference's norm of that parameter and the median
  parameter's;
- ``change_gap``: the same for the norm of each parameter's and BatchNorm
  statistic's change over the three steps;
- ``change_gap_conv``: ``change_gap`` over the convolutions' kernels alone;
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gap, where
  the worst leaf's swings from seed to seed.

Each cell's ``checks/<cell>.json`` names the numbers it compares and their
limits; the others are printed, not judged.

A parameter whose reference gradient is under a thousandth of the median
parameter's moves by round-off alone and is left out of both gaps (by
that rule, not by name).
"""

from __future__ import annotations

import math
import statistics

import torch

from . import feed
from .reference import plain

CHECKED_STEPS = 3
#: a gradient under this share of the median parameter's is round-off
NEGLIGIBLE = 1e-3


def reference_readings(cell, seed, device, precision="f32", rows=None, dtype=torch.float32):
    """The reference's readings of the run with ``seed``: computed in
    ``precision`` (a key of :data:`.reference.plain.PRECISIONS`; the
    control takes a lower one), trained on the rows ``rows`` of each batch
    only (None: all; the fault of a batch half left out), in ``dtype``
    (float64: a witness of what f32 rounding alone reads)."""
    cfg, tr, arch = cell.config, cell.traffic, cell.reference
    # f32 means f32: cuDNN's convolutions default to TF32 on this card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = arch.shapes(cfg, tr["classes"])
    weights = {n: w.to(dtype) for n, w in feed.make_weights(shapes, seed, device).items()}
    data = feed.make_data(tr, seed, device)
    data["table"] = data["table"].to(dtype)
    stat_kinds = ("mean", "var")
    params = {n: weights[n].clone().requires_grad_()
              for n, (_, k) in shapes.items() if k not in stat_kinds}
    stats = {n: weights[n].clone() for n, (_, k) in shapes.items() if k in stat_kinds}
    velocity = {n: torch.zeros_like(p) for n, p in params.items()}
    mean, std = (m.to(dtype) for m in plain.channel_moments(data["images"]))
    batches = feed.Batches(tr, seed)
    gen = feed.augment_generator(seed, device)
    aug = tr["augment"]
    ops = plain.Ops(precision)
    losses, grads = [], {}
    for k in range(CHECKED_STEPS):
        idx = torch.as_tensor(batches.batch(k), device=device).long()
        x = data["images"][idx].to(dtype)
        if aug:
            x = plain.shift_flip(x, gen, aug["height_shift"], aug["width_shift"],
                                 aug["hflip"])
        x = (x - mean) / std
        lr = plain.sgdr_lr(k, tr["steps_per_epoch"], tr["sgdr"]["max_lr"],
                           tr["sgdr"]["base_len"], tr["sgdr"]["mul"], tr["decay"])
        loss, clipped = plain.train_step(arch, ops, params, stats, velocity, x,
                                         data["labels"][idx], data["table"], lr, cfg, rows)
        losses.append(float(loss))
        if k == 0:
            grads = {n: float(torch.linalg.vector_norm(g)) for n, g in clipped.items()}
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(t - weights[n]))
                  for n, t in {**params, **stats}.items()}
    return {"losses": losses, "grads": grads, "change": change,
            "conv": [n for n, (_, k) in shapes.items() if k == "conv"]}


def _gaps(got, ref, names):
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    median = statistics.median(ref[n] for n in names)
    return [abs(got[n] - ref[n]) / max(ref[n], median) for n in names]


def compare(got, ref):
    """The numbers compared (name -> value) of readings ``got`` against the
    reference's ``ref``; NaN where ``got`` is not finite."""
    median = statistics.median(ref["grads"].values())
    moved = [n for n, g in ref["grads"].items() if g >= NEGLIGIBLE * median]
    left_out = set(ref["grads"]) - set(moved)
    out = {}
    for k, (a, b) in enumerate(zip(got["losses"], ref["losses"])):
        out[f"loss_gap_{k + 1}"] = abs(a - b) / abs(b)
    grads = _gaps(got["grads"], ref["grads"], moved)
    kept = [n for n in ref["change"] if n not in left_out]
    change = dict(zip(kept, _gaps(got["change"], ref["change"], kept)))
    out["grad_gap"], out["grad_gap_median"] = max(grads), statistics.median(grads)
    out["change_gap"] = max(change.values())
    out["change_gap_median"] = statistics.median(change.values())
    out["change_gap_conv"] = max(change[n] for n in ref["conv"] if n in change)
    return {k: v if math.isfinite(v) else math.nan for k, v in out.items()}


def judge(numbers, limits):
    """``(correct, [[name, value, limit], ...])``: correct when every number
    compared is finite and within its limit."""
    rows = [[name, numbers.get(name, math.nan), limit] for name, limit in limits.items()]
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in rows)
    return correct, rows
