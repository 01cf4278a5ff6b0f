"""The traffic generator: everything a run feeds the system, made from the
run's seed.  The same seed gives the same weights, images, labels, class
embedding, batches and augmentation draws on every run and on both sides
(the program and the reference).

A traffic mix is a JSON file under ``traffic/`` that sets the parameters:
``image_size``, ``classes`` (the width of the embedding and of the softmax
head: the dataset's class count), ``batch`` (the global batch over all
ranks), ``ranks``, ``dtype`` (``float32``: TF32 off, or ``bfloat16``
under autocast), ``resident_images`` (uint8 images held on the card),
``augment`` (the on-device random shift and flip, or null), and
``steps_per_epoch`` and ``decay`` (the schedule's epoch length and time
decay in the recipe's own dataset).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def subseed(seed, stream):
    """A 63-bit seed for one stream of draws of the run's ``seed``."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(2, dtype=np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


WEIGHTS, IMAGES, BATCHES, AUGMENT = 0, 1, 2, 3


def make_weights(shapes, seed, device):
    """Initial weights for ``shapes`` (name -> (shape, kind), a reference
    module's ``shapes``) on ``device``, in f32, from ``seed``, in a few
    large calls: conv kernels He-normal (std sqrt(2 / fan_in)), dense
    kernels Glorot-uniform, BatchNorm scales and running variances one,
    biases and running means zero."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, WEIGHTS))
    out = {}
    for kind, draw, scale in (
            ("conv", torch.randn, lambda s: math.sqrt(2.0 / math.prod(s[1:]))),
            ("dense", torch.rand, lambda s: math.sqrt(6.0 / (s[0] + s[1])))):
        names = [n for n, (_, k) in shapes.items() if k == kind]
        sizes = [math.prod(shapes[n][0]) for n in names]
        flat = draw(sum(sizes), generator=gen, device=device)
        if kind == "dense":
            flat = flat.mul_(2.0).sub_(1.0)
        scales = torch.tensor([scale(shapes[n][0]) for n in names], device=device)
        flat.mul_(torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
        for name, part in zip(names, flat.split(sizes)):
            out[name] = part.view(shapes[name][0])
    for name, (shape, kind) in shapes.items():
        if kind in ("scale", "var"):
            out[name] = torch.ones(shape, device=device)
        elif kind in ("bias", "mean"):
            out[name] = torch.zeros(shape, device=device)
    return out


def make_data(traffic, seed, device):
    """The resident training set on ``device``: ``images`` uint8 (N, S, S,
    3), ``labels`` int64 (N,) uniform over the classes, and the class
    embedding ``table`` (C, C) of random unit rows."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, IMAGES))
    n, size, classes = traffic["resident_images"], traffic["image_size"], traffic["classes"]
    images = torch.randint(0, 256, (n, size, size, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    table = torch.randn((classes, classes), generator=gen, device=device)
    table = table / table.norm(dim=1, keepdim=True)
    return {"images": images, "labels": labels, "table": table}


class Batches:
    """The global batches of a run: each epoch a permutation of the
    resident images from the seed, cut into batches (every row of an epoch
    differs).  ``batch(k)`` is the int32 index array of global step k."""

    def __init__(self, traffic, seed):
        self.n, self.size, self.seed = traffic["resident_images"], traffic["batch"], seed
        self.per_epoch = self.n // self.size
        self._epoch, self._perm = None, None

    def batch(self, k):
        epoch, i = divmod(k, self.per_epoch)
        if epoch != self._epoch:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, BATCHES, epoch]))
            self._epoch, self._perm = epoch, rng.permutation(self.n).astype(np.int32)
        return self._perm[i * self.size:(i + 1) * self.size]


def augment_generator(seed, device):
    """The generator of the on-device augmentation's draws."""
    return torch.Generator(device=device).manual_seed(subseed(seed, AUGMENT))
