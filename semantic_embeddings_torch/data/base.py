"""Dataset base: the batch protocol shared by all data generators.

A copy of the JAX package's numpy-only ``data/base.py`` (that package's
``data/__init__`` imports JAX).  The host side produces only *index
permutations* for the in-memory datasets; the device side (``make_prepare``)
turns a raw batch into normalized, augmented float images inside the train
step, on the device.

Epoch semantics (shuffling, class-balanced oversampling, ``repeats``,
ragged-final-batch padding) mirror the original Keras ``DataSequence`` with
one deliberate change: batches have one fixed size (training pads by
wrapping the permutation, evaluation pads with a validity mask), as in the
JAX package.
"""

from __future__ import annotations

import numpy as np


def epoch_permutation(labels, rng, *, shuffle=True, oversample=False, repeats=1):
    """Index order for one epoch (``datasets/common.py:71-122`` semantics).

    With ``oversample``, every class is sampled up to the largest class's
    size; ``repeats`` concatenates that many independently shuffled passes.
    """
    labels = np.asarray(labels)
    n = len(labels)
    parts = []
    for _ in range(repeats):
        if oversample:
            classes, counts = np.unique(labels, return_counts=True)
            target = counts.max()
            rounds = []
            for c in classes:
                members = np.flatnonzero(labels == c)
                reps = int(np.ceil(target / len(members)))
                if shuffle:
                    draws = np.concatenate(
                        [rng.permutation(members) for _ in range(reps)]
                    )[:target]
                else:
                    draws = np.tile(members, reps)[:target]
                rounds.append(draws)
            perm = np.concatenate(rounds)
        else:
            perm = np.arange(n)
        if shuffle:
            perm = rng.permutation(perm)
        parts.append(perm)
    return np.concatenate(parts)


def batched_indices(perm, batch_size):
    """Splits a permutation into fixed-size batches.

    The ragged final batch is padded by wrapping to the permutation's start
    (one fixed batch shape); callers that must not see duplicates use
    :func:`batched_indices_masked` instead.
    """
    n = len(perm)
    n_batches = int(np.ceil(n / batch_size))
    padded = np.resize(perm, n_batches * batch_size)
    return padded.reshape(n_batches, batch_size)


def batched_indices_masked(n, batch_size):
    """Sequential batches over ``range(n)`` with a validity mask for the
    padded tail (used by evaluation / feature extraction)."""
    n_batches = int(np.ceil(n / batch_size))
    idx = np.arange(n_batches * batch_size)
    valid = (idx < n).astype(np.float32)
    idx = np.minimum(idx, n - 1)
    return idx.reshape(n_batches, batch_size), valid.reshape(n_batches, batch_size)


class DatasetBase:
    """Interface shared by all datasets.

    Subclasses set ``labels_train`` / ``labels_test`` / ``classes`` /
    ``class_indices`` and implement ``train_batches`` / ``test_batches`` /
    ``make_prepare``.
    """

    oversample = False
    repeats = 1

    @property
    def num_classes(self):
        return len(self.classes)

    @property
    def num_train(self):
        return len(self.labels_train)

    @property
    def num_test(self):
        return len(self.labels_test)

    @property
    def num_channels(self):
        return 3

    def steps_per_epoch(self, batch_size):
        n = self.num_train * self.repeats
        if self.oversample:
            labels = np.asarray(self.labels_train)
            _, counts = np.unique(labels, return_counts=True)
            n = len(counts) * counts.max() * self.repeats
        return int(np.ceil(n / batch_size))

    def train_batches(self, batch_size, epoch, seed=0, shard=False):
        """Raw batches of one epoch; with ``shard`` this process's rows of
        each global batch (``..parallel.shard_batch``: ``rows`` says where
        they lie)."""
        raise NotImplementedError

    def test_batches(self, batch_size, shard=False):
        raise NotImplementedError

    def make_prepare(self):
        """Returns ``prepare(raw_batch, rng, train) -> (images, labels)``
        run on the device inside the train step."""
        raise NotImplementedError
