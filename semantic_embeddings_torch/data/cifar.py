"""CIFAR-10/100 (and a synthetic stand-in): device-resident in-memory
datasets (counterpart of the JAX package's ``data/cifar.py``).

The whole training set lives on the device as uint8 NHWC; the host streams
only int32 index batches, and ``make_prepare`` performs gather -> float ->
Keras-style affine shift/zoom/flip -> featurewise mean/std normalization on
the device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import parallel
from . import augment
from .base import DatasetBase, batched_indices, batched_indices_masked, epoch_permutation


def to_device(array, device):
    """Host array -> tensor on ``device``.  Copies to a CUDA device go
    through pinned memory without blocking, so the host does not wait for
    the device's queue to drain."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _load_cifar_arrays(root_dir, cifar10):
    """Reads the python-pickle CIFAR batches into (X, y) uint8/int arrays."""

    def read(path, label_key):
        with open(path, "rb") as f:
            dump = pickle.load(f, encoding="bytes")
        data = dump.get(b"data", dump.get("data"))
        labels = dump.get(label_key.encode(), dump.get(label_key))
        return np.asarray(data), list(labels)

    if cifar10:
        xs, ys = [], []
        for i in range(1, 6):
            x, y = read(os.path.join(root_dir, f"data_batch_{i}"), "labels")
            xs.append(x)
            ys += y
        x_train, y_train = np.concatenate(xs), ys
        x_test, y_test = read(os.path.join(root_dir, "test_batch"), "labels")
    else:
        x_train, y_train = read(os.path.join(root_dir, "train"), "fine_labels")
        x_test, y_test = read(os.path.join(root_dir, "test"), "fine_labels")

    def to_nhwc(x):
        return x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    return to_nhwc(x_train), y_train, to_nhwc(x_test), y_test


class InMemoryDataset(DatasetBase):
    """Base for datasets fully resident in device memory."""

    def __init__(self, x_train, y_train, x_test, y_test, classes=None,
                 reenumerate=False, *, width_shift=0.15, height_shift=0.15,
                 zoom=0.0, hflip=True):
        x_train = np.asarray(x_train)
        x_test = np.asarray(x_test)
        y_train = list(y_train)
        y_test = list(y_test)

        if classes is not None:
            keep_tr = np.array([y in classes for y in y_train])
            keep_te = np.array([y in classes for y in y_test])
            x_train, x_test = x_train[keep_tr], x_test[keep_te]
            y_train = [y for y, k in zip(y_train, keep_tr) if k]
            y_test = [y for y, k in zip(y_test, keep_te) if k]
            self.classes = list(classes)
            if reenumerate:
                self.class_indices = {c: i for i, c in enumerate(self.classes)}
                y_train = [self.class_indices[y] for y in y_train]
                y_test = [self.class_indices[y] for y in y_test]
            else:
                self.class_indices = {c: c for c in self.classes}
        else:
            self.classes = list(range(int(max(y_train)) + 1))
            self.class_indices = {c: c for c in self.classes}

        self.labels_train = np.asarray(y_train, dtype=np.int32)
        self.labels_test = np.asarray(y_test, dtype=np.int32)

        # Featurewise per-channel statistics over the training set (Keras
        # ImageDataGenerator.fit semantics).
        xf = x_train.astype(np.float64)
        self.mean = xf.mean(axis=(0, 1, 2)).astype(np.float32)
        self.std = xf.std(axis=(0, 1, 2)).astype(np.float32)

        self._x_train_host = x_train.astype(np.uint8)
        self._x_test_host = x_test.astype(np.uint8)
        self._device_arrays = {}
        self.width_shift = width_shift
        self.height_shift = height_shift
        self.zoom = zoom
        self.hflip = hflip

    # -- host side -----------------------------------------------------

    def _perm_batches(self, batch_size, epoch, seed, labels, shuffle):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        perm = epoch_permutation(
            labels, rng, shuffle=shuffle, oversample=self.oversample,
            repeats=self.repeats)
        return batched_indices(perm, batch_size)

    def train_batches(self, batch_size, epoch, seed=0, shard=False):
        for idx in self._perm_batches(
                batch_size, epoch, seed, self.labels_train, shuffle=True):
            raw = {"idx": idx.astype(np.int32)}
            yield parallel.shard_batch(raw) if shard else raw

    def test_batches(self, batch_size, shard=False):
        idx, valid = batched_indices_masked(self.num_test, batch_size)
        for i, v in zip(idx, valid):
            raw = {"idx": i.astype(np.int32), "valid": v}
            yield parallel.shard_batch(raw) if shard else raw

    def train_eval_batches(self, batch_size, augment=False, epochs=1):
        """Ordered masked batches over the training set, ``epochs`` passes
        (SVM-mode feature extraction); consume with ``prepare(raw, rng,
        train=True)`` from ``make_prepare(augment_train=augment)``.  The
        batches carry indices only, so ``augment`` changes nothing here: the
        device's prepare augments (a file dataset's host applies its
        train-time transforms)."""
        for _ in range(epochs):
            yield from (
                {"idx": i.astype(np.int32), "valid": v}
                for i, v in zip(*batched_indices_masked(self.num_train, batch_size)))

    # -- device side ---------------------------------------------------

    def device_arrays(self, device):
        """(x_train uint8, y_train int64, x_test uint8, y_test int64) on
        ``device``, uploaded once."""
        device = torch.device(device)
        arrays = self._device_arrays.get(device)
        if arrays is None:
            arrays = (
                torch.from_numpy(self._x_train_host).to(device),
                torch.from_numpy(self.labels_train.astype(np.int64)).to(device),
                torch.from_numpy(self._x_test_host).to(device),
                torch.from_numpy(self.labels_test.astype(np.int64)).to(device),
            )
            self._device_arrays[device] = arrays
        return arrays

    def make_prepare(self, device, augment_train=True):
        """Returns ``prepare(raw, rng, train) -> (images, labels)``: NHWC
        float32 normalized images and int64 labels on ``device``; ``rng`` is
        a ``torch.Generator`` on ``device``.  Of a process's rows of a
        global batch (``raw["rows"]``) the augmentation is drawn for the
        whole batch and applied to these rows."""
        device = torch.device(device)
        xtr, ytr, xte, yte = self.device_arrays(device)
        mean = torch.as_tensor(self.mean, device=device)
        std = torch.as_tensor(self.std, device=device)
        ws, hs, zm, hf = self.width_shift, self.height_shift, self.zoom, self.hflip

        def prepare(raw, rng, train):
            idx = to_device(raw["idx"], device).long()
            if train:
                images = xtr[idx].float()
                labels = ytr[idx]
                if augment_train:
                    b, h, w, _ = images.shape
                    start, stop, n = parallel.local_rows(raw, b)
                    params = augment.draw_affine_params(
                        n, h, w, rng, width_shift=ws, height_shift=hs, zoom=zm,
                        hflip=hf)
                    images = augment.affine_apply(
                        images, *augment.rows_of(params, start, stop))
            else:
                images = xte[idx].float()
                labels = yte[idx]
            return (images - mean) / std, labels

        return prepare


class CifarDataset(InMemoryDataset):
    """CIFAR-10/100 from the python pickle batches (class subsetting and
    re-enumeration as in the original loader)."""

    def __init__(self, root_dir, classes=None, reenumerate=False, cifar10=False,
                 **kwargs):
        x_train, y_train, x_test, y_test = _load_cifar_arrays(root_dir, cifar10)
        if cifar10:
            kwargs.setdefault("zoom", 0.25)
        super().__init__(
            x_train, y_train, x_test, y_test, classes, reenumerate, **kwargs)


class SyntheticDataset(InMemoryDataset):
    """Random class-separable images, CIFAR-shaped by default: the same
    arrays as the JAX package's ``SyntheticDataset`` for the same seed.

    ``classes`` (the embedding's ``ind2label``): synthetic label i stands
    for ``classes[i]``, so the ``embedding[label]`` gather stays aligned
    with ``ind2label`` ordering.
    """

    def __init__(self, num_classes=100, n_train=2048, n_test=512, size=32,
                 seed=0, classes=None, **kwargs):
        if classes is not None:
            num_classes = len(classes)
        rng = np.random.default_rng(seed)
        y_train = np.tile(np.arange(num_classes), n_train // num_classes + 1)[
            :n_train]
        y_test = np.tile(np.arange(num_classes), n_test // num_classes + 1)[:n_test]
        templates = rng.integers(60, 195, (num_classes, size, size, 3))

        def render(y):
            noise = rng.integers(-40, 40, (len(y), size, size, 3))
            return np.clip(templates[y] + noise, 0, 255).astype(np.uint8)

        super().__init__(
            render(y_train), y_train, render(y_test), y_test, **kwargs)
        if classes is not None:
            self.classes = list(classes)
            self.class_indices = {c: i for i, c in enumerate(self.classes)}
