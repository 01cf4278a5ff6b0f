"""Dataset registry (counterpart of the JAX package's ``data/__init__.py``).

Ported so far: ``synthetic[-N[-n_train[-n_test[-size]]]]``, ``cifar-10`` and
``cifar-100``.  The file datasets come in later work.
"""

from __future__ import annotations

from .base import DatasetBase
from .cifar import CifarDataset, InMemoryDataset, SyntheticDataset

# Published channel statistics (0-255 pixel scale), as the JAX package's
# ``data/__init__.py`` has them; serving normalizes with them.
CAFFE_MEAN = [123.68, 116.779, 103.939]
CAFFE_STD = [1.0, 1.0, 1.0]
IMAGENET_MEAN = [122.65435242, 116.6545058, 103.99789959]
IMAGENET_STD = [71.40583196, 69.56888997, 73.0440314]
CUB_STATS = ([123.82988033, 127.35116805, 110.25606303],
             [59.2230949, 58.0736071, 67.80251684])


def get_data_generator(dataset, data_root=None, classes=None, **extra):
    """Creates a dataset by name with the original defaults."""
    dataset = dataset.lower()
    kwargs = dict(extra)

    if dataset.startswith("synthetic"):
        # synthetic[-<num_classes>[-<n_train>[-<n_test>[-<size>]]]]: in-memory
        # random data, CIFAR-shaped unless a size (ImageNet's 224) is
        # given.  ``classes`` (the embedding's label order) takes precedence
        # for the class count.
        parts = dataset.split("-")
        n = int(parts[1]) if len(parts) > 1 else 100
        for key, part in zip(("n_train", "n_test", "size"), parts[2:5]):
            kwargs.setdefault(key, int(part))
        return SyntheticDataset(num_classes=n, classes=classes, **kwargs)

    if dataset == "cifar-10":
        return CifarDataset(
            data_root, classes, reenumerate=True, cifar10=True, **kwargs)
    if dataset == "cifar-100":
        return CifarDataset(data_root, classes, reenumerate=True, **kwargs)

    raise ValueError(f"Unknown or not yet ported dataset: {dataset}")


__all__ = [
    "get_data_generator",
    "DatasetBase",
    "InMemoryDataset",
    "CifarDataset",
    "SyntheticDataset",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "CAFFE_MEAN",
    "CAFFE_STD",
    "CUB_STATS",
]
