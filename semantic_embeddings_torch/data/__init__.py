"""Dataset registry with the reference's name-suffix conventions
(counterpart of the JAX package's ``data/__init__.py``).

Names: ``synthetic[-N[-n_train[-n_test[-size]]]]``, ``cifar-10``,
``cifar-100``, ``cifar-100-a`` / ``-b`` (``-consec``), ``ilsvrc``, ``nab``,
``cub``, ``cub-subX``, ``cars``, ``flowers``, ``inat``,
``inat_<supercategory>`` (``inat2018`` an alias), ``inat2019``,
``mit67scenes``, ``ucmlu`` and ``resisc45``; suffixes ``-ilsvrcmean``,
``-caffe`` and ``-large``.
"""

from __future__ import annotations

import numpy as np

# Published channel statistics (0-255 pixel scale); serving normalizes with
# them too.
CAFFE_MEAN = [123.68, 116.779, 103.939]
CAFFE_STD = [1.0, 1.0, 1.0]

IMAGENET_MEAN = [122.65435242, 116.6545058, 103.99789959]
IMAGENET_STD = [71.40583196, 69.56888997, 73.0440314]

from .base import DatasetBase  # noqa: E402
from .cifar import CifarDataset, InMemoryDataset, SyntheticDataset  # noqa: E402
from .datasets import (  # noqa: E402
    CarsDataset,
    FlowersDataset,
    ILSVRCDataset,
    INatDataset,
    NABDataset,
    SubDirectoryDataset,
)
from .files import FileDataset  # noqa: E402

MIT67_STATS = ([124.62788179, 110.01028625, 94.95780545],
               [68.56923599, 66.86607736, 67.35944349])
UCMLU_STATS = ([122.65409223, 124.40230701, 114.25659171],
               [55.74499679, 51.65585669, 50.16527551])
RESISC45_STATS = ([94.17769482, 97.40967803, 87.80359702],
                  [51.92246172, 47.22081475, 47.07685676])
CUB_STATS = ([123.82988033, 127.35116805, 110.25606303],
             [59.2230949, 58.0736071, 67.80251684])
INAT2019_STATS = ([115.77492586, 120.84414891, 93.51744386],
                  [60.46127213, 58.63136496, 63.5872299])


def get_data_generator(dataset, data_root=None, classes=None, **extra):
    """Creates a dataset by name with the reference's default settings."""
    dataset = dataset.lower()

    if dataset.startswith("inat2018"):
        dataset = "inat" + dataset[8:]

    kwargs = dict(extra)
    if dataset.endswith("-ilsvrcmean"):
        kwargs["mean"], kwargs["std"] = IMAGENET_MEAN, IMAGENET_STD
        dataset = dataset[:-11]
    elif dataset.endswith("-caffe"):
        kwargs["mean"], kwargs["std"] = CAFFE_MEAN, CAFFE_STD
        kwargs["color_mode"] = "bgr"
        dataset = dataset[:-6]
    if dataset.endswith("-large"):
        kwargs["cropsize"] = (448, 448)
        kwargs["default_target_size"] = 512
        dataset = dataset[:-6]

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
            data_root, classes, reenumerate=True, cifar10=True, **kwargs
        )
    if dataset == "cifar-100":
        return CifarDataset(data_root, classes, reenumerate=True, **kwargs)
    if dataset.startswith("cifar-100-a"):
        return CifarDataset(
            data_root, np.arange(50), reenumerate=dataset.endswith("-consec"),
            **kwargs,
        )
    if dataset.startswith("cifar-100-b"):
        return CifarDataset(
            data_root, np.arange(50, 100),
            reenumerate=dataset.endswith("-consec"), **kwargs,
        )

    if dataset == "ilsvrc":
        return ILSVRCDataset(data_root, classes, **kwargs)

    if dataset == "nab":
        if "default_target_size" not in kwargs and "randzoom_range" not in kwargs:
            kwargs["randzoom_range"] = (256, 480)
        return NABDataset(data_root, classes, img_dir="images", **kwargs)

    if dataset == "cub" or dataset.startswith("cub-sub"):
        kwargs.setdefault("mean", CUB_STATS[0])
        kwargs.setdefault("std", CUB_STATS[1])
        if dataset.startswith("cub-sub"):
            per_class = int(dataset[7:])
            kwargs["split_file"] = f"train_test_split_{per_class}.txt"
            kwargs["train_repeats"] = 30 // per_class
        return NABDataset(
            data_root, classes, img_dir="images", cropsize=(448, 448),
            default_target_size=512, randzoom_range=None, **kwargs,
        )

    if dataset == "cars":
        return CarsDataset(data_root, classes, **kwargs)

    if dataset == "flowers":
        return FlowersDataset(data_root, classes, **kwargs)

    if dataset == "inat" or dataset.startswith("inat_"):
        supercategory = dataset[5:] if dataset.startswith("inat_") else None
        if "default_target_size" not in kwargs and "randzoom_range" not in kwargs:
            kwargs["randzoom_range"] = (256, 480)
        return INatDataset(data_root, supercategory=supercategory, **kwargs)

    if dataset == "inat2019":
        if "mean" not in kwargs and "std" not in kwargs:
            kwargs["mean"], kwargs["std"] = INAT2019_STATS
        if "default_target_size" not in kwargs and "randzoom_range" not in kwargs:
            kwargs["randzoom_range"] = (256, 480)
        return INatDataset(
            data_root, "train2019.json", "val2019.json", **kwargs
        )

    if dataset == "mit67scenes":
        if "mean" not in kwargs and "std" not in kwargs:
            kwargs["mean"], kwargs["std"] = MIT67_STATS
        return SubDirectoryDataset(
            data_root, classes, img_dir="Images",
            train_list="TrainImages.txt", test_list="TestImages.txt", **kwargs,
        )
    if dataset == "ucmlu":
        if "mean" not in kwargs and "std" not in kwargs:
            kwargs["mean"], kwargs["std"] = UCMLU_STATS
        return SubDirectoryDataset(data_root, classes, **kwargs)
    if dataset == "resisc45":
        if "mean" not in kwargs and "std" not in kwargs:
            kwargs["mean"], kwargs["std"] = RESISC45_STATS
        return SubDirectoryDataset(data_root, classes, **kwargs)

    raise ValueError(f"Unknown dataset: {dataset}")


__all__ = [
    "get_data_generator",
    "DatasetBase",
    "InMemoryDataset",
    "CifarDataset",
    "SyntheticDataset",
    "FileDataset",
    "NABDataset",
    "CarsDataset",
    "FlowersDataset",
    "ILSVRCDataset",
    "INatDataset",
    "SubDirectoryDataset",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "CAFFE_MEAN",
    "CAFFE_STD",
    "CUB_STATS",
]
