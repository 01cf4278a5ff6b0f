"""The port's file-dataset parsers and dataset registry against the JAX
package's: the same files, labels, classes, statistics and settings for the
same directory, parser by parser and registry name by registry name."""

import os

import numpy as np
import pytest

from _torch_files_common import (write_cars, write_cifar, write_flowers, write_ilsvrc,
                                 write_inat, write_nab, write_subdirectory)
from semantic_embeddings_torch import data as tdata
from semantic_embeddings_torch.data import datasets as tdatasets
from semantic_embeddings_tpu import data as jdata
from semantic_embeddings_tpu.data import datasets as jdatasets

FILE_SETTINGS = ("cropsize", "default_target_size", "randzoom_range", "randrot_max",
                 "distort_colors", "colordistort_params", "randerase_prob",
                 "randerase_params", "color_mode", "read_workers", "queue_size")
MEMORY_SETTINGS = ("width_shift", "height_shift", "zoom", "hflip")


def settings(ds):
    """Everything a dataset is made of that the two packages share."""
    out = {
        "type": type(ds).__name__,
        "classes": list(ds.classes),
        "class_indices": dict(ds.class_indices),
        "labels_train": np.asarray(ds.labels_train).tolist(),
        "labels_test": np.asarray(ds.labels_test).tolist(),
        "mean": np.asarray(ds.mean, np.float32).tolist(),
        "std": np.asarray(ds.std, np.float32).tolist(),
        "repeats": ds.repeats,
        "oversample": ds.oversample,
    }
    if hasattr(ds, "train_img_files"):
        out["train_files"] = list(ds.train_img_files)
        out["test_files"] = list(ds.test_img_files)
        out.update({k: getattr(ds, k) for k in FILE_SETTINGS})
    else:
        out.update({k: getattr(ds, k) for k in MEMORY_SETTINGS})
        out["x_train"] = ds._x_train_host.tobytes()
        out["x_test"] = ds._x_test_host.tobytes()
    return out


def assert_same(ours, ref):
    got, want = settings(ours), settings(ref)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


# -- the six parsers, on a directory in each one's layout ------------------

PARSERS = {
    "NABDataset": (write_nab, dict(cropsize=(24, 24), default_target_size=28)),
    "CarsDataset": (write_cars, dict(cropsize=(24, 24), default_target_size=28)),
    "FlowersDataset": (write_flowers, dict(cropsize=(24, 24), default_target_size=28)),
    "ILSVRCDataset": (write_ilsvrc, {}),
    "INatDataset": (write_inat, dict(cropsize=(24, 24), default_target_size=28)),
    "SubDirectoryDataset": (write_subdirectory, dict(cropsize=(24, 24),
                                                     default_target_size=28)),
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_jax(tmp_path, name):
    writer, kwargs = PARSERS[name]
    root = writer(str(tmp_path))
    ours = getattr(tdatasets, name)(root, **kwargs)
    ref = getattr(jdatasets, name)(root, **kwargs)
    assert_same(ours, ref)
    assert ours.num_train > 0 and ours.num_test > 0


@pytest.mark.parametrize("name,kwargs", [
    ("NABDataset", dict(classes=[3, 1], mean=None, std=None)),  # the statistics pass
    ("CarsDataset", dict(classes=[2])),
    ("ILSVRCDataset", dict(classes=["n01443537"])),
    ("INatDataset", dict(supercategory="aves", mean=None, std=None)),
    ("SubDirectoryDataset", dict(classes=["kitchen"], mean=None, std=None)),
])
def test_parser_class_subsets_and_statistics_match_jax(tmp_path, name, kwargs):
    writer, base = PARSERS[name]
    root = writer(str(tmp_path))
    kwargs = {**base, **kwargs}
    assert_same(getattr(tdatasets, name)(root, **kwargs),
                getattr(jdatasets, name)(root, **kwargs))


def test_statistics_tables_match_jax():
    for key in ("NAB_RANDERASE", "NAB_STATS", "CARS_STATS", "FLOWERS_STATS",
                "INAT_SUPERCATEGORY_STATS"):
        assert getattr(tdatasets, key) == getattr(jdatasets, key), key
    for key in ("CAFFE_MEAN", "CAFFE_STD", "IMAGENET_MEAN", "IMAGENET_STD", "MIT67_STATS",
                "UCMLU_STATS", "RESISC45_STATS", "CUB_STATS", "INAT2019_STATS"):
        assert getattr(tdata, key) == getattr(jdata, key), key


# -- the registry, name by name ---------------------------------------------

def _nab(root):
    write_nab(root, split_files=("train_test_split_1.txt", "train_test_split_5.txt"))


def _mit67(root):
    write_subdirectory(root, img_dir="Images", train_list="TrainImages.txt",
                       test_list="TestImages.txt")


LAYOUTS = {
    "nab": _nab, "cars": write_cars, "flowers": write_flowers, "ilsvrc": write_ilsvrc,
    "inat": write_inat, "mit67": _mit67, "subdirectory": write_subdirectory,
    "cifar": write_cifar,
}
REGISTRY = {
    "nab": "nab", "nab-large": "nab", "nab-caffe": "nab", "nab-ilsvrcmean": "nab",
    "nab-large-caffe": "nab", "cub": "nab", "cub-ilsvrcmean": "nab",
    "cub-sub1": "nab", "cub-sub5": "nab", "cars": "cars", "cars-large": "cars",
    "flowers": "flowers", "flowers-caffe": "flowers", "ilsvrc": "ilsvrc",
    "ilsvrc-caffe": "ilsvrc", "inat": "inat",
    "inat_aves": "inat", "inat_amphibia": "inat", "inat2018": "inat",
    "inat2018_aves": "inat", "inat2019": "inat", "inat-ilsvrcmean": "inat",
    "mit67scenes": "mit67", "ucmlu": "subdirectory", "resisc45": "subdirectory",
    "resisc45-large": "subdirectory", "cifar-10": "cifar", "cifar-100": "cifar",
    "cifar-100-a": "cifar", "cifar-100-a-consec": "cifar", "cifar-100-b": "cifar",
    "cifar-100-b-consec": "cifar", "synthetic": None, "synthetic-10": None,
    "synthetic-10-30-20": None,
}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    roots = {}
    for name, writer in LAYOUTS.items():
        root = str(tmp_path_factory.mktemp(name))
        writer(root)
        roots[name] = root
    return roots


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_registry_name_matches_jax(layouts, name):
    layout = REGISTRY[name]
    root = layouts[layout] if layout else None
    ours = tdata.get_data_generator(name, root)
    ref = jdata.get_data_generator(name, root)
    assert_same(ours, ref)


def test_registry_passes_classes_and_rejects_unknown_names(layouts):
    ours = tdata.get_data_generator("cub", layouts["nab"], classes=[4, 2])
    ref = jdata.get_data_generator("cub", layouts["nab"], classes=[4, 2])
    assert_same(ours, ref)
    assert ours.classes == [4, 2]
    with pytest.raises(ValueError, match="Unknown dataset"):
        tdata.get_data_generator("no-such-dataset", "/nonexistent")
    with pytest.raises(FileNotFoundError):
        tdata.get_data_generator("cub-sub10", layouts["nab"])  # no such split file


def test_cub_sub_repeats_and_split_file(layouts):
    ds = tdata.get_data_generator("cub-sub5", layouts["nab"])
    assert ds.repeats == 6 and ds.repeats == jdata.get_data_generator(
        "cub-sub5", layouts["nab"]).repeats
    # one epoch is repeats passes over the training images
    assert ds.steps_per_epoch(4) == int(np.ceil(ds.num_train * 6 / 4))
    assert os.path.isfile(os.path.join(layouts["nab"], "train_test_split_5.txt"))
