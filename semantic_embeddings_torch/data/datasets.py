"""Concrete file-dataset parsers: NAB/CUB, Cars, Flowers, ILSVRC, iNat,
class-per-subdirectory (counterpart of the JAX package's
``data/datasets.py``).

Each class parses its dataset's file lists and annotations and carries its
default preprocessing statistics, on top of the
:class:`~semantic_embeddings_torch.data.files.FileDataset` pipeline.
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from .files import FileDataset

NAB_RANDERASE = {"sl": 0.02, "sh": 0.3, "r1": 0.3, "r2": 1.0 / 0.3}

# Pre-computed channel statistics (0-255 pixel scale).
NAB_STATS = ([125.30513277, 129.66606421, 118.45121113],
             [57.0045467, 56.70059436, 68.44430446])
CARS_STATS = ([120.03730636, 117.33780928, 116.0130335],
              [75.40415763, 75.15394251, 77.28286728])
FLOWERS_STATS = ([110.7799141, 97.65648664, 75.32889973],
                 [74.90387818, 62.70218863, 69.7656359])

INAT_SUPERCATEGORY_STATS = {
    None: ([119.99310088, 122.86333725, 102.38318464],
           [60.83471124, 59.33123704, 65.92057842]),
    "actinopterygii": ([95.60659929, 109.21340134, 99.53273934],
                       [62.64981594, 56.77583425, 57.79043402]),
    "amphibia": ([120.38820316, 112.09448704, 93.57291079],
                 [64.38971069, 60.88945117, 60.689195]),
    "animalia": ([117.86148813, 112.27558493, 100.76823038],
                 [65.10786879, 60.9941875, 61.3212783]),
    "arachnida": ([123.05328454, 123.11786486, 99.49669769],
                  [62.10607939, 59.69295922, 64.12102046]),
    "aves": ([125.68554284, 131.58931007, 123.51576605],
             [56.91926625, 57.04151665, 67.97284604]),
    "bacteria": ([130.44253929, 118.58949652, 100.64353881],
                 [63.52655078, 61.3866035, 62.52496727]),
    "chromista": ([126.63609004, 120.30744082, 103.69842308],
                  [61.3142875, 60.35121831, 64.33445667]),
    "fungi": ([105.4904181, 98.20844854, 81.95195412],
              [66.43803547, 63.26916273, 61.75505097]),
    "insecta": ([126.79141945, 126.55725101, 94.4626541],
                [62.46710552, 59.70656548, 64.38703598]),
    "mammalia": ([119.32537707, 119.28610021, 105.22655576],
                 [60.25561291, 58.86410094, 60.85549787]),
    "mollusca": ([119.15865454, 107.82338741, 93.65438902],
                 [65.54171188, 62.00986655, 62.64830566]),
    "plantae": ([109.4558912, 115.78290918, 84.83970548],
                [60.36177593, 59.17162815, 60.81183456]),
    "protozoa": ([99.4855571, 90.12976005, 71.67906874],
                 [69.23439903, 63.83415135, 59.1059619]),
    "reptilia": ([126.42469824, 119.44987437, 103.84680809],
                 [63.4749642, 60.19704406, 60.20556052]),
}


class NABDataset(FileDataset):
    """NABirds / CUB-200-2011: images.txt + train_test_split.txt +
    image_class_labels.txt triplets."""

    def __init__(self, root_dir, classes=None, img_dir="images",
                 img_list_file="images.txt", split_file="train_test_split.txt",
                 label_file="image_class_labels.txt", cropsize=(224, 224),
                 default_target_size=256, randzoom_range=None,
                 distort_colors=False, randerase_prob=0.5,
                 randerase_params=None, mean=NAB_STATS[0], std=NAB_STATS[1],
                 color_mode="rgb", train_repeats=1, **kwargs):
        super().__init__(
            root_dir, cropsize=cropsize,
            default_target_size=default_target_size,
            randzoom_range=randzoom_range, distort_colors=distort_colors,
            colordistort_params={"hue_delta": 0.0, "saturation_range": (0.8, 1.2)},
            randerase_prob=randerase_prob,
            randerase_params=randerase_params or NAB_RANDERASE,
            color_mode=color_mode, **kwargs,
        )
        self.train_repeats = train_repeats
        imgs_dir = os.path.join(root_dir, img_dir)

        def read_pairs(name):
            with open(os.path.join(root_dir, name)) as f:
                return dict(
                    line.split() for line in (l.strip() for l in f) if line
                )

        is_train = {k: v != "0" for k, v in read_pairs(split_file).items()}
        img_labels = {k: int(v) for k, v in read_pairs(label_file).items()}

        self.classes = (
            list(classes) if classes is not None
            else sorted(set(img_labels.values()))
        )
        self.class_indices = {c: i for i, c in enumerate(self.classes)}

        for img_id, fn in read_pairs(img_list_file).items():
            if img_id in is_train and img_labels[img_id] in self.class_indices:
                label = self.class_indices[img_labels[img_id]]
                if is_train[img_id]:
                    self.train_img_files.append(os.path.join(imgs_dir, fn))
                    self._train_labels.append(label)
                else:
                    self.test_img_files.append(os.path.join(imgs_dir, fn))
                    self._test_labels.append(label)
        self._finalize(mean, std)


class CarsDataset(FileDataset):
    """Stanford Cars from ``cars_annos.mat``."""

    def __init__(self, root_dir, classes=None, annotation_file="cars_annos.mat",
                 cropsize=(448, 448), default_target_size=512,
                 randzoom_range=None, distort_colors=False, randerase_prob=0.5,
                 randerase_params=None, mean=CARS_STATS[0], std=CARS_STATS[1],
                 color_mode="rgb", **kwargs):
        import scipy.io

        super().__init__(
            root_dir, cropsize=cropsize,
            default_target_size=default_target_size,
            randzoom_range=randzoom_range, distort_colors=distort_colors,
            randerase_prob=randerase_prob,
            randerase_params=randerase_params or NAB_RANDERASE,
            color_mode=color_mode, **kwargs,
        )
        path = (
            annotation_file if os.path.isabs(annotation_file)
            else os.path.join(root_dir, annotation_file)
        )
        annos = scipy.io.loadmat(path, squeeze_me=True)["annotations"]
        self.classes = (
            list(classes) if classes is not None
            else sorted(set(annos["class"]))
        )
        self.class_indices = {c: i for i, c in enumerate(self.classes)}
        for sample in annos:
            if sample["class"] in self.class_indices:
                rel = str(sample["relative_im_path"])
                fn = rel if os.path.isabs(rel) else os.path.join(root_dir, rel)
                label = self.class_indices[sample["class"]]
                if sample["test"]:
                    self.test_img_files.append(fn)
                    self._test_labels.append(label)
                else:
                    self.train_img_files.append(fn)
                    self._train_labels.append(label)
        self._finalize(mean, std)


class FlowersDataset(FileDataset):
    """Oxford Flowers-102 from MATLAB label/split files; train = trnid +
    valid splits."""

    def __init__(self, root_dir, classes=None, img_dir="jpg",
                 label_file="imagelabels.mat", split_file="setid.mat",
                 train_splits=("trnid", "valid"), test_splits=("tstid",),
                 cropsize=(448, 448), default_target_size=512,
                 randzoom_range=None, distort_colors=False, randerase_prob=0.5,
                 randerase_params=None, mean=FLOWERS_STATS[0],
                 std=FLOWERS_STATS[1], color_mode="rgb", **kwargs):
        import scipy.io

        super().__init__(
            root_dir, cropsize=cropsize,
            default_target_size=default_target_size,
            randzoom_range=randzoom_range, distort_colors=distort_colors,
            colordistort_params={"hue_delta": 0.0, "saturation_range": (0.8, 1.2)},
            randerase_prob=randerase_prob,
            randerase_params=randerase_params or NAB_RANDERASE,
            color_mode=color_mode, **kwargs,
        )
        img_root = (
            img_dir if os.path.isabs(img_dir) else os.path.join(root_dir, img_dir)
        )
        lp = label_file if os.path.isabs(label_file) else os.path.join(root_dir, label_file)
        sp = split_file if os.path.isabs(split_file) else os.path.join(root_dir, split_file)
        img_labels = scipy.io.loadmat(lp, squeeze_me=True)["labels"]
        splits = scipy.io.loadmat(sp, squeeze_me=True)

        self.classes = (
            list(classes) if classes is not None
            else sorted(set(int(l) for l in img_labels))
        )
        self.class_indices = {c: i for i, c in enumerate(self.classes)}

        def collect(split_names, files, labels):
            for name in split_names:
                for i in np.atleast_1d(splits[name]):
                    files.append(
                        os.path.join(img_root, f"image_{int(i):05d}.jpg")
                    )
                    labels.append(self.class_indices[int(img_labels[int(i) - 1])])

        collect(train_splits, self.train_img_files, self._train_labels)
        collect(test_splits, self.test_img_files, self._test_labels)
        self._finalize(mean, std)


class ILSVRCDataset(FileDataset):
    """ImageNet train/val synset directories."""

    def __init__(self, root_dir, classes=None, mean=None, std=None,
                 color_mode="rgb", **kwargs):
        from . import IMAGENET_MEAN, IMAGENET_STD

        super().__init__(
            root_dir, cropsize=(224, 224), default_target_size=256,
            randzoom_range=(256, 480), color_mode=color_mode, **kwargs,
        )
        mean = IMAGENET_MEAN if mean is None else mean
        std = IMAGENET_STD if std is None else std
        train_dir = os.path.join(root_dir, "ILSVRC2012_img_train")
        test_dir = os.path.join(root_dir, "ILSVRC2012_img_val")

        if classes is None:
            classes = sorted(
                d for d in os.listdir(train_dir)
                if os.path.isdir(os.path.join(train_dir, d))
            )
        self.classes = list(classes)
        self.class_indices = {c: i for i, c in enumerate(self.classes)}

        exts = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".tif", ".tiff")
        for label, synset in enumerate(self.classes):
            for base, files in ((train_dir, self.train_img_files),
                                (test_dir, self.test_img_files)):
                subdir = os.path.join(base, synset)
                found = sorted(
                    os.path.join(subdir, f)
                    for f in os.listdir(subdir)
                    if f.lower().endswith(exts)
                ) if os.path.isdir(subdir) else []
                files += found
                if base is train_dir:
                    self._train_labels += [label] * len(found)
                else:
                    self._test_labels += [label] * len(found)
        self._finalize(mean, std)


class INatDataset(FileDataset):
    """iNaturalist 2018/2019 COCO-style JSON with supercategory filtering."""

    def __init__(self, root_dir, train_file="train2018.json",
                 val_file="val2018.json", supercategory=None,
                 cropsize=(224, 224), default_target_size=256,
                 mean=None, std=None, **kwargs):
        super().__init__(
            root_dir, cropsize=cropsize,
            default_target_size=default_target_size, **kwargs,
        )
        if supercategory is not None:
            supercategory = supercategory.lower()

        def parse(fname):
            path = fname if os.path.isabs(fname) else os.path.join(root_dir, fname)
            with open(path) as f:
                data = json.load(f)
            images = {img["id"]: img for img in data["images"]}
            cats = {
                c["id"]: c for c in data["categories"]
                if supercategory is None
                or c["supercategory"].lower() == supercategory
            }
            old2new = {old: new for new, old in enumerate(sorted(cats))}
            mapping = {cats[old]["name"]: new for old, new in old2new.items()}
            tuples = []
            for ann in data["annotations"]:
                cid = ann["category_id"]
                if cid in cats:
                    fn = os.path.abspath(
                        os.path.join(root_dir, images[ann["image_id"]]["file_name"])
                    )
                    tuples.append((old2new[cid], fn))
            return tuples, mapping

        train_tuples, mapping = parse(train_file)
        test_tuples, _ = parse(val_file)
        self._train_labels = [t[0] for t in train_tuples]
        self.train_img_files = [t[1] for t in train_tuples]
        self._test_labels = [t[0] for t in test_tuples]
        self.test_img_files = [t[1] for t in test_tuples]
        self.classes = [c for c, _ in sorted(mapping.items(), key=lambda t: t[1])]
        self.class_indices = mapping

        if mean is None and std is None and supercategory in INAT_SUPERCATEGORY_STATS:
            mean, std = INAT_SUPERCATEGORY_STATS[supercategory]
        self._finalize(mean, std)


class SubDirectoryDataset(FileDataset):
    """Class-per-subdirectory datasets with train/test list files: MIT67,
    UCMLU, RESISC45."""

    def __init__(self, root_dir, classes=None, img_dir=".",
                 train_list="train.txt", test_list="test.txt",
                 cropsize=(224, 224), default_target_size=256,
                 randzoom_range=None, randerase_prob=0.5,
                 randerase_params=None, mean=None, std=None,
                 color_mode="rgb", **kwargs):
        super().__init__(
            root_dir, cropsize=cropsize,
            default_target_size=default_target_size,
            randzoom_range=randzoom_range, randerase_prob=randerase_prob,
            randerase_params=randerase_params or NAB_RANDERASE,
            color_mode=color_mode, **kwargs,
        )
        img_root = (
            img_dir if os.path.isabs(img_dir) else os.path.join(root_dir, img_dir)
        )
        if classes is not None:
            self.classes = list(classes)
        else:
            self.classes = sorted(
                os.path.basename(d)
                for d in glob(os.path.join(img_root, "*"))
                if os.path.isdir(d) and not os.path.basename(d).startswith(".")
            )
        self.class_indices = {c: i for i, c in enumerate(self.classes)}

        def collect(list_file, files, labels):
            path = (
                list_file if os.path.isabs(list_file)
                else os.path.join(root_dir, list_file)
            )
            with open(path) as f:
                for line in (l.strip() for l in f):
                    if not line:
                        continue
                    classname = os.path.dirname(line)
                    if classname in self.class_indices:
                        files.append(os.path.join(img_root, line))
                        labels.append(self.class_indices[classname])

        collect(train_list, self.train_img_files, self._train_labels)
        collect(test_list, self.test_img_files, self._test_labels)
        self._finalize(mean, std)
