"""Writers of tiny file datasets in each registry dataset's own on-disk
layout, for the tests that hold the port's file datasets against the JAX
package's (real JPEGs from a seed, written with Pillow)."""

import json
import os

import numpy as np


def jpeg(path, rng, size=(40, 48), gray=False, quality=90, label=None):
    """Writes an (h, w) JPEG of noise (around a level set by ``label``, so
    that classes differ) and returns its path."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = size
    base = 128 if label is None else 40 + (37 * label) % 170
    arr = np.clip(base + rng.integers(-60, 60, (h, w, 3)), 0, 255).astype(np.uint8)
    img = Image.fromarray(arr[..., 0], "L") if gray else Image.fromarray(arr)
    img.save(path, quality=quality)
    return path


def write_nab(root, n_classes=4, per_class=4, test_every=3, seed=0, sizes=None,
              split_files=()):
    """NABirds/CUB layout: images/<class>/<n>.jpg, images.txt,
    image_class_labels.txt, train_test_split.txt (+ ``split_files``,
    e.g. ``train_test_split_1.txt``) and classes.txt.  Image 0 is
    grayscale."""
    rng = np.random.default_rng(seed)
    lines_img, lines_label, lines_split, lines_cls = [], [], [], []
    i = 0
    for c in range(1, n_classes + 1):
        lines_cls.append(f"{c} {c:03d}.class_{c}")
        for k in range(per_class):
            fn = f"{c:03d}.class_{c}/{k}.jpg"
            size = sizes[i % len(sizes)] if sizes else (30 + 3 * i % 17, 36 + 5 * i % 13)
            jpeg(os.path.join(root, "images", fn), rng, size, gray=(i == 0), label=c)
            lines_img.append(f"{i + 1} {fn}")
            lines_label.append(f"{i + 1} {c}")
            lines_split.append(f"{i + 1} {0 if k % test_every == test_every - 1 else 1}")
            i += 1
    for name, lines in (("images.txt", lines_img), ("image_class_labels.txt", lines_label),
                        ("train_test_split.txt", lines_split), ("classes.txt", lines_cls)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    for name in split_files:
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines_split) + "\n")
    return root


def write_cars(root, n=8, seed=0):
    import scipy.io

    rng = np.random.default_rng(seed)
    rec = np.zeros((n,), dtype=[("relative_im_path", "O"), ("bbox_x1", "O"),
                                ("class", "O"), ("test", "O")])
    for i in range(n):
        rel = f"car_ims/{i:06d}.jpg"
        jpeg(os.path.join(root, rel), rng, label=i % 2)
        rec[i] = (rel, 1, (i % 2) + 1, i >= 5)
    scipy.io.savemat(os.path.join(root, "cars_annos.mat"), {"annotations": rec})
    return root


def write_flowers(root, seed=0):
    import scipy.io

    rng = np.random.default_rng(seed)
    labels = np.asarray([1, 1, 2, 2, 1, 2], dtype=np.int64)
    for i in range(1, 7):
        jpeg(os.path.join(root, "jpg", f"image_{i:05d}.jpg"), rng, label=int(labels[i - 1]))
    scipy.io.savemat(os.path.join(root, "imagelabels.mat"), {"labels": labels})
    scipy.io.savemat(os.path.join(root, "setid.mat"), {
        "trnid": np.asarray([1, 3]), "valid": np.asarray([5]),
        "tstid": np.asarray([2, 4, 6])})
    return root


def write_ilsvrc(root, seed=0):
    rng = np.random.default_rng(seed)
    for c, synset in enumerate(("n01440764", "n01443537")):
        for i in range(3):
            jpeg(os.path.join(root, "ILSVRC2012_img_train", synset,
                              f"{synset}_{i}.JPEG"), rng, label=c)
        jpeg(os.path.join(root, "ILSVRC2012_img_val", synset, f"val_{synset}.JPEG"),
             rng, label=c)
    return root


def write_inat(root, seed=0, years=("2018", "2019")):
    rng = np.random.default_rng(seed)

    def coco(ids, fnames, cat_of):
        return {
            "images": [{"id": i, "file_name": fn} for i, fn in zip(ids, fnames)],
            "annotations": [{"image_id": i, "category_id": cat_of[i]} for i in ids],
            "categories": [
                {"id": 7, "name": "Turdus merula", "supercategory": "Aves"},
                {"id": 3, "name": "Rana temporaria", "supercategory": "Amphibia"},
            ],
        }

    fnames = [f"train_val/img_{i}.jpg" for i in range(4)]
    for i, fn in enumerate(fnames):
        jpeg(os.path.join(root, fn), rng, label=i % 2)
    for year in years:
        with open(os.path.join(root, f"train{year}.json"), "w") as f:
            json.dump(coco([0, 1, 2], fnames[:3], {0: 7, 1: 3, 2: 7}), f)
        with open(os.path.join(root, f"val{year}.json"), "w") as f:
            json.dump(coco([3], fnames[3:], {3: 3}), f)
    return root


def write_subdirectory(root, img_dir=".", train_list="train.txt",
                       test_list="test.txt", seed=0):
    rng = np.random.default_rng(seed)
    files = {"kitchen": ["a.jpg", "b.jpg", "e.jpg"], "office": ["c.jpg", "d.jpg"]}
    for c, (cls, fns) in enumerate(files.items()):
        for fn in fns:
            jpeg(os.path.join(root, img_dir, cls, fn), rng, label=c)
    with open(os.path.join(root, train_list), "w") as f:
        f.write("kitchen/a.jpg\noffice/c.jpg\nkitchen/e.jpg\n\n")
    with open(os.path.join(root, test_list), "w") as f:
        f.write("kitchen/b.jpg\noffice/d.jpg\n")
    return root


def write_cifar(root, seed=0):
    """Tiny CIFAR-10 and CIFAR-100 python pickles in one directory."""
    import pickle

    rng = np.random.default_rng(seed)

    def dump(name, n, key, classes):
        data = rng.integers(0, 256, (n, 3 * 32 * 32)).astype(np.uint8)
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": data, key.encode(): list(np.arange(n) % classes)}, f)

    for i in range(1, 6):
        dump(f"data_batch_{i}", 20, "labels", 10)
    dump("test_batch", 10, "labels", 10)
    dump("train", 200, "fine_labels", 100)
    dump("test", 100, "fine_labels", 100)
    return root
