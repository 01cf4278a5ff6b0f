"""The port's native JPEG decoder against the JAX package's: bitwise equal
batches and success flags for the same files, targets and seeds (both are
built from one source with the same g++ flags on this host); a failed build
raises, and ``--decoder auto`` then decodes with Pillow."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import os
import shutil

import numpy as np
import pytest

from semantic_embeddings_torch import native as tnative
from semantic_embeddings_tpu import native as jnative


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """JPEGs of several sizes, one grayscale, one truncated and one that is
    not a JPEG at all."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(80, 60), (45, 90), (32, 32), (200, 150), (17, 23),
                                (301, 97)]):
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        p = str(root / f"img{i}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)
    gray = str(root / "gray.jpg")
    Image.fromarray(rng.integers(0, 256, (50, 70)).astype(np.uint8), "L").save(gray)
    paths.append(gray)
    with open(paths[3], "rb") as f:
        blob = f.read()
    truncated = str(root / "truncated.jpg")
    with open(truncated, "wb") as f:
        f.write(blob[: len(blob) // 2])
    paths.append(truncated)
    bad = str(root / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    paths.append(bad)
    return paths


CASES = [  # (target sizes, random crop, crop h, crop w)
    ([48] * 9, False, 40, 40),          # center crops
    ([48] * 9, True, 40, 40),           # random crops
    ([0] * 9, True, 64, 96),            # no resize, reflect padding
    ([20, 130, 33, 64, 0, 500, 48, 64, 48], True, 56, 44),  # mixed targets, pads
    ([300] * 9, False, 224, 224),       # upsampling
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_decode_batch_bitwise_equal_to_jax(jpegs, case):
    targets, random_crop, ch, cw = CASES[case]
    seeds = [11 * i + 3 for i in range(len(jpegs))]
    got, ok = tnative.decode_batch(jpegs, targets, seeds, random_crop, ch, cw, n_threads=3)
    want, ok_j = jnative.decode_batch(jpegs, targets, seeds, random_crop, ch, cw,
                                      n_threads=3)
    np.testing.assert_array_equal(ok, ok_j)
    assert ok.tolist() == [True] * 8 + [False]  # truncated decodes leniently
    np.testing.assert_array_equal(got[ok], want[ok_j])
    gray = got[6]
    assert np.array_equal(gray[..., 0], gray[..., 1]) and np.array_equal(gray[..., 1],
                                                                         gray[..., 2])


@pytest.mark.parametrize("random_crop", [False, True])
def test_decode_mem_batch_bitwise_equal_to_jax_and_to_files(jpegs, random_crop):
    blobs = []
    for p in jpegs:
        with open(p, "rb") as f:
            blobs.append(f.read())
    n = len(blobs)
    targets, seeds = [52] * n, list(range(1, n + 1))
    got, ok = tnative.decode_mem_batch(blobs, targets, seeds, random_crop, 48, 40)
    want, ok_j = jnative.decode_mem_batch(blobs, targets, seeds, random_crop, 48, 40)
    files, ok_f = tnative.decode_batch(jpegs, targets, seeds, random_crop, 48, 40)
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(ok, ok_f)
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_array_equal(got[ok], files[ok])


def test_corrupt_bodies_fail_cleanly_many_times(jpegs):
    with open(jpegs[3], "rb") as f:
        blob = f.read()
    garbage = blob[:2] + b"\xff\x00" * 40  # a valid start marker, broken markers
    for _ in range(30):
        out, ok = tnative.decode_mem_batch([blob[: len(blob) // 3], garbage, b""],
                                           [64] * 3, [1, 2, 3], False, 56, 56)
        assert ok.tolist() == [True, False, False]
        assert out.shape == (3, 56, 56, 3)


def test_argument_checks():
    with pytest.raises(ValueError, match="targets"):
        tnative.decode_batch(["a.jpg", "b.jpg"], [1], [1, 2], False, 4, 4)
    with pytest.raises(ValueError, match="crop size"):
        tnative.decode_mem_batch([b""], [1], [1], False, 0, 4)


def test_library_is_built_under_build_native():
    path = tnative.library_path()
    tnative.loader()
    assert path.is_file()
    assert path.parent.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    source = tmp_path / "sed_decode.cpp"
    shutil.copy(tnative.SOURCE, source)
    text = source.read_text().replace("#include <jpeglib.h>",
                                      "#include <no_such_header_for_this_test.h>")
    source.write_text(text)
    with pytest.raises(RuntimeError, match="no_such_header_for_this_test.h"):
        tnative.loader(source, tmp_path / "build")
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").rglob("*"))
    assert os.path.exists(tnative.SOURCE)  # the repository's source is untouched


def _broken_loader(tmp_path, monkeypatch):
    """Makes every build of the decoder fail, as on a host without libjpeg."""
    source = tmp_path / "sed_decode.cpp"
    source.write_text(tnative.SOURCE.read_text().replace(
        "#include <jpeglib.h>", "#include <no_such_header_for_this_test.h>"))
    build = tnative.loader
    monkeypatch.setattr(tnative, "loader", lambda: build(source, tmp_path / "build"))


def test_auto_decoder_takes_pillow_where_the_build_fails(tmp_path, monkeypatch, capsys):
    """``--decoder auto`` prints the JAX loader's message and gives Pillow's
    batches bitwise (the JAX package's Pillow path); ``--decoder native``
    raises with g++'s output."""
    from argparse import Namespace

    from _torch_files_common import write_nab
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.data import CUB_STATS
    from semantic_embeddings_torch.data.datasets import NABDataset
    from semantic_embeddings_tpu.data.datasets import NABDataset as JNABDataset

    root = write_nab(str(tmp_path / "cub"), n_classes=3, per_class=3, test_every=3)
    kw = {"cropsize": (24, 20), "default_target_size": 28, "mean": CUB_STATS[0],
          "std": CUB_STATS[1]}
    _broken_loader(tmp_path, monkeypatch)
    assert common.resolve_decoder("pillow") == "pillow"

    ours = common.apply_pipeline_args(
        NABDataset(root, **kw), Namespace(read_workers=2, queue_size=2, decoder="auto"))
    out = capsys.readouterr().out
    assert "native decoder unavailable (g++ failed" in out
    assert "no_such_header_for_this_test.h" in out and "; using PIL fallback" in out
    assert "Pillow decoder (--decoder auto)" in out and ours.use_native is False
    ref = JNABDataset(root, **kw)
    ref.use_native = False
    n = 0
    for a, b in zip(ours.train_batches(4, epoch=1, seed=3),
                    ref.train_batches(4, epoch=1, seed=3), strict=True):
        np.testing.assert_array_equal(a["image"].numpy(), np.asarray(b["image"]))
        n += 1
    assert n == 2

    strict = common.apply_pipeline_args(
        NABDataset(root, **kw), Namespace(read_workers=2, queue_size=2, decoder="native"))
    assert strict.use_native is True
    with pytest.raises(RuntimeError, match="no_such_header_for_this_test.h"):
        next(iter(strict.test_batches(3)))


def test_auto_decoder_takes_native_where_it_builds(capsys):
    from semantic_embeddings_torch.cli import common

    assert common.resolve_decoder("auto") == "native"
    assert "unavailable" not in capsys.readouterr().out
