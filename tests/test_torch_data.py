"""The port's datasets and augmentation against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.data import augment as jaugment
from semantic_embeddings_tpu.data.cifar import SyntheticDataset as JSyntheticDataset
from semantic_embeddings_torch.data import augment, get_data_generator
from semantic_embeddings_torch.data.cifar import SyntheticDataset


def test_synthetic_dataset_arrays_equal_jax():
    kw = dict(num_classes=7, n_train=50, n_test=20, size=12, seed=3)
    ours, ref = SyntheticDataset(**kw), JSyntheticDataset(**kw)
    np.testing.assert_array_equal(ours._x_train_host, ref._x_train_host)
    np.testing.assert_array_equal(ours._x_test_host, ref._x_test_host)
    np.testing.assert_array_equal(ours.labels_train, ref.labels_train)
    np.testing.assert_array_equal(ours.labels_test, ref.labels_test)
    np.testing.assert_array_equal(ours.mean, ref.mean)
    np.testing.assert_array_equal(ours.std, ref.std)
    assert ours.classes == ref.classes
    assert (ours.width_shift, ours.height_shift, ours.zoom, ours.hflip) == (
        0.15, 0.15, 0.0, True)


def test_batches_equal_jax():
    kw = dict(num_classes=5, n_train=37, n_test=11, size=4)
    ours, ref = SyntheticDataset(**kw), JSyntheticDataset(**kw)
    for a, b in zip(ours.train_batches(8, epoch=2, seed=4),
                    ref.train_batches(8, epoch=2, seed=4), strict=True):
        np.testing.assert_array_equal(a["idx"], b["idx"])
    for a, b in zip(ours.test_batches(4), ref.test_batches(4), strict=True):
        np.testing.assert_array_equal(a["idx"], b["idx"])
        np.testing.assert_array_equal(a["valid"], b["valid"])
    assert ours.steps_per_epoch(8) == ref.steps_per_epoch(8) == 5


def test_registry_synthetic_sizes_and_classes():
    ds = get_data_generator("synthetic-10-64-32", classes=list(range(100, 110)))
    assert (ds.num_classes, ds.num_train, ds.num_test) == (10, 64, 32)
    assert ds.class_indices[103] == 3
    # the file datasets are ported: a missing directory is the error now
    with pytest.raises(FileNotFoundError):
        get_data_generator("ilsvrc", "/nonexistent")
    with pytest.raises(ValueError, match="Unknown dataset"):
        get_data_generator("no-such-dataset", "/nonexistent")


@pytest.mark.parametrize("size", [(32, 32), (9, 14)])
def test_affine_apply_matches_jax(size):
    """Fixed shift/zoom/flip through the port's gather and through
    ``_affine_sample`` under ``vmap``: bilinear weights computed the same
    way in f32, so 0..255 pixels agree to 1e-4."""
    h, w = size
    rng = np.random.default_rng(0)
    b = 12
    images = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    ty = rng.uniform(-0.3 * h, 0.3 * h, b).astype(np.float32)
    tx = rng.uniform(-0.3 * w, 0.3 * w, b).astype(np.float32)
    zy = rng.uniform(0.7, 1.3, b).astype(np.float32)
    zx = rng.uniform(0.7, 1.3, b).astype(np.float32)
    flip = rng.random(b) < 0.5
    ty[0] = tx[0] = 0.0
    zy[0] = zx[0] = 1.0
    flip[0] = False  # the identity
    ref = jax.vmap(jaugment._affine_sample)(
        jnp.asarray(images), jnp.asarray(ty), jnp.asarray(tx), jnp.asarray(zy),
        jnp.asarray(zx), jnp.asarray(flip))
    ours = augment.affine_apply(torch.from_numpy(images), *map(
        torch.from_numpy, (ty, tx, zy, zx, flip)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[0].numpy(), images[0])


def test_drawn_affine_params_in_range():
    gen = torch.Generator().manual_seed(0)
    b, h, w = 4000, 32, 24
    ty, tx, zy, zx, flip = augment.draw_affine_params(
        b, h, w, gen, width_shift=0.15, height_shift=0.1, zoom=0.25, hflip=True)
    assert ty.abs().max() <= 0.1 * h and tx.abs().max() <= 0.15 * w
    assert ty.abs().max() > 0.09 * h and tx.abs().max() > 0.14 * w  # spans it
    assert zy.min() >= 0.75 and zy.max() <= 1.25 and zx.min() >= 0.75
    assert abs(flip.float().mean().item() - 0.5) < 0.05
    ty0, tx0, zy0, zx0, flip0 = augment.draw_affine_params(b, h, w, gen)
    assert not ty0.any() and not tx0.any() and not flip0.any()
    assert (zy0 == 1).all() and (zx0 == 1).all()


def test_prepare_eval_matches_jax_and_train_augments():
    kw = dict(num_classes=5, n_train=40, n_test=10, size=8)
    ours, ref = SyntheticDataset(**kw), JSyntheticDataset(**kw)
    raw = next(ours.test_batches(10))
    images, labels = ours.make_prepare(torch.device("cpu"))(raw, None, False)
    ref_images, ref_labels = ref.make_prepare()(
        {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(0), False)
    np.testing.assert_allclose(images.numpy(), np.asarray(ref_images),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))

    raw = next(ours.train_batches(16, 0, 0))
    gen = torch.Generator().manual_seed(1)
    images, labels = ours.make_prepare(torch.device("cpu"))(raw, gen, True)
    assert images.shape == (16, 8, 8, 3) and images.dtype == torch.float32
    assert labels.dtype == torch.int64 and torch.isfinite(images).all()
    plain = (torch.from_numpy(ours._x_train_host[raw["idx"]]).float()
             - torch.from_numpy(ours.mean)) / torch.from_numpy(ours.std)
    assert not torch.allclose(images, plain)  # augmented


def test_random_flip_and_normalize():
    gen = torch.Generator().manual_seed(2)
    x = torch.arange(2 * 3 * 4 * 1, dtype=torch.float32).reshape(2, 3, 4, 1)
    out = augment.random_flip(x, gen)
    for i in range(2):
        assert torch.equal(out[i], x[i]) or torch.equal(out[i], x[i].flip(1))
    mean, std = [1.0, 2.0, 3.0], [2.0, 4.0, 8.0]
    img = np.random.default_rng(0).uniform(0, 255, (2, 3, 3, 3)).astype(np.float32)
    ours = augment.normalize(torch.from_numpy(img), mean, std, bgr=True)
    ref = jaugment.normalize(jnp.asarray(img), mean, std, bgr=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
