"""The file datasets' device augmentation against the JAX package's:
random erasing, color distortion (fast mode and each of the four orderings
of full mode), RGB <-> HSV, the crops and the whole ``make_prepare``, each
fed the JAX function's own draws (its key split as it splits it); and the
port's own draws against the JAX draws' distributions."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from _torch_files_common import write_nab
from semantic_embeddings_torch.data import augment
from semantic_embeddings_torch.data.datasets import NABDataset
from semantic_embeddings_tpu.data import augment as jaugment
from semantic_embeddings_tpu.data.datasets import NABDataset as JNABDataset

#: f32 on both sides; the same operations in the same order, up to the
#: libraries' own roundings (a mean's summation order): within 1e-5 of the
#: [0, 255] scale's unit
ATOL = 1e-5 * 255
RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (6, 20, 24, 3)).astype(np.float32)


def jax_erasing_draws(key, b, h, w, c, probability, sl, sh, r1, r2):
    """The draws of the JAX ``random_erasing`` for ``key``."""
    k_p, k_s, k_r, k_x, k_y, k_n = jax.random.split(key, 6)
    return (jax.random.bernoulli(k_p, probability, (b,)),
            jax.random.uniform(k_s, (b, 12), minval=sl, maxval=sh) * (h * w),
            jax.random.uniform(k_r, (b, 12), minval=r1, maxval=r2),
            jax.random.uniform(k_y, (b,)), jax.random.uniform(k_x, (b,)),
            jax.random.uniform(k_n, (b, h, w, c), minval=0.0, maxval=255.0))


def jax_color_draws(key, b, fast_mode, brightness_delta=32.0 / 255.0, hue_delta=0.2,
                    saturation_range=(0.5, 1.5), contrast_range=(0.5, 1.5)):
    """The draws of the JAX ``distort_color`` for ``key``."""
    keys = jax.random.split(key, 6)
    draws = {
        "bright": jax.random.uniform(keys[0], (b,), minval=-brightness_delta,
                                     maxval=brightness_delta),
        "sat": jax.random.uniform(keys[1], (b,), minval=saturation_range[0],
                                  maxval=saturation_range[1]),
    }
    if not fast_mode:
        draws["hue"] = jax.random.uniform(keys[2], (b,), minval=-hue_delta,
                                          maxval=hue_delta)
        draws["contrast"] = jax.random.uniform(
            keys[3], (b, 1, 1, 3), minval=contrast_range[0],
            maxval=contrast_range[1])[:, 0, 0, :]
        draws["order"] = jax.random.randint(keys[4], (b,), 0, 4)
    return {k: t(v) for k, v in draws.items()}


@pytest.mark.parametrize("probability,params", [
    (1.0, dict(sl=0.02, sh=0.4, r1=0.3, r2=1 / 0.3)),
    (0.5, dict(sl=0.02, sh=0.3, r1=0.3, r2=1 / 0.3)),  # NAB_RANDERASE
    (1.0, dict(sl=0.3, sh=0.9, r1=0.2, r2=5.0)),        # many candidates rejected
])
def test_random_erasing_apply_matches_jax(images, probability, params):
    mean, std = np.float32([120.0, 110.0, 100.0]), np.float32([60.0, 55.0, 65.0])
    x = (images - mean) / std
    key = jax.random.PRNGKey(3)
    want = jaugment.random_erasing(jnp.asarray(x), key, mean, std,
                                   probability=probability, **params)
    draws = jax_erasing_draws(key, *x.shape, probability, **params)
    got = augment.erasing_apply(t(x), t(mean), t(std), *(t(d) for d in draws))
    close(got, want, atol=1e-5, rtol=1e-5)
    assert (got.numpy() != x).any()


def test_rgb_hsv_match_jax(images):
    rgb = images / 255.0
    rgb[0, :3, :3] = 0.5  # gray pixels: delta 0
    rgb[1, :2, :2] = 0.0  # black: max 0
    close(augment.rgb_to_hsv(t(rgb)), jaugment.rgb_to_hsv(jnp.asarray(rgb)),
          atol=1e-6, rtol=1e-5)
    hsv = np.random.default_rng(1).uniform(0, 1, rgb.shape).astype(np.float32)
    hsv[0, 0, 0, 0] = 1.0  # the sector wrap
    close(augment.hsv_to_rgb(t(hsv)), jaugment.hsv_to_rgb(jnp.asarray(hsv)),
          atol=1e-6, rtol=1e-5)


def test_distort_color_fast_mode_matches_jax(images):
    key = jax.random.PRNGKey(5)
    kw = dict(hue_delta=0.0, saturation_range=(0.8, 1.2))  # NAB's
    want = jaugment.distort_color(jnp.asarray(images), key, fast_mode=True, **kw)
    got = augment.distort_color_apply(t(images), **jax_color_draws(key, 6, True, **kw))
    close(got, want)


@pytest.mark.parametrize("ordering", [0, 1, 2, 3])
def test_distort_color_full_mode_each_ordering_matches_jax(images, ordering):
    # find a key whose draws give the first image this ordering, and check
    # every image of the batch (all four orderings occur among them)
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        draws = jax_color_draws(key, 6, False)
        if int(draws["order"][0]) == ordering:
            break
    want = jaugment.distort_color(jnp.asarray(images), key, fast_mode=False)
    got = augment.distort_color_apply(t(images), **draws)
    close(got, want)


def test_crops_match_jax(images):
    key = jax.random.PRNGKey(9)
    want = jaugment.random_crop_batch(jnp.asarray(images), key, 13, 17)
    ky, kx = jax.random.split(key)
    uy, ux = t(jax.random.uniform(ky, (6,))), t(jax.random.uniform(kx, (6,)))
    np.testing.assert_array_equal(augment.crop_apply(t(images), uy, ux, 13, 17).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        augment.center_crop_batch(t(images), 13, 17).numpy(),
        np.asarray(jaugment.center_crop_batch(jnp.asarray(images), 13, 17)))
    gen = torch.Generator().manual_seed(0)
    out = augment.random_crop_batch(t(images), gen, 20, 24)  # the whole image
    np.testing.assert_array_equal(out.numpy(), images)


# -- make_prepare: the dataset's whole device side ---------------------------

@pytest.fixture(scope="module")
def nab_dir(tmp_path_factory):
    return write_nab(str(tmp_path_factory.mktemp("nab")))


@pytest.mark.parametrize("train,distort,erase,bgr", [
    (True, False, 0.5, False),   # NAB's defaults
    (True, True, 1.0, False),    # + color distortion (fast mode)
    (True, False, 0.0, True),    # BGR, no erasing
    (False, True, 1.0, False),   # the test path: normalization only
])
def test_make_prepare_matches_jax(nab_dir, train, distort, erase, bgr):
    kw = dict(cropsize=(24, 20), default_target_size=26, distort_colors=distort,
              randerase_prob=erase, color_mode="bgr" if bgr else "rgb")
    jds, ds = JNABDataset(nab_dir, **kw), NABDataset(nab_dir, **kw)
    raw = next(iter(ds.train_batches(5, epoch=0, seed=1)))
    jraw = {"image": jnp.asarray(raw["image"].numpy()), "label": jnp.asarray(raw["label"])}
    key = jax.random.PRNGKey(11)
    want_x, want_y = jds.make_prepare()(jraw, key, train)
    # the JAX prepare's draws: its key split as it splits it
    k_color, k_flip, k_erase = jax.random.split(key, 3)
    b, h, w, c = raw["image"].shape
    draws = {
        "color": (jax_color_draws(k_color, b, True, **ds.colordistort_params)
                  if distort else None),
        "flip": t(jax.random.bernoulli(jax.random.split(k_flip)[0], 0.5, (b,))),
        "erase": (tuple(t(d) for d in jax_erasing_draws(
            k_erase, b, h, w, c, erase,
            **{k: ds.randerase_params[k] for k in ("sl", "sh", "r1", "r2")}))
                  if erase > 0 else None),
    }
    ds.draw_augment = lambda *args: draws
    got_x, got_y = ds.make_prepare("cpu")(raw, None, train)
    assert got_x.dtype == torch.float32 and got_y.dtype == torch.int64
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    close(got_x, want_x, atol=1e-5, rtol=1e-5)


def test_make_prepare_draws_from_the_generator(nab_dir):
    ds = NABDataset(nab_dir, cropsize=(24, 20), default_target_size=26,
                    distort_colors=True, randerase_prob=1.0)
    raw = next(iter(ds.train_batches(5, epoch=0, seed=1)))
    prepare = ds.make_prepare("cpu")
    a, _ = prepare(raw, torch.Generator().manual_seed(4), True)
    b, _ = prepare(raw, torch.Generator().manual_seed(4), True)
    c, _ = prepare(raw, torch.Generator().manual_seed(5), True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    d, _ = ds.make_prepare("cpu", augment_train=False)(raw, None, True)
    e, _ = prepare(raw, None, False)
    torch.testing.assert_close(d, e, rtol=0, atol=0)


# -- the port's own draws: the distributions of the JAX draws ----------------

KS_P = 1e-3  # two-sample KS at N = 400 a side


def _erased_boxes(out, clean):
    areas, ratios = [], []
    h, w = clean.shape[1:3]
    for o, c in zip(out, clean):
        ys, xs = np.nonzero((o != c).any(-1))
        he, we = ys.max() - ys.min() + 1, xs.max() - xs.min() + 1
        areas.append(he * we / (h * w))
        ratios.append(np.log(he / we))
    return np.array(areas), np.array(ratios)


def test_erasing_draws_match_jax_distribution():
    n, h, w = 400, 40, 48
    clean = np.zeros((n, h, w, 3), np.float32)
    mean, std = np.float32([0.0] * 3), np.float32([1.0] * 3)
    ours = augment.random_erasing(t(clean), torch.Generator().manual_seed(6), t(mean),
                                  t(std), probability=1.0).numpy()
    ref = np.asarray(jaugment.random_erasing(jnp.asarray(clean), jax.random.PRNGKey(6),
                                             mean, std, probability=1.0))
    for a, b, what in zip(_erased_boxes(ours, clean), _erased_boxes(ref, clean),
                          ("area", "log aspect")):
        assert stats.ks_2samp(a, b).pvalue > KS_P, what


@pytest.mark.parametrize("fast_mode", [True, False])
def test_color_draws_match_jax_moments(images, fast_mode):
    n = 400
    batch = np.repeat(images[:1], n, axis=0)
    ours = augment.distort_color(t(batch), torch.Generator().manual_seed(8),
                                 fast_mode=fast_mode).numpy()
    ref = np.asarray(jaugment.distort_color(jnp.asarray(batch), jax.random.PRNGKey(8),
                                            fast_mode=fast_mode))
    for moment in (np.mean, np.std):
        a, b = moment(ours, axis=(1, 2, 3)), moment(ref, axis=(1, 2, 3))
        assert stats.ks_2samp(a, b).pvalue > KS_P, moment.__name__
    assert ours.min() >= -1e-3 and ours.max() <= 255.0 + 1e-3
    if not fast_mode:
        orders = augment.draw_color_params(n, torch.Generator().manual_seed(1),
                                           fast_mode=False)["order"]
        assert sorted(torch.bincount(orders).tolist())[0] > 60  # all four, evenly
