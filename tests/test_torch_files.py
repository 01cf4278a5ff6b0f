"""The port's file datasets against the JAX package's: bitwise equal uint8
batches, labels and masks from the three batch iterators (native decoder and
Pillow), the prefetch thread's stop and error paths, and the slice as a
whole: one train step of ``learn_image_embeddings`` on a CUB-layout
directory from the same weights, and the port's CLI end to end on it."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_files_common import jpeg, write_nab
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.data import CUB_STATS, get_data_generator
from semantic_embeddings_torch.data import files as tfiles
from semantic_embeddings_torch.data.datasets import NABDataset
from semantic_embeddings_tpu.data.datasets import NABDataset as JNABDataset


@pytest.fixture(scope="module")
def cub_dir(tmp_path_factory):
    """A CUB-layout directory: 4 classes of 4 images (3 train, 1 test),
    one grayscale, one a PNG under a .jpg name (libjpeg refuses it)."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("cub"))
    write_nab(root, n_classes=4, per_class=4, test_every=4,
              sizes=[(30, 41), (52, 37), (44, 44), (25, 60), (61, 33)])
    png_path = f"{root}/images/002.class_2/1.jpg"
    Image.open(png_path).save(png_path, format="PNG")
    return root


def _pair(root, use_native, **kw):
    kw = {"cropsize": (32, 28), "default_target_size": 36, "mean": CUB_STATS[0],
          "std": CUB_STATS[1], **kw}
    ours, ref = NABDataset(root, **kw), JNABDataset(root, **kw)
    ours.use_native = ref.use_native = use_native
    return ours, ref


def _same_batches(ours, ref):
    n = 0
    for a, b in zip(ours, ref, strict=True):
        assert sorted(a) == sorted(b)
        assert isinstance(a["image"], torch.Tensor) and a["image"].dtype == torch.uint8
        np.testing.assert_array_equal(a["image"].numpy(), np.asarray(b["image"]))
        for key in set(a) - {"image"}:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
        n += 1
    return n


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("zoom", [None, (30, 50), (0.8, 1.3)])
def test_batches_bitwise_equal_to_jax(cub_dir, use_native, zoom):
    ours, ref = _pair(cub_dir, use_native, randzoom_range=zoom)
    assert _same_batches(ours.train_batches(5, epoch=2, seed=7),
                         ref.train_batches(5, epoch=2, seed=7)) == 3
    assert _same_batches(ours.test_batches(3), ref.test_batches(3)) == 2
    for augment in (False, True):
        assert _same_batches(ours.train_eval_batches(5, augment=augment, epochs=2),
                             ref.train_eval_batches(5, augment=augment, epochs=2)) == 6
    # the PNG under a .jpg name: libjpeg refuses it, Pillow decodes it (once in
    # each of the 4 training passes, once or twice in the padded train epoch)
    assert ours.pillow_retries in ((5, 6) if use_native else (0,))


def test_rotation_and_median_cropsize_bitwise_equal_to_jax(cub_dir):
    ours, ref = _pair(cub_dir, True, cropsize=None, default_target_size=-1,
                      randrot_max=10)
    assert ours._resolved_cropsize() == ref._resolved_cropsize() == (41, 44)
    assert _same_batches(ours.train_batches(4, epoch=0, seed=1),
                         ref.train_batches(4, epoch=0, seed=1)) == 3
    assert _same_batches(ours.test_batches(4), ref.test_batches(4)) == 1


def test_augment_flag_reaches_the_host_transforms(cub_dir):
    """``train_eval_batches(augment=True)`` crops at random on the host (the
    train transform); without it, centered; in-memory datasets take the
    flag and change nothing."""
    ds, _ = _pair(cub_dir, True, default_target_size=48)
    plain = [b["image"].numpy() for b in ds.train_eval_batches(6, augment=False, epochs=2)]
    aug = [b["image"].numpy() for b in ds.train_eval_batches(6, augment=True, epochs=2)]
    np.testing.assert_array_equal(plain[0], plain[2])  # two passes, one center crop
    assert not np.array_equal(aug[0], aug[2])  # two passes, two random crops
    assert not np.array_equal(plain[0], aug[0])
    mem = get_data_generator("synthetic-4-8-4")
    a = [b["idx"] for b in mem.train_eval_batches(4, augment=True, epochs=2)]
    b = [b["idx"] for b in mem.train_eval_batches(4, augment=False, epochs=2)]
    np.testing.assert_array_equal(a, b)


def test_evaluation_cli_passes_augment(cub_dir, monkeypatch):
    from semantic_embeddings_torch.cli import evaluate_classification_accuracy as E

    seen = {}
    ds, _ = _pair(cub_dir, True)

    def record(batch_size, augment=False, epochs=1):
        seen.update(augment=augment, epochs=epochs)
        return iter(())

    monkeypatch.setattr(ds, "train_eval_batches", record)
    monkeypatch.setattr(E.common, "extract_by_tap", lambda *a, **k: np.zeros((0, 2)))
    E.train_features(ds, None, torch.device("cpu"), augmentation_epochs=2)
    assert seen == {"augment": True, "epochs": 2}
    E.train_features(ds, None, torch.device("cpu"), augmentation_epochs=1)
    assert seen == {"augment": False, "epochs": 1}


# -- prefetch ------------------------------------------------------------------

def test_prefetch_stops_when_the_consumer_leaves_early():
    produced = []
    finished = threading.Event()

    def items():
        try:
            for i in range(1000):
                produced.append(i)
                yield i
        finally:
            finished.set()

    gen = tfiles.prefetch(items(), size=2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()  # the consumer leaves with the queue full
    assert finished.wait(5.0), "the worker did not stop"
    assert len(produced) < 10


def test_prefetch_reraises_the_worker_error_and_keeps_the_sentinel():
    def failing():
        yield 1
        raise OSError("disk went away")

    gen = tfiles.prefetch(failing(), size=1)
    assert next(gen) == 1
    with pytest.raises(OSError, match="disk went away"):
        next(gen)
    # a full queue at the end: the end sentinel waits for room, never dropped
    slow = tfiles.prefetch(iter(range(5)), size=1)
    time.sleep(0.3)
    assert list(slow) == [0, 1, 2, 3, 4]


# -- the slice as a whole ------------------------------------------------------

def test_one_train_step_matches_jax(cub_dir):
    """One step of the trainer's fused cosine-loss step (onehot targets,
    resnet-32 on 32 px crops), from the JAX package's initial weights, on
    the same file batch with the same flips (erasing off).  Tolerance: f32
    sums in another order over resnet-32's 33 layers, backward and one
    update: loss within 1e-5 relative, parameters within 1e-4."""
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.ops import fused_cosine_loss
    from semantic_embeddings_torch.train import make_train_step, new_train_state
    from semantic_embeddings_tpu.cli import common as jcommon
    from semantic_embeddings_tpu.ops import fused_cosine_loss as jfused
    from semantic_embeddings_tpu.train import make_train_step as jmake_train_step

    kw = dict(cropsize=(32, 32), default_target_size=36, randerase_prob=0.0,
              mean=CUB_STATS[0], std=CUB_STATS[1])
    ds, jds = NABDataset(cub_dir, **kw), JNABDataset(cub_dir, **kw)
    raw = next(iter(ds.train_batches(8, epoch=0, seed=0)))
    jraw = {"image": jnp.asarray(raw["image"].numpy()), "label": jnp.asarray(raw["label"])}
    emb = np.zeros((4, 64), np.float32)  # resnet-32 embeds into 64 dims
    emb[np.arange(4), np.arange(4)] = 1.0

    jmodel, jspec = jcommon.build_embedding_model(64, "resnet-32", "unnorm_corr", 0)
    jstate = jcommon.init_model_state(jmodel, 32, 3, seed=0)
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    jstep = jmake_train_step(jmodel, jds.make_prepare(), loss_name="inv_corr",
                             class_embedding=emb, num_classes=4,
                             l2_penalty_fn=jspec.l2_penalty,
                             loss_fn_override=lambda tgt, z: jfused(z, tgt))
    key = jax.random.PRNGKey(3)
    jstate, jm = jstep(jstate, jraw, 0.05, key)

    model, spec = common.build_embedding_model(64, "resnet-32", "inv_corr", 0)
    convert.load_flax_variables(model, variables)
    state = new_train_state(model)
    _, k_flip, _ = jax.random.split(key, 3)
    flips = torch.from_numpy(np.array(
        jax.random.bernoulli(jax.random.split(k_flip)[0], 0.5, (8,))))
    ds.draw_augment = lambda *args: {"color": None, "flip": flips, "erase": None}
    step = make_train_step(model.twin("linear"), ds.make_prepare("cpu"),
                           loss_name="inv_corr", class_embedding=emb, num_classes=4,
                           l2_penalty_fn=spec.l2_penalty,
                           loss_fn_override=lambda tgt, z: fused_cosine_loss(z, tgt))
    state, m = step(state, raw, 0.05, None)
    for k in ("loss", "emb_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    got = convert.state_dict_to_flax(model)
    for coll, want in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = got[coll]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{coll}/{path}")


def test_cli_end_to_end_on_cub_layout(cub_dir, tmp_path, monkeypatch, capsys):
    """``learn_image_embeddings --dataset cub`` on the CPU through the file
    pipeline, its crop cut from CUB's 448 px to 32 px for the CPU; the
    pipeline flags reach the dataset."""
    from semantic_embeddings_tpu.embeddings import load_features, save_embeddings
    from semantic_embeddings_torch.cli import learn_image_embeddings

    made = []

    def small_cub(name, root, classes=None):
        ds = get_data_generator(name, root, classes=classes)
        ds.cropsize, ds.default_target_size = (32, 32), 36
        made.append(ds)
        return ds

    monkeypatch.setattr(learn_image_embeddings, "get_data_generator", small_cub)
    emb = np.eye(4, 64)
    emb_path = str(tmp_path / "emb.pickle")
    save_embeddings(emb_path, [1, 2, 3, 4], emb)
    feat = str(tmp_path / "feat.pickle")
    state = learn_image_embeddings.main([
        "--dataset", "cub", "--data_root", cub_dir, "--embedding", emb_path,
        "--architecture", "resnet-32", "--loss", "inv_corr", "--fused_loss",
        "--lr_schedule", "SGDR", "--sgdr_base_len", "12", "--sgdr_mul", "2",
        "--sgdr_max_lr", "0.05", "--batch_size", "6", "--epochs", "1",
        "--read_workers", "3", "--queue_size", "2", "--feature_dump", feat,
        "--device", "cpu"])
    out = capsys.readouterr().out
    (ds,) = made
    assert (ds.read_workers, ds.queue_size, ds.use_native) == (3, 2, True)
    assert "3 read workers, a queue of 2 batches, native decoder" in out
    assert ds.pillow_retries > 0  # the PNG under a .jpg name
    assert state.step == 2 and "epoch 1/1" in out
    ids, feats = load_features(feat)
    assert feats.shape == (4, 64) and np.isfinite(feats).all()
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)


def test_pillow_decoder_flag(cub_dir, tmp_path):
    from semantic_embeddings_torch.cli import common, learn_image_embeddings

    args = learn_image_embeddings.build_parser().parse_args(
        ["--dataset", "cub", "--data_root", cub_dir, "--embedding", "onehot",
         "--decoder", "pillow"])
    ds = common.apply_pipeline_args(get_data_generator("cub", cub_dir), args)
    assert ds.use_native is False and ds.read_workers == 8 and ds.queue_size == 100
    mem = common.apply_pipeline_args(get_data_generator("synthetic-4-8-4"), args)
    assert not hasattr(mem, "read_workers")


def test_grayscale_and_png_files_in_a_batch(tmp_path):
    rng = np.random.default_rng(2)
    write_nab(str(tmp_path), n_classes=2, per_class=2, test_every=2)
    jpeg(str(tmp_path / "images" / "001.class_1" / "0.jpg"), rng, (20, 30), gray=True)
    ds, ref = _pair(str(tmp_path), True)
    assert _same_batches(ds.train_batches(2, 0), ref.train_batches(2, 0)) == 1
