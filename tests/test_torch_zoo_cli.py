"""The trainer CLI on the CPU with the new families and flags: ``simple``
with ``--cls_base top`` (then its dump through
``evaluate_classification_accuracy``), ``resnet-32`` with ``--remat``
(equal to a run without), and checkpoints of any family rebuilt with their
input channels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.cli import common as jcommon
from semantic_embeddings_tpu.embeddings import load_features, save_embeddings
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.cli import common, evaluate_classification_accuracy
from semantic_embeddings_torch.cli import learn_image_embeddings
from semantic_embeddings_torch.train import new_train_state
from semantic_embeddings_torch.train.state import save_checkpoint


def _embedding(tmp_path, dim):
    e = np.random.default_rng(0).normal(size=(10, dim))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    path = str(tmp_path / f"emb{dim}.pickle")
    save_embeddings(path, list(range(10)), e)
    return path


def _train(tmp_path, arch, dim, *extra):
    return ["--dataset", "synthetic-10-64-32", "--data_root", str(tmp_path),
            "--embedding", _embedding(tmp_path, dim), "--architecture", arch,
            "--batch_size", "16", "--epochs", "1", "--device", "cpu", "--no_progress",
            *extra]


def test_simple_with_cls_base_then_classification_accuracy(tmp_path):
    """``simple`` (the trainer's default architecture) with the head on its
    ``top``: the dump records ``cls_base`` and rebuilds with it, reproduces
    the dumped features, and evaluates through the classification CLI on
    the head's ``prob`` to the JAX model's accuracy on the same weights."""
    feat, dump = str(tmp_path / "feat.pickle"), str(tmp_path / "model.pt")
    state = learn_image_embeddings.main(_train(
        tmp_path, "simple", 16, "--loss", "inv_corr", "--cls_weight", "0.1",
        "--cls_base", "top", "--fused_loss", "--feature_dump", feat,
        "--model_dump", dump))
    assert state.step == 4 and state.model.cls_base == "top"
    model, meta = common.rebuild_model_from_checkpoint(dump, torch.device("cpu"))
    assert meta["cls_base"] == "top"
    assert model.cls_base == "top" and model.cls_top.in_features == 16
    ids, feats = load_features(feat)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
    from semantic_embeddings_torch.data import get_data_generator

    dataset = get_data_generator("synthetic-10-64-32", str(tmp_path))
    again = common.extract_test_features(model, dataset, torch.device("cpu"), 16, pick=0)
    np.testing.assert_allclose(again, feats, rtol=0, atol=1e-5)
    perf = evaluate_classification_accuracy.main([
        "--dataset", "synthetic-10-64-32", "--data_root", str(tmp_path),
        "--model", dump, "--layer", "prob", "--prob_features", "1",
        "--batch_size", "16", "--device", "cpu"])
    (row,) = perf.values()
    # The same classification worked out apart from the port: the JAX
    # package's model with cls_base="top", on the dump's weights carried
    # over by convert.py, ranks the classes of the test images by its head's
    # prob.  After four steps that ranking hardly depends on the image (the
    # eval-mode statistics have barely moved), so the accuracy alone would
    # show little: the CLI's whole ranking must equal JAX's as well.
    jmodel, _ = jcommon.build_embedding_model(16, "simple", "inv_corr", 10, cls_base="top")
    images, _ = dataset.make_prepare("cpu")({"idx": np.arange(dataset.num_test)}, None, False)
    _, jprob = jmodel.apply(convert.state_dict_to_flax(model), jnp.asarray(images.numpy()),
                            train=False)
    jprob = np.asarray(jprob)
    ranked = np.argsort(-jprob, axis=1, kind="stable")
    gaps = -np.diff(np.take_along_axis(jprob, ranked, axis=1), axis=1)
    assert gaps.min() > 1e-4  # no near tie for rounding to flip
    got = evaluate_classification_accuracy.extract_predictions(
        dataset, model, torch.device("cpu"), "prob", 16)
    np.testing.assert_array_equal(got, ranked)
    truth = np.asarray(dataset.labels_test)[:, None]
    want = {"Accuracy": np.mean(ranked[:, :1] == truth),
            "Top-5 Accuracy": np.mean(np.any(ranked[:, :5] == truth, axis=1))}
    assert {k: row[k] for k in want} == want, (row, want)


def test_resnet32_remat_run_equals_plain_run(tmp_path):
    """One epoch of resnet-32 with ``--remat`` ends in the same weights and
    running statistics as one without, bitwise on the CPU."""
    states = {}
    for name, extra in (("plain", []), ("remat", ["--remat"])):
        states[name] = learn_image_embeddings.main(_train(
            tmp_path, "resnet-32", 64, "--loss", "inv_corr", "--cls_weight", "0.1",
            "--fused_loss", *extra))
    assert states["remat"].model.backbone.remat and not states["plain"].model.backbone.remat
    plain, remat = (states[k].model.state_dict() for k in ("plain", "remat"))
    assert sorted(plain) == sorted(remat)
    for key in plain:
        assert torch.equal(plain[key], remat[key]), key


@pytest.mark.parametrize("arch,channels", [("densenet-100-12", 1), ("simple", 3)])
def test_rebuild_reads_input_channels_of_any_family(tmp_path, arch, channels):
    """The channels come from the backbone's first conv, whatever its
    family names it (DenseNet's ``conv_init``, PlainNet's ``conv1``), and
    the rebuilt model computes what the dumped one did."""
    model, _ = common.build_embedding_model(16, arch, "inv_corr", 0, input_channels=channels)
    path = str(tmp_path / "m.pt")
    save_checkpoint(path, new_train_state(model), {"architecture": arch, "embed_dim": 16,
                                                   "loss": "inv_corr"})
    rebuilt, _ = common.rebuild_model_from_checkpoint(path, torch.device("cpu"))
    x = torch.randn(2, 32, 32, channels, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(rebuilt(x), model.eval()(x), rtol=0, atol=0)
