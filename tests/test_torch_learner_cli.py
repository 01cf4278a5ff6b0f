"""The baseline learners' CLIs and ``--finetune`` end to end on the CPU at
a small size: ``learn_classifier`` (its dump rebuilt, evaluated, exported),
``learn_devise`` (both phases), ``learn_labelembedding``,
``learn_center_loss`` (learned and fixed centroids), and the two-phase
``--finetune`` of the trainer, whose warm-up leaves the backbone bitwise
as it loaded it.  The steps themselves are held against the JAX package
in tests/test_torch_learners.py."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import numpy as np
import pytest
import torch

from semantic_embeddings_torch.cli import (
    common,
    evaluate_classification_accuracy,
    export_model,
    learn_center_loss,
    learn_classifier,
    learn_devise,
    learn_image_embeddings,
    learn_labelembedding,
)
from semantic_embeddings_torch.data import get_data_generator
from semantic_embeddings_torch.embeddings import load_features, save_embeddings
from semantic_embeddings_torch.train import (
    load_weights_by_name,
    make_train_step,
    make_eval_step,
    new_train_state,
)
from semantic_embeddings_torch.train.state import save_checkpoint

CPU = torch.device("cpu")
DATA = "synthetic-10-64-32"


def _embedding(tmp_path, dim=16):
    e = np.random.default_rng(0).normal(size=(10, dim))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    path = str(tmp_path / f"emb{dim}.pickle")
    save_embeddings(path, list(range(10)), e)
    return path, e.astype(np.float32)


def _argv(tmp_path, *extra):
    return ["--dataset", DATA, "--data_root", str(tmp_path), "--batch_size", "16",
            "--device", "cpu", "--no_progress", "--architecture", "simple", *extra]


def _rebuilt_features(path, tmp_path, pick=0):
    model, meta = common.rebuild_model_from_checkpoint(path, CPU)
    dataset = get_data_generator(DATA, str(tmp_path))
    return common.extract_test_features(model, dataset, CPU, 16, pick=pick), model, meta


@pytest.fixture(scope="module")
def classifier_dump(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("classifier")
    dump, feat = str(tmp / "cls.pt"), str(tmp / "cls_feat.pickle")
    state = learn_classifier.main(_argv(
        tmp, "--epochs", "1", "--label_smoothing", "0.1", "--lr_schedule", "SGDR",
        "--model_dump", dump, "--feature_dump", feat))
    return tmp, dump, feat, state


def test_learn_classifier_dump_rebuilds_evaluates_and_exports(classifier_dump, tmp_path):
    tmp, dump, feat, state = classifier_dump
    assert state.step == 4
    payload = torch.load(dump, weights_only=True)
    assert payload["metadata"] == {"architecture": "simple", "cls_classes": 10}
    assert not any(k.startswith("backbone.") for k in payload["model"])
    model, _ = common.rebuild_model_from_checkpoint(dump, CPU)
    assert type(model).__name__ == "PlainNet" and model.top.out_features == 10
    # the feature dump holds the avg_pool tap of the test images
    _, feats = load_features(feat)
    dataset = get_data_generator(DATA, str(tmp))
    again = common.extract_by_tap(model, dataset.make_prepare(CPU),
                                  dataset.test_batches(16), CPU, layer="avg_pool")
    assert feats.shape == (32, again.shape[1])
    np.testing.assert_allclose(again, feats, rtol=0, atol=1e-5)
    perf = evaluate_classification_accuracy.main([
        "--dataset", DATA, "--data_root", str(tmp), "--model", dump, "--layer", "prob",
        "--prob_features", "1", "--batch_size", "16", "--device", "cpu"])
    probs = common.extract_by_tap(model, dataset.make_prepare(CPU),
                                  dataset.test_batches(16), CPU, layer="prob")
    acc = float(np.mean(probs.argmax(1) == np.asarray(dataset.labels_test)))
    assert abs(perf["cls"]["Accuracy"] - acc) < 1e-9
    out = str(tmp_path / "cls.pt2")
    export_model.main(["--checkpoint", dump, "--out", out, "--input_size", "32",
                       "--layer", "prob", "--device", "cpu", "--validate"])


def test_learn_classifier_bf16_and_finetune(classifier_dump, capsys):
    tmp, dump, _, _ = classifier_dump
    state = learn_classifier.main(_argv(
        tmp, "--epochs", "1", "--finetune", dump, "--finetune_init", "1", "--bf16"))
    out = capsys.readouterr().out
    assert "Loaded 62 of 62 tensors by name" in out and "Full model training" in out
    assert state.step == 4 and state.epoch == 1


def _finetune_args(parser, *argv):
    return parser.parse_args(["--dataset", DATA, "--data_root", "x", *argv])


def test_finetune_warmup_leaves_the_backbone_bitwise(classifier_dump, tmp_path):
    """Phase 1 of the trainer's --finetune from a classifier's dump: the
    classifier's layers load into the backbone (its softmax top does not),
    the warm-up trains the two tops only, every other tensor but the BN
    running statistics stays bitwise as loaded, and the optimizer starts
    afresh for phase 2."""
    tmp, dump, _, _ = classifier_dump
    emb_path, emb = _embedding(tmp_path)
    args = _finetune_args(learn_image_embeddings.build_parser(), "--embedding", emb_path,
                          "--finetune", dump, "--finetune_init", "1", "--batch_size",
                          "16", "--no_progress", "--cls_weight", "0.1")
    dataset = get_data_generator(DATA, str(tmp))
    model, spec = common.build_embedding_model(16, "simple", "inv_corr", 10)
    state = new_train_state(model)
    loaded, skipped = load_weights_by_name(dump, model)
    assert "backbone.conv1.weight" in loaded and "backbone.top.weight" not in loaded
    assert {"top.weight", "top.bias", "backbone.top.weight"} <= set(skipped)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    prepare = dataset.make_prepare(CPU)
    kw = dict(loss_name="inv_corr", class_embedding=emb, num_classes=10, cls_weight=0.1,
              l2_penalty_fn=spec.l2_penalty)
    state = common.finetune(args, state, lambda: make_train_step(
        model, prepare, trainable_fn=lambda p: "top" in p, **kw),
        make_eval_step(model, prepare, **kw), dataset)
    assert state.step == 0 and state.epoch == 0
    assert all(not v.any() for v in state.velocity)
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert {"backbone.top.weight", "cls_top.weight"} <= moved
    assert all("top" in k or "running" in k for k in moved), moved


def test_learn_image_embeddings_finetune_runs_both_phases(classifier_dump, tmp_path,
                                                          capsys):
    tmp, dump, _, _ = classifier_dump
    emb_path, _ = _embedding(tmp_path)
    state = learn_image_embeddings.main(_argv(
        tmp, "--embedding", emb_path, "--epochs", "1", "--fused_loss", "--cls_weight",
        "0.1", "--finetune", dump, "--finetune_init", "1"))
    out = capsys.readouterr().out
    assert "Pre-training new layers" in out and "Full model training" in out
    assert state.step == 4 and state.epoch == 1


def test_load_weights_by_name_maps_between_model_kinds(tmp_path):
    """An embedding model's dump loads into a bare network's layers and
    back; the tops (softmax against embedding) never cross, and a shape
    that differs is skipped."""
    model, _ = common.build_embedding_model(16, "simple", "inv_corr", 10)
    save_checkpoint(str(tmp_path / "emb.pt"), new_train_state(model), {})
    from semantic_embeddings_torch.models import build_network

    bare = build_network(10, "simple", classification=True,
                         generator=torch.Generator().manual_seed(1)).module
    loaded, skipped = load_weights_by_name(str(tmp_path / "emb.pt"), bare)
    assert "conv1.weight" in loaded and "top.weight" not in loaded
    assert "backbone.top.weight" in skipped and "cls_top.weight" in skipped
    assert torch.equal(bare.conv1.weight, model.backbone.conv1.weight)
    wide, _ = common.build_embedding_model(32, "simple", "inv_corr", 0)
    loaded, skipped = load_weights_by_name(str(tmp_path / "emb.pt"), wide)
    assert "backbone.top.weight" in skipped and "backbone.conv1.weight" in loaded


def test_learn_devise_two_phases_and_dump(tmp_path, capsys):
    emb_path, emb = _embedding(tmp_path)
    init, dump = str(tmp_path / "init.pt"), str(tmp_path / "devise.pt")
    feat = str(tmp_path / "devise.pickle")
    learn_image_embeddings.main(_argv(tmp_path, "--embedding", emb_path, "--epochs", "1",
                                      "--model_dump", init))
    state = learn_devise.main(_argv(
        tmp_path, "--embedding", emb_path, "--init_weights", init, "--init_epochs", "1",
        "--ft_epochs", "1", "--model_dump", dump, "--feature_dump", feat))
    out = capsys.readouterr().out
    assert "Pre-training linear transformation" in out and "Fine-tuning all layers" in out
    assert state.step == 4 and state.epoch == 1  # phase 2 from a fresh Adagrad
    assert all(torch.isfinite(p).all() for p in state.params)
    _, feats = load_features(feat)
    again, _, meta = _rebuilt_features(dump, tmp_path)
    assert meta["loss"] == "mse" and feats.shape == (32, 16)
    np.testing.assert_allclose(again, feats, rtol=0, atol=1e-5)


def test_learn_labelembedding_and_its_dump(tmp_path):
    dump, feat = str(tmp_path / "le.pt"), str(tmp_path / "le.pickle")
    state = learn_labelembedding.main(_argv(
        tmp_path, "--embed_dim", "16", "--epochs", "1", "--model_dump", dump,
        "--feature_dump", feat))
    assert state.step == 4 and not torch.equal(state.model.labelembeddings,
                                               torch.eye(10))
    _, feats = load_features(feat)
    again, model, meta = _rebuilt_features(dump, tmp_path)
    assert meta["learner"] == "labelembed" and type(model).__name__ == "LabelEmbedModel"
    assert feats.shape == (32, 16)
    np.testing.assert_allclose(again, feats, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fixed", [False, True])
def test_learn_center_loss_and_its_dump(tmp_path, fixed):
    emb_path, emb = _embedding(tmp_path)
    dump, feat = str(tmp_path / "cl.pt"), str(tmp_path / "cl.pickle")
    extra = ["--centroids", emb_path] if fixed else ["--embed_dim", "16"]
    state = learn_center_loss.main(_argv(
        tmp_path, "--epochs", "1", "--model_dump", dump, "--feature_dump", feat, *extra))
    assert state.step == 4
    cents = state.model.cls_centroids.detach().numpy()
    if fixed:
        np.testing.assert_array_equal(cents, emb)
    else:  # trained away from the CLI's initial draw
        from semantic_embeddings_torch.models import CenterLossModel, build_network

        generator = torch.Generator().manual_seed(0)
        spec = build_network(16, "simple", generator=generator)
        init = CenterLossModel(spec.module, 10, 16, generator=generator).cls_centroids
        assert not np.array_equal(cents, init.detach().numpy())
    _, feats = load_features(feat)
    again, model, meta = _rebuilt_features(dump, tmp_path)
    assert meta["learner"] == "center_loss" and meta["fixed_centroids"] is fixed
    np.testing.assert_allclose(model.cls_centroids.detach().numpy(), cents)
    np.testing.assert_allclose(again, feats, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cli", [learn_classifier, learn_labelembedding, learn_center_loss])
def test_learner_clis_refuse_the_multi_device_flags(tmp_path, cli, capfd):
    """``--gpus 2 --spatial 2`` does what the JAX package's CLIs do with it:
    ``learn_classifier`` trains on a (1, 2) grid (two gloo ranks, each a
    block of every image's rows); ``learn_labelembedding`` and
    ``learn_center_loss`` parse --spatial and run exactly as ``--gpus 2``
    (their JAX ``resolve_mesh`` calls leave it out): the model dumps are
    bitwise equal."""
    extra = ["--embed_dim", "16"] if cli is not learn_classifier else []
    small = ["--dataset", "synthetic-10-8-4-16", "--batch_size", "4", "--epochs", "1",
             "--lr_schedule", "SGD", "--sgd_lr", "0.05", *extra]

    def run(name, *flags):
        dump = str(tmp_path / f"{name}.pt")
        assert cli.main(_argv(tmp_path, *small, "--model_dump", dump, *flags)) is None
        return common.load_checkpoint_raw(dump)[0]

    spatial = run("spatial", "--gpus", "2", "--spatial", "2")
    out = capfd.readouterr().out
    assert "spawning 2 data-parallel processes" in out
    if cli is learn_classifier:
        assert "a (1, 2) (data, spatial) grid" in out
        assert all(torch.isfinite(v).all() for v in spatial.values())
        return
    assert "(data, spatial) grid" not in out
    data = run("data", "--gpus", "2")
    assert sorted(spatial) == sorted(data)
    for k in data:
        assert torch.equal(spatial[k], data[k]), k


def test_synthetic_dataset_name_takes_an_image_size():
    ds = get_data_generator("synthetic-5-8-4-48")
    assert (ds.num_classes, ds.num_train, ds.num_test) == (5, 8, 4)
    assert ds.device_arrays(CPU)[0].shape[1:3] == (48, 48)


def test_read_class_list(tmp_path):
    path = tmp_path / "classes.txt"
    path.write_text("3 cat\n1 dog\n3 again\n\n")
    assert common.read_class_list(str(path)) == [3, 1]
    path.write_text("n01 cat\nn02 dog\n")
    assert common.read_class_list(str(path)) == ["n01", "n02"]
