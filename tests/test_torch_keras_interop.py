"""Keras ``.h5`` interop in the port against the JAX package: the copied
layer-order table equals the JAX table; on the same Keras-layout files
(written from a seed) the port's importer maps every weight as the JAX
importer does, bit for bit, for each of the 15 exportable architectures;
the two ``import_keras_weights`` CLIs give the same weights; export ->
import is bitwise, and the two exporters write the same h5.  Full-size
architectures are built on the meta device (shapes only)."""

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from semantic_embeddings_torch import convert
from semantic_embeddings_torch.cli import common
from semantic_embeddings_torch.cli import export_keras_weights as texport
from semantic_embeddings_torch.cli import import_keras_weights as timport
from semantic_embeddings_torch.cli._keras_layer_orders import LAYER_ORDERS
from semantic_embeddings_torch.models import EmbeddingModel, build_network
from semantic_embeddings_torch.train.state import new_train_state, save_checkpoint
from semantic_embeddings_tpu.cli import export_keras_weights as jexport
from semantic_embeddings_tpu.cli import import_keras_weights as jimport
from semantic_embeddings_tpu.cli._keras_layer_orders import LAYER_ORDERS as JLAYER_ORDERS


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _meta_model(arch, embed_dim, cls_classes):
    """The port's embedding model of ``arch`` on the meta device."""
    with torch.device("meta"):
        spec = build_network(embed_dim, arch)
        return EmbeddingModel(spec.module, output="l2norm", cls_classes=cls_classes)


def _sentinel_variables(model):
    """A Flax tree of ``model``'s leaf shapes, each leaf one constant of its
    own (zero-stride arrays: nothing is allocated)."""
    variables = {"params": {}, "batch_stats": {}}
    state = model.state_dict()
    for i, (key, (collection, path, kind)) in enumerate(convert.leaf_map(model).items()):
        node = variables[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.broadcast_to(np.float32(i + 1),
                                         convert.flax_shape(state[key].shape, kind))
    return variables


def test_layer_orders_equal_the_jax_table():
    assert LAYER_ORDERS == JLAYER_ORDERS
    assert len(LAYER_ORDERS) == 15
    assert len(LAYER_ORDERS["simple"]) == 21 and len(LAYER_ORDERS["pyramidnet-272-200"]) == 634


@pytest.mark.parametrize("arch", sorted(LAYER_ORDERS))
def test_importer_maps_every_family_as_jax(arch):
    """The port's exporter writes the model's weights (each a constant of
    its own) in Keras layout; the port's ``map_layers`` gives the JAX
    ``map_layers``'s tree bit for bit, every leaf of the port's model is
    covered with its shape, and the round trip gives the weights back."""
    cls_classes = 10 if arch in ("simple", "resnet-32", "wrn-28-10", "densenet-100-12") else 0
    model = _meta_model(arch, 32, cls_classes)
    variables = _sentinel_variables(model)
    layers = {name: arrays for name, _, arrays in
              texport.export_layers(variables, arch, cls_classes)}
    got = timport.map_layers(layers, arch, has_cls_head=cls_classes > 0)
    want = jimport.map_layers(layers, arch, has_cls_head=cls_classes > 0)
    assert got[2] == want[2] == []
    _assert_trees_equal(got[0], want[0])
    _assert_trees_equal(got[1], want[1])
    # every entry of the model, with its shape (raises otherwise)
    convert.flax_to_state_dict({"params": got[0], "batch_stats": got[1]}, model)
    _assert_trees_equal({"params": got[0], "batch_stats": got[1]}, variables)


def _random_model(arch, embed_dim, cls_classes, seed):
    """The port's model with its BN statistics drawn from the seed too."""
    model, _ = common.build_embedding_model(embed_dim, arch, "inv_corr", cls_classes,
                                            seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(size=buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2, buf.shape).astype(np.float32)))
    return model


def _write_h5(path, layers):
    """A Keras ``save_weights`` file of ``{layer: [arrays]}``."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in layers], dtype="S")
        for lname, weights in layers.items():
            g = f.create_group(lname)
            names = [f"{lname}/w_{i}:0" for i in range(len(weights))]
            for wn, w in zip(names, weights):
                g.create_dataset(wn, data=w)
            g.attrs["weight_names"] = np.array([w.encode() for w in names], dtype="S")


@pytest.mark.parametrize("arch,embed_dim,cls_classes", [
    ("simple", 16, 10), ("resnet-32", 64, 4)])
def test_import_cli_matches_the_jax_cli(arch, embed_dim, cls_classes, tmp_path, capsys):
    """Both ``import_keras_weights`` CLIs on one h5 file of random weights,
    conv biases that fold into the BN means among them: the port's
    checkpoint holds the JAX checkpoint's weights, bit for bit, and
    rebuilds from its metadata."""
    from semantic_embeddings_tpu.train.state import load_checkpoint_raw as jload

    source = _random_model(arch, embed_dim, cls_classes, seed=1)
    layers = {name: arrays for name, _, arrays in texport.export_layers(
        convert.state_dict_to_flax(source), arch, cls_classes)}
    rng = np.random.default_rng(2)
    if jimport._fold_architecture(arch):  # nonzero conv biases to fold
        for name, kind in LAYER_ORDERS[arch]:
            if kind == "C":
                layers[name][1] = rng.normal(size=layers[name][1].shape).astype(np.float32)
    h5 = str(tmp_path / "ref.h5")
    _write_h5(h5, layers)
    flags = ["--h5", h5, "--architecture", arch, "--embed_dim", str(embed_dim),
             "--cls_classes", str(cls_classes)]
    jimport.main(flags + ["--out", str(tmp_path / "j.ckpt")])
    timport.main(flags + ["--out", str(tmp_path / "t.pt"), "--device", "cpu"])
    assert "Imported " in capsys.readouterr().out
    model, meta = common.rebuild_model_from_checkpoint(str(tmp_path / "t.pt"), "cpu")
    assert meta["imported_from"] == h5 and meta["architecture"] == arch
    variables, _ = jload(str(tmp_path / "j.ckpt"))
    want = convert.flax_to_state_dict(variables, model)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("arch,cls_classes", [("simple", 0), ("simple", 10), ("resnet-32", 0)])
def test_export_then_import_is_bitwise(arch, cls_classes, tmp_path):
    """A port checkpoint through the port's ``export_keras_weights`` CLI and
    back through its ``import_keras_weights`` CLI: every parameter and
    statistic bit for bit (zero conv biases fold to nothing); and the JAX
    exporter writes the same h5 from the JAX checkpoint of the weights."""
    from semantic_embeddings_tpu.train.state import new_train_state as jnew_state
    from semantic_embeddings_tpu.train.state import save_checkpoint as jsave

    embed_dim = 16
    source = _random_model(arch, embed_dim, cls_classes, seed=3)
    meta = {"architecture": arch, "embed_dim": embed_dim, "loss": "inv_corr",
            "cls_classes": cls_classes}
    save_checkpoint(str(tmp_path / "m.pt"), new_train_state(source), meta)
    texport.main(["--model", str(tmp_path / "m.pt"), "--out", str(tmp_path / "t.h5")])
    timport.main(["--h5", str(tmp_path / "t.h5"), "--architecture", arch, "--embed_dim",
                  str(embed_dim), "--cls_classes", str(cls_classes), "--out",
                  str(tmp_path / "back.pt"), "--device", "cpu"])
    back, _ = common.rebuild_model_from_checkpoint(str(tmp_path / "back.pt"), "cpu")
    for key, value in source.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    jsave(str(tmp_path / "j.ckpt"), jnew_state(convert.state_dict_to_flax(source)), meta)
    jexport.main(["--model", str(tmp_path / "j.ckpt"), "--out", str(tmp_path / "j.h5")])
    # the port's exporter takes the JAX checkpoint too
    texport.main(["--model", str(tmp_path / "j.ckpt"), "--out", str(tmp_path / "tj.h5")])
    want = jimport.read_keras_h5(str(tmp_path / "j.h5"))
    for path in ("t.h5", "tj.h5"):
        got = timport.read_keras_h5(str(tmp_path / path))
        assert list(got) == list(want)
        for name in want:
            assert len(got[name]) == len(want[name])
            for a, b in zip(got[name], want[name]):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    with h5py.File(str(tmp_path / "t.h5"), "r") as f, h5py.File(str(tmp_path / "j.h5"), "r") as g:
        assert list(f.attrs["layer_names"]) == list(g.attrs["layer_names"])
        assert f.attrs["keras_version"] == g.attrs["keras_version"]


def test_model_weights_group_layout(tmp_path):
    """Full-model saves nest the layers under 'model_weights'."""
    rng = np.random.default_rng(4)
    inner = {"conv0": [rng.normal(size=(3, 3, 3, 16)).astype(np.float32)],
             "bn0": [np.ones(16, np.float32)] * 4}
    path = str(tmp_path / "full.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = np.array([b"conv0", b"bn0"], dtype="S")
        for lname, weights in inner.items():
            lg = g.create_group(lname)
            names = [f"{lname}/w_{i}:0" for i in range(len(weights))]
            for wn, w in zip(names, weights):
                lg.create_dataset(wn, data=w)
            lg.attrs["weight_names"] = np.array([w.encode() for w in names], dtype="S")
    got, want = timport.read_keras_h5(path), jimport.read_keras_h5(path)
    assert list(got) == list(want) == ["conv0", "bn0"]
    np.testing.assert_array_equal(got["conv0"][0], inner["conv0"][0])


def test_refusals(tmp_path):
    """rn* families are refused as the JAX importer refuses them; a weight
    of another shape, and an architecture with no layer table, raise."""
    with pytest.raises(ValueError, match="NOT COVERED"):
        timport.map_layers({}, "rn50")
    with pytest.raises(ValueError, match="does not support"):
        texport.layer_template("rn50")
    with pytest.raises(ValueError, match="expected .* unnamed convs"):
        timport.map_layers({"conv2d_1": [np.zeros((3, 3, 3, 16), np.float32)]}, "wrn-28-10")
    h5 = str(tmp_path / "bad.h5")
    _write_h5(h5, {"conv0": [np.zeros((3, 3, 3, 99), np.float32)]})
    with pytest.raises(ValueError, match="Shape mismatch"):
        timport.main(["--h5", h5, "--architecture", "resnet-32", "--embed_dim", "64",
                      "--out", str(tmp_path / "x.pt"), "--device", "cpu"])
