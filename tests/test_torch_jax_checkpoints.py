"""The JAX package's checkpoints in the port: its model dumps and weight
dumps, written by ``semantic_embeddings_tpu.train.state``, are told apart
import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

from the port's files by their first bytes, rebuild into port models whose
forward matches the JAX forward, load by name exactly as the JAX package's
``load_weights_by_name`` loads them, and start ``--finetune``,
``--init_weights`` and the evaluation CLI; the port's JAX-format writers
give the JAX package's bytes; resuming from a JAX snapshot is refused."""

import pickle

import jax
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.cli import common as jcommon
from semantic_embeddings_tpu.train import state as jstate
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.cli import common
from semantic_embeddings_torch.embeddings import save_embeddings
from semantic_embeddings_torch.train import state as tstate

CPU = torch.device("cpu")
DATA = "synthetic-10-64-32"


def _randomize_bn(tree, seed):
    """BN statistics and affine parameters drawn from the seed, so that no
    comparison passes on initial constants."""
    rng = np.random.default_rng(seed)
    draw = {"var": lambda s: rng.uniform(0.5, 2.0, s), "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(size=s) * 0.1}

    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        return (draw[name](a.shape) if name in draw else a).astype(np.float32)

    return walk(tree)


def _jax_variables(arch, embed_dim, cls_classes, seed):
    """A JAX embedding model and its variables (BN randomized), from the seed."""
    jmodel, spec = jcommon.build_embedding_model(embed_dim, arch, "inv_corr", cls_classes)
    state = jcommon.init_model_state(jmodel, spec.input_size, 3, seed=seed)
    variables = _randomize_bn({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(state.batch_stats)}, seed)
    return jmodel, variables


def _meta(arch, embed_dim, cls_classes):
    return {"architecture": arch, "embed_dim": embed_dim, "loss": "inv_corr",
            "cls_classes": cls_classes, "cls_base": None}


@pytest.fixture(scope="module")
def simple_dumps(tmp_path_factory):
    """JAX files of a ``simple`` embedding model (16-d, 10-way head): a model
    dump with numpy scalars in its metadata, and a weight dump."""
    tmp = tmp_path_factory.mktemp("jax_dumps")
    jmodel, variables = _jax_variables("simple", 16, 10, seed=0)
    meta = _meta("simple", 16, np.int64(10))
    meta["epoch"] = np.int32(3)
    jstate.save_checkpoint(str(tmp / "model.ckpt"), jstate.new_train_state(variables), meta)
    jstate.save_weights(str(tmp / "weights.msgpack"), variables["params"])
    return tmp, jmodel, variables


def test_formats_are_told_apart_by_their_first_bytes(simple_dumps, tmp_path):
    tmp, _, variables = simple_dumps
    model, _ = common.build_embedding_model(16, "simple", "inv_corr", 10)
    tstate.save_checkpoint(str(tmp_path / "m.pt"), tstate.new_train_state(model))
    tstate.save_weights(str(tmp_path / "w.pt"), model)
    jstate.save_weights(str(tmp_path / "empty.msgpack"), {})
    wide = {f"layer{i}": {"kernel": np.zeros(2, np.float32)} for i in range(20)}
    jstate.save_weights(str(tmp_path / "wide.msgpack"), wide)
    (tmp_path / "other.bin").write_bytes(b"\x00\x01\x02\x03")
    assert (tmp_path / "empty.msgpack").read_bytes() == b"\x80"
    assert (tmp_path / "wide.msgpack").read_bytes()[0] == 0xDE
    want = {str(tmp_path / "m.pt"): "torch", str(tmp_path / "w.pt"): "torch",
            str(tmp / "model.ckpt"): "jax_checkpoint",
            str(tmp / "weights.msgpack"): "jax_weights",
            str(tmp_path / "empty.msgpack"): "jax_weights",
            str(tmp_path / "wide.msgpack"): "jax_weights"}
    for path, fmt in want.items():
        assert tstate.checkpoint_format(path) == fmt, path
    assert tstate.read_jax_weights(str(tmp_path / "empty.msgpack")) == {}
    with pytest.raises(ValueError, match="neither a checkpoint"):
        tstate.checkpoint_format(str(tmp_path / "other.bin"))


def test_metadata_unpickles_restricted(simple_dumps, tmp_path):
    """Numpy scalars of the metadata come back as Python scalars; any other
    global in the pickle is refused before it is built."""
    tmp, _, variables = simple_dumps
    state, meta = tstate.read_jax_checkpoint(str(tmp / "model.ckpt"))
    assert meta == {**_meta("simple", 16, 10), "epoch": 3}
    assert type(meta["cls_classes"]) is int and type(meta["epoch"]) is int
    np.testing.assert_array_equal(state["params"]["backbone"]["conv1"]["kernel"],
                                  variables["params"]["backbone"]["conv1"]["kernel"])
    evil = tmp_path / "evil.ckpt"
    with open(evil, "wb") as f:
        pickle.dump({"state": b"\x80", "metadata": {"x": pickle.Pickler}}, f)
    with pytest.raises(pickle.UnpicklingError, match="_pickle.Pickler is not allowed"):
        tstate.read_jax_checkpoint(str(evil))


@pytest.mark.parametrize("arch,embed_dim", [("simple", 16), ("resnet-32", 64)])
def test_jax_model_dump_rebuilds_to_the_jax_forward(arch, embed_dim, tmp_path):
    """A JAX model dump rebuilds from its own metadata into a port model
    whose eval forward (embedding and head) is the JAX forward's, 1e-5
    relative in f32; the port's writers then give the JAX package's bytes
    for the same weights."""
    jmodel, variables = _jax_variables(arch, embed_dim, 10, seed=1)
    meta = _meta(arch, embed_dim, 10)
    path = str(tmp_path / "model.ckpt")
    jstate.save_checkpoint(path, jstate.new_train_state(variables), meta)
    model, got_meta = common.rebuild_model_from_checkpoint(path, CPU)
    assert got_meta == meta
    x = np.random.default_rng(2).normal(size=(4, 32, 32, 3)).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, err
    again = str(tmp_path / "again.ckpt")
    tstate.save_jax_checkpoint(again, tstate.new_train_state(model), meta)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    jstate.save_weights(str(tmp_path / "w.msgpack"), variables["params"])
    tstate.save_jax_weights(str(tmp_path / "w2.msgpack"), model)
    assert (tmp_path / "w.msgpack").read_bytes() == (tmp_path / "w2.msgpack").read_bytes()


def test_sorted_jax_tree_rebuilds_with_its_stem_input_channels():
    """A JAX package tree comes back with sorted names (a jitted step sorts
    dict keys), and in DenseNet the first conv kernel of that order is a
    block's, not the stem's: the rebuild finds the stem through the model
    and builds the 1-channel model whose names and shapes the model-free
    translation gives."""
    arch, meta = "densenet-100-12", _meta("densenet-100-12", 16, 10)
    with torch.device("meta"):
        model, _ = common.build_embedding_model(16, arch, "inv_corr", 10, input_channels=1)
    leaves = sorted((c, path, convert.flax_shape(model.state_dict()[key].shape, kind))
                    for key, (c, path, kind) in convert.leaf_map(model).items())
    tree = {"params": {}, "batch_stats": {}}
    for collection, path, shape in leaves:
        node = tree[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(shape, np.float32)
    weights = convert.flax_tree_to_state_dict(tree)
    assert {k: v.shape for k, v in weights.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    assert next(v for v in weights.values() if v.ndim == 4).shape[1] != 1

    def build(channels):
        return common._build_from_metadata(weights, meta, arch, "sorted tree", channels)

    assert common._input_channels(weights, build) == 1


def test_velocity_and_counters_write_as_jax(tmp_path):
    """A state with velocity, step and epoch writes the JAX bytes of the
    same train state."""
    _, variables = _jax_variables("simple", 16, 0, seed=3)
    model, _ = common.build_embedding_model(16, "simple", "inv_corr", 0)
    convert.load_flax_variables(model, variables)
    state = tstate.new_train_state(model)
    rng = np.random.default_rng(4)
    for v in state.velocity:
        v.copy_(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
    state.step, state.epoch = 17, 2
    vel_model, _ = common.build_embedding_model(16, "simple", "inv_corr", 0)
    with torch.no_grad():
        for p, v in zip(vel_model.parameters(), state.velocity):
            p.copy_(v)
    velocity = convert.state_dict_to_flax(vel_model)["params"]
    jtrain = jstate.new_train_state(variables).replace(velocity=velocity, step=17, epoch=2)
    jstate.save_checkpoint(str(tmp_path / "j.ckpt"), jtrain, {"architecture": "simple"})
    tstate.save_jax_checkpoint(str(tmp_path / "t.ckpt"), state, {"architecture": "simple"})
    assert (tmp_path / "j.ckpt").read_bytes() == (tmp_path / "t.ckpt").read_bytes()


def test_resume_from_a_jax_snapshot_is_refused(simple_dumps):
    tmp, _, _ = simple_dumps
    model, _ = common.build_embedding_model(16, "simple", "inv_corr", 10)
    with pytest.raises(ValueError, match="JAX package model dump or snapshot.*--finetune"):
        tstate.load_checkpoint(str(tmp / "model.ckpt"), tstate.new_train_state(model))


@pytest.mark.parametrize("embed_dim,cls_classes", [(8, 0), (16, 10), (16, 0), (8, 10)])
def test_load_weights_by_name_replaces_the_leaves_jax_replaces(simple_dumps, embed_dim,
                                                               cls_classes):
    """From one JAX weight dump (16-d top, 10-way head) into models with a
    top of another width or the same, with and without the head: the port
    replaces exactly the leaves that the JAX package's ``load_weights_by_name``
    replaces, bit for bit, and the BN running statistics keep their values.
    The ``params`` of the JAX model dump load the same."""
    tmp, _, source = simple_dumps
    _, target = _jax_variables("simple", embed_dim, cls_classes, seed=5)
    want_params = jstate.load_weights_by_name(str(tmp / "weights.msgpack"), target["params"])
    model, _ = common.build_embedding_model(embed_dim, "simple", "inv_corr", cls_classes)
    convert.load_flax_variables(model, target)
    loaded, skipped = tstate.load_weights_by_name(str(tmp / "weights.msgpack"), model)
    want = convert.flax_to_state_dict(
        {"params": want_params, "batch_stats": target["batch_stats"]}, model)
    got = model.state_dict()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    before = convert.flax_to_state_dict(target, model)
    changed = {k for k in want if not torch.equal(want[k], before[k])}
    assert changed <= set(loaded) and not any("running" in k for k in loaded)
    assert ("backbone.top.weight" in loaded) == (embed_dim == 16)
    assert ("cls_top.weight" in loaded) == (cls_classes == 10 and embed_dim == 16)
    if cls_classes == 0:
        assert "cls_top/kernel" in skipped
    model2, _ = common.build_embedding_model(embed_dim, "simple", "inv_corr", cls_classes)
    convert.load_flax_variables(model2, target)
    tstate.load_weights_by_name(str(tmp / "model.ckpt"), model2)
    for key, value in model2.state_dict().items():
        assert torch.equal(value, got[key]), key


def _embedding(tmp_path, dim=16):
    e = np.random.default_rng(0).normal(size=(10, dim))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    path = str(tmp_path / f"emb{dim}.pickle")
    save_embeddings(path, list(range(10)), e)
    return path


def test_finetune_and_init_weights_from_jax_dumps(simple_dumps, tmp_path, capsys):
    """``learn_image_embeddings --finetune`` from a JAX weight dump and
    ``learn_devise --init_weights`` from a JAX model dump, end to end on the
    CPU: every backbone parameter loads, the running statistics do not."""
    from semantic_embeddings_torch.cli import learn_devise, learn_image_embeddings

    tmp, _, variables = simple_dumps
    flags = ["--dataset", DATA, "--data_root", str(tmp_path), "--batch_size", "16",
             "--device", "cpu", "--no_progress", "--architecture", "simple",
             "--embedding", _embedding(tmp_path)]
    state = learn_image_embeddings.main(flags + [
        "--epochs", "1", "--cls_weight", "0.1", "--finetune", str(tmp / "weights.msgpack"),
        "--finetune_init", "1"])
    out = capsys.readouterr().out
    n_params = sum(1 for _ in state.model.parameters())
    assert f"Loaded {n_params} of {len(state.model.state_dict())} tensors by name" in out
    assert "Pre-training new layers" in out and "Full model training" in out
    state = learn_devise.main(flags + ["--init_weights", str(tmp / "model.ckpt"),
                                       "--init_epochs", "1", "--ft_epochs", "1"])
    out = capsys.readouterr().out
    assert "Initializing with model" in out and "Loaded " in out
    assert "backbone.top.weight" not in out.split("skipped in the checkpoint:")[1].split(";")[0]


def test_evaluation_cli_takes_a_jax_model_dump(simple_dumps, tmp_path):
    """``evaluate_classification_accuracy --model <JAX model dump>`` in the
    port gives the JAX CLI's accuracies on the same file, within 1e-6."""
    from semantic_embeddings_torch.cli import evaluate_classification_accuracy as tcli
    from semantic_embeddings_tpu.cli import evaluate_classification_accuracy as jcli

    tmp, _, _ = simple_dumps
    argv = ["--dataset", DATA, "--data_root", str(tmp_path), "--batch_size", "16",
            "--layer", "prob", "--prob_features", "1", "--model", str(tmp / "model.ckpt")]
    want = jcli.main(argv)["model"]
    got = tcli.main(argv + ["--device", "cpu"])["model"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-6, (name, got[name], want[name])
