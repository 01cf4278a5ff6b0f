"""The port's trainer CLI end to end on the CPU, its refusals, and its
independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.embeddings import load_features, save_embeddings
from semantic_embeddings_torch.cli import learn_image_embeddings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def embedding(tmp_path):
    # resnet-32 in embedding mode has no top: 64 features, so a 64-d
    # class embedding of the 10 synthetic classes
    rng = np.random.default_rng(0)
    e = rng.normal(size=(10, 64))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    path = str(tmp_path / "emb.pickle")
    save_embeddings(path, list(range(10)), e)
    return path


def _argv(tmp_path, embedding, *extra):
    return ["--dataset", "synthetic-10-64-32", "--data_root", str(tmp_path),
            "--embedding", embedding, "--architecture", "resnet-32",
            "--batch_size", "16", "--epochs", "1", *extra]


def test_fused_loss_run_on_cpu(tmp_path, embedding, capsys):
    feat = str(tmp_path / "feat.pickle")
    dump = str(tmp_path / "model.pt")
    state = learn_image_embeddings.main(_argv(
        tmp_path, embedding, "--loss", "inv_corr", "--cls_weight", "0.1",
        "--fused_loss", "--feature_dump", feat, "--model_dump", dump,
        "--device", "cpu"))
    out = capsys.readouterr().out
    assert "TF32 off" in out and "epoch 1/1" in out
    assert state.step == 4 and state.epoch == 1
    assert all(p.device.type == "cpu" for p in state.model.parameters())
    ids, feats = load_features(feat)
    assert feats.shape == (32, 64) and list(ids) == list(range(32))
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
    payload = torch.load(dump, weights_only=True)
    assert payload["metadata"]["architecture"] == "resnet-32"
    assert payload["metadata"]["cls_classes"] == 10 and payload["step"] == 4


def test_snapshot_resumes(tmp_path, embedding):
    snap = str(tmp_path / "snap.pt")
    argv = _argv(tmp_path, embedding, "--snapshot", snap, "--device", "cpu",
                 "--no_progress")
    learn_image_embeddings.main(argv)
    state = learn_image_embeddings.main(
        argv[:argv.index("--epochs") + 1] + ["2"] + argv[argv.index("--epochs") + 2:]
        + ["--initial_epoch", "1"])
    assert state.step == 8 and state.epoch == 2


def test_device_cuda_without_gpu_raises(tmp_path, embedding):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        learn_image_embeddings.main(_argv(tmp_path, embedding, "--device", "cuda"))


@pytest.mark.parametrize("extra", [
    # every flag is ported: each case runs, or is refused, as the JAX
    # package's CLI runs or refuses it (--spatial must divide --gpus)
    ["--gpus", "4", "--remat", "--spatial", "2"], ["--bn_per_replica", "--profile_dir", "trace"],
    ["--gpus", "2", "--spatial", "2"], ["--spatial", "2"],
    ["--finetune", "w.pt", "--bn_per_replica", "--spatial", "2"], ["--profile_dir", "trace"],
    ["--profile_dir", "trace", "--cls_base", "top", "--cls_weight", "0.1"],
    ["--spatial", "2", "--architecture", "wrn-28-10"],
])
def test_unported_flag_raises(tmp_path, embedding, extra, capfd, recwarn):
    """What the JAX package's ``resolve_mesh`` does with the flags (8 host
    devices present, as the conftest gives it) the port's CLI does: the
    refusal word for word where --spatial does not divide --gpus, else a
    run (a small one: 16 px, two steps), with the grid it asks for and,
    for --profile_dir, the JAX warning that the run ended before the
    profile window."""
    from semantic_embeddings_tpu.cli import common as jcommon
    from semantic_embeddings_tpu.models import layers as JL

    def flag(name, default):
        return int(extra[extra.index(name) + 1]) if name in extra else default

    try:
        jcommon.resolve_mesh(flag("--gpus", 1), spatial=flag("--spatial", 1))
        refusal = None
    except SystemExit as e:
        refusal = str(e)
    finally:
        JL.set_default_bn_groups(1)
    # resnet-32 embeds with no top layer: --cls_base top takes a model with one
    model = ["--architecture", "simple"] if "--cls_base" in extra else []
    argv = _argv(tmp_path, embedding, "--device", "cpu", *extra, *model,
                 "--dataset", "synthetic-10-8-4-16", "--batch_size", "4")
    if refusal is not None:
        assert "must divide the device count" in refusal
        with pytest.raises(SystemExit) as ours:
            learn_image_embeddings.main(argv)
        assert str(ours.value) == refusal
        return
    learn_image_embeddings.main(argv)
    out = capfd.readouterr().out  # the spawned ranks' too
    gpus, spatial = flag("--gpus", 1), flag("--spatial", 1)
    if gpus > 1:
        assert f"spawning {gpus} data-parallel processes" in out
    if spatial > 1:
        assert f"a ({gpus // spatial}, {spatial}) (data, spatial) grid" in out
    if "--profile_dir" in extra:
        assert any("before the profile window start (step 10)" in str(w.message)
                   for w in recwarn)


# -- stage 3: the evaluation CLIs against the JAX package's ----------------


def _taxonomy(path, leaves):
    """Leaves 0..leaves-1, three to a superclass (100 + s), under root 1000."""
    lines = []
    for s in range(-(-leaves // 3)):
        lines.append(f"1000 {100 + s}")
        lines += [f"{100 + s} {c}" for c in range(3 * s, min(3 * s + 3, leaves))]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_evaluate_retrieval_cli_matches_jax(tmp_path, capsys):
    """One feature dump of synthetic-12's 300 test images (small-integer
    features, so that every similarity is exact), through both CLIs: the
    metric scalars agree within 1e-6, and the CSV has the same k."""
    from semantic_embeddings_tpu.cli import evaluate_retrieval as jcli
    from semantic_embeddings_torch.cli import evaluate_retrieval as tcli
    from semantic_embeddings_torch.embeddings import save_features

    feats = np.random.default_rng(0).integers(-3, 4, (300, 8)).astype(np.float32)
    save_features(str(tmp_path / "f.pickle"), feats)
    argv = ["--dataset", "synthetic-12-48-300", "--data_root", str(tmp_path),
            "--hierarchy", _taxonomy(tmp_path / "h.txt", 12),
            "--feat", str(tmp_path / "f.pickle"), "--plot_max", "20"]
    runs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        csv = str(tmp_path / f"{name}.csv")
        runs[name] = (cli.main(argv + ["--csv", csv] + extra)["f"], open(csv).read())
        assert "AHP (LCS_HEIGHT)" in capsys.readouterr().out
    (want, want_csv), (got, got_csv) = runs["jax"], runs["torch"]
    assert sorted(got) == sorted(want) and len(want) == 2 * 22 + 3
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-6, name
    assert [line.split(";")[0] for line in got_csv.splitlines()] == [
        line.split(";")[0] for line in want_csv.splitlines()]


# --gpus and --db_sharded are ported (tests/test_torch_parallel.py); the
# database-sharded ranking still refuses, with the JAX package's messages,
# the full-sort protocol and a single device
@pytest.mark.parametrize("extra", [["--gpus", "2", "--db_sharded"], ["--db_sharded"]])
def test_evaluate_retrieval_cli_refuses_unported(tmp_path, extra):
    from semantic_embeddings_torch.cli import evaluate_retrieval as tcli

    match = "db_sharded requires the top-k prefix" if "--gpus" in extra else (
        "db_sharded needs a mesh")
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--dataset", "synthetic-12", "--data_root", str(tmp_path),
                   "--hierarchy", "h.txt", "--feat", "f.pickle", "--device", "cpu",
                   *extra])


def test_evaluation_clis_need_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from semantic_embeddings_torch.cli import evaluate_classification_accuracy as ccli
    from semantic_embeddings_torch.cli import evaluate_retrieval as tcli

    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["--dataset", "synthetic-12", "--data_root", str(tmp_path),
                   "--hierarchy", "h.txt", "--feat", "f.pickle"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        ccli.main(["--dataset", "synthetic-12", "--data_root", str(tmp_path),
                   "--model", "m.pt", "--layer", "prob"])


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    """A JAX checkpoint of a resnet-32 embedding model (64-d l2norm output,
    10-way head, randomized BN) and the port's checkpoint of the same
    weights (through ``convert.flax_to_state_dict``)."""
    import jax

    from semantic_embeddings_tpu.cli import common as jcommon
    from semantic_embeddings_tpu.train.state import new_train_state as jnew_state
    from semantic_embeddings_tpu.train.state import save_checkpoint as jsave
    from semantic_embeddings_torch import convert
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.train.state import new_train_state, save_checkpoint

    meta = {"architecture": "resnet-32", "embed_dim": 64, "loss": "inv_corr",
            "cls_classes": 10}
    jmodel, _ = jcommon.build_embedding_model(64, "resnet-32", "inv_corr", 10)
    variables = jax.device_get(jcommon.init_model_state(jmodel, 32, 3).params)
    variables = _randomize_bn({"params": variables, "batch_stats": jax.device_get(
        jcommon.init_model_state(jmodel, 32, 3).batch_stats)})
    tmp = tmp_path_factory.mktemp("ckpt")
    jsave(str(tmp / "model.ckpt"), jnew_state(variables), meta)
    model, _ = common.build_embedding_model(64, "resnet-32", "inv_corr", 10)
    model.load_state_dict(convert.flax_to_state_dict(variables, model))
    save_checkpoint(str(tmp / "model.pt"), new_train_state(model), meta)
    return tmp, jmodel, variables


def _randomize_bn(tree, seed=0):
    rng = np.random.default_rng(seed)
    draw = {"var": lambda s: rng.uniform(0.5, 2.0, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(size=s) * 0.1,
            "bias": lambda s: rng.normal(size=s) * 0.1}

    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        return (draw[name](a.shape) if name in draw else a).astype(np.float32)

    return walk(tree)


@pytest.mark.parametrize("mode", ["prob_features", "centroids"])
def test_evaluate_classification_cli_matches_jax(checkpoint_pair, embedding, mode, capsys):
    """The model's own softmax (``--layer prob``) and the nearest class
    centroid (the class embedding, ``--layer l2norm``): the port's CLI on the
    port's checkpoint gives the JAX CLI's accuracies on the JAX checkpoint
    of the same weights, within 1e-6."""
    from semantic_embeddings_tpu.cli import evaluate_classification_accuracy as jcli
    from semantic_embeddings_torch.cli import evaluate_classification_accuracy as tcli

    tmp, _, _ = checkpoint_pair
    argv = ["--dataset", "synthetic-10-64-32", "--data_root", str(tmp),
            "--hierarchy", _taxonomy(tmp / "h.txt", 10), "--batch_size", "16"]
    argv += (["--layer", "prob", "--prob_features", "1"] if mode == "prob_features"
             else ["--layer", "l2norm", "--centroids", embedding])
    want = jcli.main(argv + ["--model", str(tmp / "model.ckpt")])["model"]
    got = tcli.main(argv + ["--model", str(tmp / "model.pt"), "--device", "cpu"])["model"]
    assert "Hierarchical Accuracy" in capsys.readouterr().out
    assert sorted(got) == sorted(want) and len(want) == 4
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-6, (name, got[name], want[name])
        assert 0.0 <= got[name] <= 1.0


def test_evaluate_classification_cli_svm_mode(checkpoint_pair):
    """The linear SVM on avg_pool features (scikit-learn, imported in this
    mode only), with two augmentation passes."""
    pytest.importorskip("sklearn")
    from semantic_embeddings_torch.cli import evaluate_classification_accuracy as tcli

    tmp, _, _ = checkpoint_pair
    perf = tcli.main(["--dataset", "synthetic-10-64-32", "--data_root", str(tmp),
                      "--model", str(tmp / "model.pt"), "--layer", "avg_pool",
                      "--augmentation_epochs", "2", "--device", "cpu"])["model"]
    assert sorted(perf) == ["Accuracy", "Avg. Accuracy", "Top-5 Accuracy"]
    assert all(0.0 <= v <= 1.0 for v in perf.values())


def test_extract_by_tap_draws_fresh_augmentation_each_pass(checkpoint_pair):
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.data import get_data_generator

    tmp, _, _ = checkpoint_pair
    model, meta = common.rebuild_model_from_checkpoint(str(tmp / "model.pt"), "cpu")
    assert meta["cls_classes"] == 10 and not model.training
    ds = get_data_generator("synthetic-10-16-8")
    cpu = torch.device("cpu")
    feats = common.extract_by_tap(model, ds.make_prepare(cpu), ds.train_eval_batches(
        10, epochs=2), cpu, layer="avg_pool", train_branch=True)
    assert feats.shape == (32, 64)
    assert not np.allclose(feats[:16], feats[16:])  # two passes, two draws
    again = common.extract_by_tap(model, ds.make_prepare(cpu), ds.train_eval_batches(
        10, epochs=2), cpu, layer="avg_pool", train_branch=True)
    np.testing.assert_array_equal(feats, again)  # one seed, one sequence
    plain = common.extract_by_tap(model, ds.make_prepare(cpu), ds.test_batches(5), cpu)
    assert plain.shape == (8, 64)  # the embedding of (embedding, prob)
    np.testing.assert_allclose(np.linalg.norm(plain, axis=1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="available: \\['avg_pool', 'l2norm', 'prob'\\]"):
        common.extract_by_tap(model, ds.make_prepare(cpu), ds.test_batches(5), cpu,
                              layer="logits")


# -- the feature taps against the JAX package's sow values ------------------


@pytest.mark.parametrize("arch", ["resnet-32", "rn18"])
def test_taps_match_jax_sow(arch):
    """Every tap of an embedding model with a 5-way head, at 32 px, equals
    the JAX package's ``sow`` value within 1e-5 of the tap's scale (its
    largest magnitude, where above 1: rn18's pooled features reach ~40,
    where 18 layers of f32 rounding leave a few 1e-7 of it); asking for
    the taps changes no output."""
    import jax
    import jax.numpy as jnp

    from semantic_embeddings_tpu.cli import common as jcommon
    from semantic_embeddings_torch import convert
    from semantic_embeddings_torch.cli import common

    jmodel, _ = jcommon.build_embedding_model(16, arch, "inv_corr", 5)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 32, 32, 3)), train=False))
    variables = _randomize_bn(variables)
    x = np.random.default_rng(3).normal(size=(3, 32, 32, 3)).astype(np.float32)
    _, inter = jmodel.apply(variables, jnp.asarray(x), train=False,
                            mutable=["intermediates"])
    model, _ = common.build_embedding_model(16, arch, "inv_corr", 5)
    convert.load_flax_variables(model, variables)
    model.eval()
    taps = {}
    with torch.no_grad():
        out = model(torch.from_numpy(x), taps=taps)
        plain = model(torch.from_numpy(x))
    names = ["avg_pool", "l2norm", "prob"] + (["embedding"] if arch == "rn18" else [])
    assert sorted(taps) == sorted(names)
    for name in names:
        want = np.asarray(jcommon.resolve_tap(inter["intermediates"], name))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(taps[name].numpy(), want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def test_train_step_calls_the_conv_op_as_before():
    """A train step of rn18 (taps off) calls the fused conv + statistics op
    once per block, as before the taps; an eval forward with taps on too."""
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.data import get_data_generator
    from semantic_embeddings_torch.models import resnet
    from semantic_embeddings_torch.ops import conv3x3
    from semantic_embeddings_torch.train import make_train_step

    model, spec = common.build_embedding_model(16, "rn18", "inv_corr", 10)
    calls = []

    def counting(x, w):
        calls.append(tuple(w.shape))
        return conv3x3.conv3x3_bn_stats(x, w)

    for m in model.modules():
        if isinstance(m, resnet._Block):
            m.conv_bn_stats = counting
    ds = get_data_generator("synthetic-10-16-8")
    state = common.init_model_state(model, torch.device("cpu"))
    rng = np.random.default_rng(0)
    table = rng.normal(size=(10, 16)).astype(np.float32)
    step = make_train_step(model, ds.make_prepare(torch.device("cpu")), loss_name="inv_corr",
                           class_embedding=table, cls_weight=0.1,
                           l2_penalty_fn=spec.l2_penalty)
    step(state, next(ds.train_batches(8, 0)), 0.1, torch.Generator().manual_seed(0))
    assert len(calls) == 8  # rn18: 2 + 2 + 2 + 2 blocks
    model.eval()
    with torch.no_grad():
        model(torch.zeros(2, 32, 32, 3), taps={})
    assert len(calls) == 16


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import semantic_embeddings_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
