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
    ["--remat"], ["--bn_per_replica"], ["--gpus", "2"], ["--spatial", "2"],
    ["--finetune", "w.pt"], ["--profile_dir", "trace"], ["--cls_base", "top"],
    ["--architecture", "wrn-28-10"],
])
def test_unported_flag_raises(tmp_path, embedding, extra):
    with pytest.raises(SystemExit, match="not ported yet"):
        learn_image_embeddings.main(
            _argv(tmp_path, embedding, "--device", "cpu", *extra))


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
