"""The port's ``torch.export`` artifacts: the cases of tests/test_export.py
(polymorphic batch, a named tap, an unknown tap, bf16, the CLI surface),
the artifact held against the JAX package's StableHLO artifact of the same
weights, and the artifact served through ``serve_model --artifact``.

rn18 at 32 px puts the conv + statistics op in the graph (one node per
block's ``conv_b``); the `simple` model is the JAX tests' own case.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.cli import common as jcommon
from semantic_embeddings_tpu.cli.export_model import export_checkpoint as jexport_checkpoint
from semantic_embeddings_tpu.train.state import new_train_state as jnew_train_state
from semantic_embeddings_tpu.train.state import save_checkpoint as jsave_checkpoint
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.cli import common, export_model, serve_model
from semantic_embeddings_torch.serving import ServingClient
from semantic_embeddings_torch.train.state import new_train_state, save_checkpoint

CPU = torch.device("cpu")
RN18_META = {"architecture": "rn18", "embed_dim": 16, "loss": "inv_corr", "cls_classes": 4}


def _randomize_bn(tree, seed=0):
    """BN statistics and scales away from their init, so that eval-mode BN
    is not the identity."""
    rng = np.random.default_rng(seed)
    draw = {"var": lambda s: rng.uniform(0.5, 2.0, s), "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(size=s) * 0.1}

    def walk(t, in_bn=False):
        out = {}
        for k, v in t.items():
            if hasattr(v, "items"):
                out[k] = walk(v, in_bn or "bn" in k)
            elif in_bn and k in draw:
                out[k] = draw[k](np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(tree)


@pytest.fixture(scope="module")
def rn18_pair(tmp_path_factory):
    """JAX and port checkpoints of one rn18 embedding model (16-d l2norm
    output, 4-way head, randomized BN), the weights through ``convert``."""
    tmp = tmp_path_factory.mktemp("export")
    jmodel, _ = jcommon.build_embedding_model(16, "rn18", "inv_corr", 4)
    variables = _randomize_bn(jax.device_get(dict(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))))
    jsave_checkpoint(str(tmp / "rn18.ckpt"), jnew_train_state(variables), RN18_META)
    model, _ = common.build_embedding_model(16, "rn18", "inv_corr", 4)
    convert.load_flax_variables(model, variables)
    save_checkpoint(str(tmp / "rn18.pt"), new_train_state(model), RN18_META)
    return tmp, model.eval()


@pytest.fixture(scope="module")
def simple_dump(tmp_path_factory):
    """A tiny trained-shape checkpoint in the learners' dump format (the
    JAX export tests' model)."""
    model, _ = common.build_embedding_model(16, "simple", "inv_corr", 4)
    path = str(tmp_path_factory.mktemp("export_simple") / "model.pt")
    save_checkpoint(path, new_train_state(model), {
        "architecture": "simple", "embed_dim": 16, "loss": "inv_corr", "cls_classes": 4})
    return path


def _x(rng, b, size=8):
    return rng.normal(size=(b, size, size, 3)).astype(np.float32)


def test_export_round_trip_polymorphic_batch(simple_dump, tmp_path):
    out = str(tmp_path / "model.pt2")
    export_model.export_checkpoint(simple_dump, out, CPU, input_size=8, batch=-1,
                                   validate=True)
    sidecar = json.load(open(out + ".json"))
    assert sidecar["architecture"] == "simple"
    assert sidecar["input_shape"] == [-1, 8, 8, 3]
    assert sidecar["platforms"] == ["cpu"] and sidecar["torch_version"] == torch.__version__
    fn, _ = export_model.load_artifact(out)
    model, _ = common.rebuild_model_from_checkpoint(simple_dump, CPU)
    rng = np.random.default_rng(1)
    for b in (1, 3, 7):  # one artifact serves several batch sizes
        x = torch.from_numpy(_x(rng, b))
        with torch.no_grad():
            got, want = fn(x), model(x)
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_export_named_tap(simple_dump, tmp_path):
    out = str(tmp_path / "tap.pt2")
    export_model.export_checkpoint(simple_dump, out, CPU, layer="avg_pool", input_size=8,
                                   batch=2, validate=True)
    fn, sidecar = export_model.load_artifact(out)
    assert sidecar["input_shape"][0] == 2 and sidecar["layer"] == "avg_pool"
    assert fn(torch.zeros(2, 8, 8, 3)).shape[0] == 2


def test_export_unknown_tap_raises(simple_dump, tmp_path):
    with pytest.raises(ValueError, match="No feature tap"):
        export_model.export_checkpoint(simple_dump, str(tmp_path / "x.pt2"), CPU,
                                       layer="nonexistent", input_size=8, batch=1)


def test_export_bf16_compute(rn18_pair, tmp_path):
    """--bf16 bakes bfloat16 compute into the artifact (an autocast region
    in the graph): outputs track the f32 forward within bf16 tolerance,
    equal the direct bf16 forward, and the sidecar records the dtype."""
    tmp, model = rn18_pair
    out = str(tmp_path / "bf16.pt2")
    export_model.export_checkpoint(str(tmp / "rn18.pt"), out, CPU, layer="l2norm",
                                   input_size=32, batch=-1, validate=True, bf16=True)
    assert json.load(open(out + ".json"))["compute_dtype"] == "bfloat16"
    program = torch.export.load(out)
    assert export_model.count_op_nodes(program, "wrap_with_autocast") >= 1
    fn, _ = export_model.load_artifact(out)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got = fn(x)
        want = common.forward_tap(model, x, "l2norm")
        with torch.autocast("cpu", dtype=torch.bfloat16):
            direct = common.forward_tap(model, x, "l2norm").float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, direct, rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-2, atol=3e-2)
    assert (got - want).abs().max() > 0  # bf16 compute, not f32


def test_export_cli_surface(simple_dump, tmp_path):
    out = str(tmp_path / "cli.pt2")
    export_model.main(["--checkpoint", simple_dump, "--out", out, "--input_size", "8",
                       "--batch", "2", "--device", "cpu", "--validate"])
    sidecar = json.load(open(out + ".json"))
    assert sidecar["platforms"] == ["cpu"] and sidecar["input_shape"] == [2, 8, 8, 3]
    assert "semantic_embeddings_torch.ops" in sidecar["load_requires"]


def test_rn18_artifact_holds_the_conv_op_and_equals_the_jax_artifact(rn18_pair, tmp_path):
    """The port's rn18 artifact keeps one ``conv3x3_bn_stats`` node per
    block (8) and aten convs for the rest only, and on the same numpy
    inputs equals the JAX package's StableHLO artifact of the same weights
    (both at the l2norm tap, batch-polymorphic) within 1e-5."""
    tmp, _ = rn18_pair
    out, jout = str(tmp_path / "rn18.pt2"), str(tmp_path / "rn18.shlo")
    sidecar = export_model.export_checkpoint(str(tmp / "rn18.pt"), out, CPU,
                                             layer="l2norm", input_size=32, batch=-1)
    assert sidecar["custom_op_nodes"]["conv3x3_bn_stats"] == 8
    program = torch.export.load(out)
    assert export_model.count_op_nodes(program, "conv3x3_bn_stats") == 8
    # the stem, each stage's projection and each block's first conv: 1 + 4 + 8
    assert export_model.count_op_nodes(program, "aten.conv2d") == 13
    jexport_checkpoint(str(tmp / "rn18.ckpt"), jout, layer="l2norm", input_size=32,
                       batch=-1, platforms=("cpu",))
    from jax import export as jexport

    restored = jexport.deserialize(open(jout, "rb").read())
    fn, _ = export_model.load_artifact(out)
    rng = np.random.default_rng(3)
    for b in (2, 5):
        x = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            got = fn(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(restored.call(x)), rtol=0, atol=1e-5)


def _serve(*argv):
    args = serve_model.build_parser().parse_args(
        ["--port", "0", "--max_batch", "4", "--device", "cpu", *argv])
    return serve_model.make_server(args).start()


def test_serve_artifact_over_http_equals_the_direct_forward(rn18_pair, tmp_path):
    """``serve_model --artifact`` loads the .pt2 and its sidecar (input size
    32) and answers over HTTP with the direct forward's rows within 1e-5."""
    tmp, model = rn18_pair
    out = str(tmp_path / "serve.pt2")
    export_model.export_checkpoint(str(tmp / "rn18.pt"), out, CPU, layer="l2norm",
                                   input_size=32, batch=-1)
    srv = _serve("--artifact", out, "--mean", "120,118,105", "--std", "60,59,61")
    pixels = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3)).astype(np.float32)
    try:
        assert srv.engine.input_tail == (32, 32, 3)
        got = ServingClient(f"http://127.0.0.1:{srv.port}").predict(pixels)
    finally:
        srv.stop()
    x = (torch.from_numpy(pixels) - torch.tensor([120.0, 118.0, 105.0])) / torch.tensor(
        [60.0, 59.0, 61.0])
    with torch.no_grad():
        want = common.forward_tap(model, x, "l2norm").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_serve_fixed_batch_artifact_runs_that_batch_only(simple_dump, tmp_path):
    out = str(tmp_path / "fixed.pt2")
    export_model.export_checkpoint(simple_dump, out, CPU, layer="l2norm", input_size=8,
                                   batch=4)
    srv = _serve("--artifact", out)
    try:
        assert srv.engine.buckets == [4]
        got = srv.engine.predict(np.ones((3, 8, 8, 3), np.float32), timeout=30)
    finally:
        srv.stop()
    assert got.shape == (3, 16)


@pytest.mark.parametrize("extra", [["--bf16"], ["--layer", "prob"]])
def test_serve_artifact_refuses_what_export_bakes_in(simple_dump, tmp_path, extra):
    out = str(tmp_path / "a.pt2")
    export_model.export_checkpoint(simple_dump, out, CPU, input_size=8)
    with pytest.raises(SystemExit, match="export time"):
        _serve("--artifact", out, *extra)


def test_serve_refuses_a_source_mismatch(simple_dump, tmp_path):
    out = str(tmp_path / "b.pt2")
    export_model.export_checkpoint(simple_dump, out, CPU, input_size=8)
    with pytest.raises(SystemExit, match="exactly one"):
        _serve("--artifact", out, "--checkpoint", simple_dump)
    with pytest.raises(SystemExit, match="exactly one"):
        _serve()
    sidecar = json.load(open(out + ".json"))
    sidecar["platforms"] = ["cuda"]
    json.dump(sidecar, open(out + ".json", "w"))
    with pytest.raises(SystemExit, match="exported for"):
        _serve("--artifact", out)
