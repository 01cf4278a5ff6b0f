"""The port's serving runtime: the batching engine's semantics (as the JAX
package's tests hold its engine), the HTTP frontend and client, and the
serve CLI end to end on the CPU, with a port model from converted JAX
weights held against the JAX model's output."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.cli import common as jcommon
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.cli import common, serve_model
from semantic_embeddings_torch.serving import (
    BatchingEngine,
    EngineOverloaded,
    Preprocessor,
    PreprocessError,
    ServingClient,
    ServingError,
    ServingServer,
    default_buckets,
)
from semantic_embeddings_torch.serving.client import to_pixels
from semantic_embeddings_torch.serving.engine import to_host
from semantic_embeddings_torch.train.state import new_train_state, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# engine


def test_default_buckets():
    assert default_buckets(256) == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert default_buckets(6) == [1, 2, 4, 6]
    assert default_buckets(1) == [1]


def make_engine(fn=None, seen=None, **kw):
    def default_fn(x):
        if seen is not None:
            seen.append(x.shape[0])
        t = torch.from_numpy(x)
        return {"emb": t * 2.0, "sum": t.sum(dim=(1, 2, 3))}

    kw.setdefault("max_batch", 8)
    kw.setdefault("timeout_ms", 1.0)
    return BatchingEngine(fn or default_fn, (4, 4, 3), **kw)


def test_engine_single_request_roundtrip():
    seen = []
    with make_engine(seen=seen) as eng:
        x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
        out = eng.predict(x, timeout=10)
        assert isinstance(out["emb"], np.ndarray)
        np.testing.assert_array_equal(out["emb"], x * 2.0)
        np.testing.assert_allclose(out["sum"], x.sum(axis=(1, 2, 3)))
    assert seen == [2]  # a 2-image request runs in the 2-bucket


def test_engine_pads_to_bucket():
    seen = []
    with make_engine(seen=seen) as eng:
        out = eng.predict(np.ones((3, 4, 4, 3), np.float32), timeout=10)
        assert out["emb"].shape == (3, 4, 4, 3)  # padding rows trimmed
    assert seen == [4]


def test_engine_coalesces_concurrent_requests():
    seen = []
    eng = make_engine(seen=seen, timeout_ms=300.0)
    rng = np.random.default_rng(0)
    reqs = [rng.normal(size=(n, 4, 4, 3)).astype(np.float32) for n in (1, 2, 1, 3)]
    futures = [eng.submit(r) for r in reqs]
    eng.start()
    outs = [f.result(timeout=10) for f in futures]
    eng.stop()
    assert seen == [8]  # one device call for all 7 images, in the 8-bucket
    stats = eng.stats()
    assert (stats["batches"], stats["images"], stats["padded_images"],
            stats["requests"]) == (1, 7, 1, 4)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o["emb"], r * 2.0)


def test_engine_respects_max_batch_split():
    seen = []
    eng = make_engine(seen=seen, max_batch=4, timeout_ms=300.0)
    futures = [eng.submit(np.full((3, 4, 4, 3), i, np.float32)) for i in range(2)]
    eng.start()
    for i, f in enumerate(futures):
        np.testing.assert_array_equal(f.result(timeout=10)["emb"],
                                      np.full((3, 4, 4, 3), 2.0 * i))
    eng.stop()
    assert seen == [4, 4]  # 3 + 3 > max_batch 4: two packs, each 3 -> 4


def test_engine_validates_requests():
    with make_engine() as eng:
        with pytest.raises(ValueError, match="bad input shape"):
            eng.submit(np.zeros((1, 5, 4, 3), np.float32))
        with pytest.raises(ValueError, match="outside"):
            eng.submit(np.zeros((9, 4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="outside"):
            eng.submit(np.zeros((0, 4, 4, 3), np.float32))


def test_engine_errors_reach_every_waiter_as_independent_copies():
    def boom(x):
        raise RuntimeError("device on fire")

    eng = make_engine(fn=boom, timeout_ms=300.0)
    futs = [eng.submit(np.zeros((1, 4, 4, 3), np.float32)) for _ in range(2)]
    eng.start()
    raised = []
    for f in futs:
        with pytest.raises(RuntimeError, match="device on fire") as ei:
            f.result(timeout=10)
        raised.append(ei.value)
    eng.stop()
    assert raised[0] is not raised[1]
    assert raised[0].__cause__ is raised[1].__cause__
    assert eng.stats()["errors"] == 2


def test_engine_stop_fails_queued_requests():
    eng = make_engine()
    fut = eng.submit(np.zeros((1, 4, 4, 3), np.float32))
    eng.stop()  # never started: the queued request fails instead of hanging
    with pytest.raises(RuntimeError, match="engine stopped"):
        fut.result(timeout=5)
    assert eng.stats()["pending_images"] == 0


def test_engine_backpressure():
    release = threading.Event()

    def slow(x):
        release.wait(10)
        return {"emb": torch.from_numpy(x) * 2.0}

    eng = make_engine(fn=slow, max_batch=4, max_queue=6, timeout_ms=1.0)
    eng.start()
    try:
        futs = [eng.submit(np.ones((2, 4, 4, 3), np.float32)) for _ in range(3)]
        with pytest.raises(EngineOverloaded, match="retry later"):
            eng.submit(np.ones((1, 4, 4, 3), np.float32))
        release.set()
        for f in futs:
            assert f.result(timeout=10)["emb"].shape == (2, 4, 4, 3)
        deadline = time.time() + 5
        while time.time() < deadline:  # drained: the capacity is back
            try:
                fut = eng.submit(np.ones((4, 4, 4, 3), np.float32))
                break
            except EngineOverloaded:
                time.sleep(0.01)
        else:
            pytest.fail("queue never drained")
        assert fut.result(timeout=10)["emb"].shape == (4, 4, 4, 3)
    finally:
        eng.stop()


def test_engine_warmup_runs_every_bucket():
    seen = []
    eng = make_engine(seen=seen, max_batch=8)
    timings = eng.warmup()
    assert seen == [1, 2, 4, 8] and sorted(timings) == [1, 2, 4, 8]
    with eng:
        assert eng.predict(np.ones((3, 4, 4, 3), np.float32), timeout=10)["emb"].shape == (
            3, 4, 4, 3)


def test_to_host_converts_trees():
    out = to_host({"a": torch.ones(2), "b": (torch.zeros(1), np.arange(3))})
    assert isinstance(out["a"], np.ndarray) and isinstance(out["b"], tuple)
    np.testing.assert_array_equal(out["b"][1], np.arange(3))


# ---------------------------------------------------------------------------
# preprocessing and the client's wire


def test_preprocessor_normalizes_arrays():
    prep = Preprocessor(4, mean=[1.0, 2.0, 3.0], std=[2.0, 2.0, 2.0])
    x = np.ones((4, 4, 3), np.float32) * 5.0
    got = prep.from_array(x)
    assert got.shape == (1, 4, 4, 3)
    np.testing.assert_allclose(got[0, 0, 0], [2.0, 1.5, 1.0])
    np.testing.assert_array_equal(prep.from_array(x, normalized=True)[0], x)
    with pytest.raises(PreprocessError, match="bad input shape"):
        prep.from_array(np.zeros((2, 5, 4, 3)))


@pytest.mark.parametrize("bad", [255.5, 256.0, -1.0, 3.25, np.nan])
def test_device_norm_refuses_values_that_are_not_pixels(bad):
    """In device_norm mode a float that is not an integer in [0, 255] is
    refused, not rounded or clipped into range."""
    prep = Preprocessor(4, device_norm=True)
    x = np.full((1, 4, 4, 3), 7.0, np.float32)
    np.testing.assert_array_equal(prep.from_array(x), np.full((1, 4, 4, 3), 7, np.uint8))
    x[0, 1, 2, 0] = bad
    with pytest.raises(PreprocessError, match=r"integer values in \[0, 255\]"):
        prep.from_array(x)
    with pytest.raises(PreprocessError, match="pre-normalized"):
        prep.from_array(x, normalized=True)


def test_client_rounds_and_range_checks_the_uint8_wire():
    np.testing.assert_array_equal(to_pixels(np.array([0.4, 0.6, 254.5, 255.0])),
                                  np.array([0, 1, 254, 255], np.uint8))
    for bad in (np.array([255.6]), np.array([-0.6]), np.array([np.inf])):
        with pytest.raises(ValueError, match=r"\[0, 255\]"):
            to_pixels(bad)
    client = ServingClient("http://127.0.0.1:9")
    with pytest.raises(ValueError, match=r"\[0, 255\]"):  # raised before sending
        client.predict(np.full((1, 4, 4, 3), 300.0), wire_dtype=np.uint8)


def test_client_retries_5xx_and_connection_errors(monkeypatch):
    client = ServingClient("http://127.0.0.1:9", retries=3, retry_backoff=0.0)
    calls = {"n": 0}

    def flaky(path, body=None, ctype=None, accept=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise urllib.error.URLError("connection refused")
        if calls["n"] == 2:
            raise ServingError(503, "queue full; retry later")
        return "application/json", b'{"status": "ok"}'

    monkeypatch.setattr(client, "_request_once", flaky)
    assert client.health() == {"status": "ok"} and calls["n"] == 3

    def bad_request(path, body=None, ctype=None, accept=None):
        calls["n"] += 1
        raise ServingError(400, "bad body")

    calls["n"] = 0
    monkeypatch.setattr(client, "_request_once", bad_request)
    with pytest.raises(ServingError, match="bad body"):
        client.health()
    assert calls["n"] == 1  # 4xx is never retried

    def always_503(path, body=None, ctype=None, accept=None):
        calls["n"] += 1
        raise ServingError(503, "still full")

    calls["n"] = 0
    monkeypatch.setattr(client, "_request_once", always_503)
    with pytest.raises(ServingError, match="still full"):
        client.health()
    assert calls["n"] == 4  # 1 + 3 retries


def test_client_default_is_no_retry(monkeypatch):
    client = ServingClient("http://127.0.0.1:9")
    calls = {"n": 0}

    def always_503(path, body=None, ctype=None, accept=None):
        calls["n"] += 1
        raise ServingError(503, "full")

    monkeypatch.setattr(client, "_request_once", always_503)
    with pytest.raises(ServingError):
        client.health()
    assert calls["n"] == 1


# ---------------------------------------------------------------------------
# HTTP


def _post(srv, body, ctype, accept=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/predict", data=body, method="POST",
        headers={"Content-Type": ctype, **({"Accept": accept} if accept else {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture()
def server():
    eng = BatchingEngine(lambda x: torch.from_numpy(x).sum(dim=(1, 2, 3)), (4, 4, 3),
                         max_batch=8, timeout_ms=1.0)
    srv = ServingServer(eng, Preprocessor(4, mean=[0.0] * 3, std=[1.0] * 3),
                        {"architecture": "test"}, host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()


def test_http_routes_and_client(server):
    from PIL import Image

    c = ServingClient(f"http://127.0.0.1:{server.port}")
    assert c.health() == {"status": "ok"}
    assert c.meta()["architecture"] == "test"
    x = np.full((2, 4, 4, 3), 2.0, np.float32)
    np.testing.assert_allclose(c.predict(x), [96.0, 96.0])  # npy
    np.testing.assert_allclose(c.predict_json(x, normalized=True), [96.0, 96.0])
    np.testing.assert_allclose(c.predict(x, wire_dtype=np.uint8), [96.0, 96.0])
    buf = io.BytesIO()
    Image.fromarray(np.full((4, 4, 3), 10, np.uint8)).save(buf, "JPEG", quality=100)
    (pred,) = c.predict_jpeg(buf.getvalue())
    assert abs(pred - 480.0) < 48.0
    with pytest.raises(ServingError, match="bad input shape") as ei:
        c.predict(np.zeros((1, 5, 4, 3), np.float32))
    assert ei.value.code == 400
    assert c.stats()["batches"] >= 4


def test_http_errors(server):
    code, _, body = _post(server, b"{not json", "application/json")
    assert code == 400
    code, _, body = _post(server, b'{"x": 1}', "application/json")
    assert code == 400 and b"instances" in body
    code, _, _ = _post(server, b"not a jpeg", "image/jpeg")
    assert code == 400
    code, _, body = _post(server, json.dumps(
        {"instances": np.zeros((9, 4, 4, 3)).tolist()}).encode(), "application/json")
    assert code == 400 and b"outside" in body


def test_http_503_with_retry_after():
    release = threading.Event()

    def slow(x):
        release.wait(10)
        return torch.from_numpy(x).sum(dim=(1, 2, 3))

    eng = BatchingEngine(slow, (4, 4, 3), max_batch=2, max_queue=2, timeout_ms=1.0)
    srv = ServingServer(eng, Preprocessor(4), {}, host="127.0.0.1", port=0).start()
    try:
        first = eng.submit(np.zeros((2, 4, 4, 3), np.float32))  # taken, blocks
        deadline = time.time() + 5
        while eng.stats()["pending_images"] and time.time() < deadline:
            time.sleep(0.01)
        queued = eng.submit(np.zeros((2, 4, 4, 3), np.float32))  # fills the queue
        code, headers, body = _post(srv, json.dumps(
            {"instances": np.zeros((1, 4, 4, 3)).tolist()}).encode(), "application/json")
        assert code == 503 and headers["Retry-After"] == "1" and b"retry later" in body
        release.set()
        assert first.result(timeout=10).shape == (2,) and queued.result(timeout=10).shape == (2,)
    finally:
        release.set()
        srv.stop()


def test_http_500_on_model_failure():
    def boom(x):
        raise RuntimeError("device on fire")

    srv = ServingServer(BatchingEngine(boom, (4, 4, 3), max_batch=2), Preprocessor(4), {},
                        host="127.0.0.1", port=0).start()
    try:
        code, _, body = _post(srv, json.dumps(
            {"instances": np.zeros((4, 4, 3)).tolist()}).encode(), "application/json")
        assert code == 500 and b"device on fire" in body
    finally:
        srv.stop()


def test_http_burst_of_32_connections_all_served():
    eng = BatchingEngine(lambda x: torch.from_numpy(x).sum(dim=(1, 2, 3)), (4, 4, 3),
                         max_batch=32, timeout_ms=50.0)
    srv = ServingServer(eng, Preprocessor(4), {}, host="127.0.0.1", port=0).start()
    try:
        results, errors = [], []

        def worker(i):
            try:
                x = np.full((1, 4, 4, 3), float(i), np.float32)
                code, _, body = _post(srv, json.dumps({"instances": x.tolist()}).encode(),
                                      "application/json")
                results.append((i, code, json.loads(body)["predictions"]))
            except Exception as e:  # noqa: BLE001 - collected and asserted below
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:4]
        assert sorted(results) == [(i, 200, [i * 48.0]) for i in range(32)]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# serve CLI: a port model from converted JAX weights


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


META = {"architecture": "resnet-32", "embed_dim": 64, "loss": "inv_corr",
        "cls_classes": 4}


@pytest.fixture(scope="module")
def checkpoint_pair(tmp_path_factory):
    """The JAX resnet-32 embedding model with a 4-way head, its randomized
    variables, and a port checkpoint of the same weights."""
    jmodel, _ = jcommon.build_embedding_model(64, "resnet-32", "inv_corr", 4)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    variables = _randomize_bn(jax.device_get(variables))
    model, _ = common.build_embedding_model(64, "resnet-32", "inv_corr", 4)
    convert.load_flax_variables(model, variables)
    path = str(tmp_path_factory.mktemp("serve") / "model.pt")
    save_checkpoint(path, new_train_state(model), META)
    return jmodel, variables, path


def _jax_tap(jmodel, variables, x, layer):
    _, inter = jmodel.apply(variables, jnp.asarray(x), train=False,
                            mutable=["intermediates"])
    return np.asarray(jcommon.resolve_tap(inter["intermediates"], layer))


def _serve(path, *extra):
    args = serve_model.build_parser().parse_args(
        ["--checkpoint", path, "--input_size", "32", "--port", "0", "--max_batch", "8",
         "--device", "cpu", *extra])
    return serve_model.make_server(args).start()


STATS = ["--mean", "120.5,118.2,105.0", "--std", "60.0,59.5,61.2"]


@pytest.mark.parametrize("layer", ["l2norm", "prob", "avg_pool"])
def test_serve_cli_matches_jax_over_json_and_npy(checkpoint_pair, layer):
    jmodel, variables, path = checkpoint_pair
    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.float32)
    mean, std = np.array([120.5, 118.2, 105.0]), np.array([60.0, 59.5, 61.2])
    want = _jax_tap(jmodel, variables, ((pixels - mean) / std).astype(np.float32), layer)
    srv = _serve(path, "--layer", layer, *STATS)
    try:
        client = ServingClient(f"http://127.0.0.1:{srv.port}")
        meta = client.meta()
        assert meta["architecture"] == "resnet-32" and meta["layer"] == layer
        assert meta["device"] == "cpu" and meta["input_size"] == 32
        got_npy = client.predict(pixels)
        got_json = np.asarray(client.predict_json(((pixels - mean) / std).tolist(),
                                                  normalized=True), np.float32)
    finally:
        srv.stop()
    for got in (got_npy, got_json):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_serve_cli_full_output_and_device_preproc(checkpoint_pair):
    """Without --layer the (embedding, prob) pair comes back as JSON; with
    --device_preproc uint8 pixels normalized on the device give what host
    normalization gives, and out-of-range floats get 400."""
    jmodel, variables, path = checkpoint_pair
    pixels = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    results = {}
    for tag, extra in (("host", []), ("device", ["--device_preproc"])):
        srv = _serve(path, *STATS, *extra)
        try:
            client = ServingClient(f"http://127.0.0.1:{srv.port}")
            assert srv.engine.dtype == (np.uint8 if tag == "device" else np.float32)
            results[tag] = client.predict(pixels, wire_dtype=np.uint8)
            if tag == "device":
                code, _, body = _post(srv, json.dumps(
                    {"instances": np.full((1, 32, 32, 3), 255.5).tolist()}).encode(),
                    "application/json")
                assert code == 400 and b"[0, 255]" in body
        finally:
            srv.stop()
    emb, prob = (np.asarray(a, np.float32) for a in results["host"])
    assert emb.shape == (2, 64) and prob.shape == (2, 4)
    for a, b in zip(results["device"], results["host"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    x = ((pixels - np.array([120.5, 118.2, 105.0])) / np.array([60.0, 59.5, 61.2]))
    np.testing.assert_allclose(emb, _jax_tap(jmodel, variables, x.astype(np.float32),
                                             "l2norm"), rtol=0, atol=1e-5)


def test_serve_cli_bf16_stays_near_f32(checkpoint_pair):
    _, _, path = checkpoint_pair
    pixels = np.random.default_rng(7).integers(0, 256, (2, 32, 32, 3)).astype(np.float32)
    outs = []
    for extra in ([], ["--bf16"]):
        srv = _serve(path, "--layer", "l2norm", *STATS, *extra)
        try:
            outs.append(ServingClient(f"http://127.0.0.1:{srv.port}").predict(pixels))
        finally:
            srv.stop()
    np.testing.assert_allclose(np.linalg.norm(outs[1], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=0.05)


# --artifact (tests/test_torch_export.py) and --gpus are ported: --gpus
# serves over device replicas, with buckets that divide over them; what
# stays refused is a second model source
@pytest.mark.parametrize("extra", [["--gpus", "2"], ["--gpus", "2", "--artifact", "model.pt2"]])
def test_serve_cli_refuses_unported(checkpoint_pair, extra):
    _, _, path = checkpoint_pair
    if "--artifact" in extra:
        with pytest.raises(SystemExit, match="exactly one of --artifact / --checkpoint"):
            _serve(path, *extra)
        return
    srv = _serve(path, *extra)
    try:
        meta = ServingClient(f"http://127.0.0.1:{srv.port}").meta()
        assert meta["devices"] == 2 and srv.engine.buckets == [2, 4, 8]
    finally:
        srv.stop()


def test_serve_cli_resolve_stats():
    from semantic_embeddings_torch import data

    def stats(argv):
        return serve_model.resolve_stats(serve_model.build_parser().parse_args(argv))

    assert stats(["--mean", "1,2,3", "--std", "4,5,6", "--dataset", "cifar-100"]) == (
        [1.0, 2.0, 3.0], [4.0, 5.0, 6.0])
    assert stats(["--dataset", "cifar-100"]) == serve_model.PUBLISHED_STATS["cifar-100"]
    assert stats(["--dataset", "ilsvrc"]) == (data.IMAGENET_MEAN, data.IMAGENET_STD)
    assert stats(["--dataset", "nab-caffe"]) == (data.CAFFE_MEAN, data.CAFFE_STD)
    assert stats(["--dataset", "cub"]) == data.CUB_STATS
    with pytest.raises(SystemExit, match="no published stats"):
        stats(["--dataset", "mit67"])
    assert stats([]) == (None, None)


def test_published_stats_equal_the_jax_package():
    from semantic_embeddings_tpu import data as jdata
    from semantic_embeddings_tpu.cli import serve_model as jserve
    from semantic_embeddings_torch import data

    assert serve_model.PUBLISHED_STATS == jserve.PUBLISHED_STATS
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "CAFFE_MEAN", "CAFFE_STD", "CUB_STATS"):
        assert getattr(data, name) == getattr(jdata, name), name


def test_serve_cli_sigterm_drains_and_exits_zero(checkpoint_pair, tmp_path):
    _, _, path = checkpoint_pair
    log = tmp_path / "serve.log"
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "semantic_embeddings_torch.cli.serve_model",
             "--checkpoint", path, "--layer", "l2norm", "--input_size", "32",
             "--port", "0", "--device", "cpu", "--max_batch", "2", "--warmup"],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and "serving on" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            time.sleep(0.1)
        url = log.read_text().split("serving on ")[1].split()[0]
        client = ServingClient(url)
        assert client.predict(np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 64)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert "serving stopped" in log.read_text()


def test_serve_cli_cuda_without_gpu_raises(checkpoint_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, path = checkpoint_pair
    args = serve_model.build_parser().parse_args(["--checkpoint", path])
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve_model.make_server(args)


# -- JPEG bodies through the native decoder -------------------------------------


@pytest.mark.parametrize("size,target", [((300, 420), None), ((90, 60), 72), ((50, 50), 200)])
def test_jpeg_body_pixels_equal_the_jax_servers(tmp_path, size, target):
    """A JPEG body through the port's server preprocessing gives the same
    uint8 pixels as the JAX server's ``from_jpeg`` (both decode with the
    native decoder: resize of the shorter side, center crop), and over
    HTTP the answer of the same pixels sent as an npy body."""
    from PIL import Image

    from semantic_embeddings_tpu.serving.server import Preprocessor as JPreprocessor

    rng = np.random.default_rng(sum(size))
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, size + (3,)).astype(np.uint8)).save(
        buf, "JPEG", quality=85)
    blob = buf.getvalue()
    ours = Preprocessor(48, target_size=target, device_norm=True, n_threads=2)
    ref = JPreprocessor(48, target_size=target, device_norm=True, n_threads=2)
    got = ours.from_jpeg(blob)
    assert got.dtype == np.uint8 and got.shape == (1, 48, 48, 3)
    np.testing.assert_array_equal(got, ref.from_jpeg(blob))
    mean, std = [100.0, 110.0, 120.0], [50.0, 60.0, 70.0]
    np.testing.assert_array_equal(
        Preprocessor(48, mean=mean, std=std, target_size=target).from_jpeg(blob),
        JPreprocessor(48, mean=mean, std=std, target_size=target).from_jpeg(blob))

    eng = BatchingEngine(lambda x: torch.from_numpy(x.astype(np.float64)).sum(dim=(1, 2, 3)),
                         (48, 48, 3), max_batch=4, timeout_ms=1.0, dtype=np.uint8)
    srv = ServingServer(eng, Preprocessor(48, device_norm=True, target_size=target),
                        {}, host="127.0.0.1", port=0).start()
    try:
        c = ServingClient(f"http://127.0.0.1:{srv.port}")
        np.testing.assert_array_equal(c.predict_jpeg(blob),
                                      c.predict(got, wire_dtype=np.uint8))
    finally:
        srv.stop()


def test_jpeg_decoder_choice():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((40, 60, 3), 90, np.uint8)).save(buf, "PNG")
    png = buf.getvalue()  # Pillow reads it, libjpeg does not
    with pytest.raises(PreprocessError, match="could not decode JPEG"):
        Preprocessor(32).from_jpeg(png)
    assert Preprocessor(32, decoder="pillow", device_norm=True).from_jpeg(png).shape == (
        1, 32, 32, 3)
    with pytest.raises(ValueError, match="decoder"):
        Preprocessor(32, decoder="libjpeg")
    args = serve_model.build_parser().parse_args(
        ["--checkpoint", "m.pt", "--decoder", "pillow", "--decode_threads", "2"])
    assert (args.decoder, args.decode_threads) == ("pillow", 2)
