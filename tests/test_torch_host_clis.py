"""The port's host-side CLIs against the JAX package's on the same inputs
(written from a seed): ``encode_hierarchy`` (tree and iNaturalist formats,
every id option), ``plot_hierarchy``, ``plot_recall_precision`` (its curves
and mAP, the ranking on the CPU), ``MetricsLogger``'s JSONL and TensorBoard
events; and ``compute_class_embedding --device``, which refuses to run
without a GPU (its run on the card is a ``cuda`` test)."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import json
import pickle

import numpy as np
import pytest
import torch

from semantic_embeddings_torch.cli import encode_hierarchy as tencode
from semantic_embeddings_torch.cli import plot_hierarchy as tplot
from semantic_embeddings_torch.cli import plot_recall_precision as trp
from semantic_embeddings_tpu.cli import encode_hierarchy as jencode
from semantic_embeddings_tpu.cli import plot_hierarchy as jplot
from semantic_embeddings_tpu.cli import plot_recall_precision as jrp

CPU = torch.device("cpu")


def _tree_file(tmp_path, seed=0):
    """An indented tree of 3 levels: 3 groups of 2-4 classes, one name with
    CUB's annotations."""
    rng = np.random.default_rng(seed)
    lines, leaves = ["Root"], []
    for g in range(3):
        lines.append(f"-- group {g}")
        for c in range(int(rng.integers(2, 5))):
            name = f"class {g}.{c}"
            leaves.append(name)
            lines.append(f"---- {name}" + (" (note) ?" if g == c == 0 else ""))
    path = tmp_path / "tree.txt"
    path.write_text("\n".join(lines) + "\n")
    return path, leaves


def _inat_file(tmp_path):
    ranks = ["kingdom", "phylum", "class", "order", "family", "genus"]
    cats = []
    for i in range(6):
        cats.append({"id": i, "supercategory": "Aves" if i % 2 else "Plantae",
                     **{r: f"{r[:2]}{i // (2 + k)}" for k, r in enumerate(ranks)}})
    path = tmp_path / "inat.json"
    path.write_text(json.dumps({"categories": cats}))
    return path


@pytest.mark.parametrize("case", ["plain", "strip_one_based", "str_ids", "class_list",
                                  "name_map", "meta_file", "plot", "inat", "inat_aves"])
def test_encode_hierarchy_writes_the_jax_output(case, tmp_path):
    tree, leaves = _tree_file(tmp_path)
    stripped = [n.split(" (")[0] for n in leaves]
    extra = {
        "plain": [],
        "strip_one_based": ["--strip_annotations", "--one_based"],
        "str_ids": ["--str_ids"],
        "class_list": ["--strip_annotations", "--class_list", "classes.txt"],
        "name_map": ["--strip_annotations", "--name_map", "names.txt", "--one_based"],
        "meta_file": ["--strip_annotations", "--meta_file", "meta.pickle"],
        "plot": ["--strip_annotations", "--plot", "OUT.svg"],
        "inat": ["--format", "inat"],
        "inat_aves": ["--format", "inat", "--supercategory", "Aves"],
    }[case]
    (tmp_path / "classes.txt").write_text("".join(f"{n.replace(' ', '_')} x\n"
                                                  for n in stripped[::-1]))
    (tmp_path / "names.txt").write_text("".join(f"{i + 1} {n}\n"
                                                for i, n in enumerate(stripped)))
    with open(tmp_path / "meta.pickle", "wb") as f:
        pickle.dump({b"fine_label_names": [n.encode() for n in stripped]}, f)
    source = str(_inat_file(tmp_path) if case.startswith("inat") else tree)
    outs = {}
    for name, module in (("jax", jencode), ("port", tencode)):
        argv = [a if not a.endswith(".txt") and not a.endswith(".pickle")
                else str(tmp_path / a) for a in extra]
        argv = [str(tmp_path / f"{name}.svg") if a == "OUT.svg" else a for a in argv]
        module.main([source, *argv, "--out", str(tmp_path / f"{name}.txt"),
                     "--out_names", str(tmp_path / f"{name}_names.txt")])
        outs[name] = (tmp_path / f"{name}.txt").read_text()
        if (tmp_path / f"{name}_names.txt").exists():
            outs[name] += (tmp_path / f"{name}_names.txt").read_text()
        if case == "plot":
            outs[name] += (tmp_path / f"{name}.svg").read_text()
    assert outs["port"] == outs["jax"] and outs["jax"]


def test_plot_hierarchy_writes_the_jax_svg(tmp_path):
    edges = tmp_path / "h.txt"
    edges.write_text("100 50\n100 51\n50 0\n50 1\n51 2\n51 3\n51 4\n")
    names = tmp_path / "names.txt"
    names.write_text("".join(f"{i} name <{i}> & more\n" for i in (0, 1, 2, 3, 4, 50, 51, 100)))
    for module, out in ((jplot, "j.svg"), (tplot, "t.svg")):
        module.main(["--hierarchy", str(edges), "--class_names", str(names),
                     "--out", str(tmp_path / out)])
    assert (tmp_path / "t.svg").read_bytes() == (tmp_path / "j.svg").read_bytes()
    assert b"&lt;0&gt; &amp; more" in (tmp_path / "t.svg").read_bytes()


@pytest.mark.parametrize("normalize,bins", [(False, None), (True, 10)])
def test_recall_precision_curves_match_jax(normalize, bins):
    """The curves and the mAP of ``plot_recall_precision`` equal the JAX
    package's on features with exact similarities (small integers)."""
    rng = np.random.default_rng(3)
    feats = rng.integers(-2, 3, (90, 6)).astype(np.float32)
    if normalize:  # rows of four entries +-1: unit rows of +-0.5, sums exact
        feats = np.zeros((90, 6), np.float32)
        for row in feats:
            row[rng.choice(6, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    labels = [int(c) for c in rng.integers(0, 5, 90)]
    dump = {int(i): f for i, f in enumerate(feats)}
    want, want_map = jrp.recall_precision_curves(dump, labels, normalize, bins, block_size=32)
    got, got_map = trp.recall_precision_curves(dump, labels, normalize, bins, block_size=32,
                                               device=CPU)
    assert sorted(got) == sorted(want)
    for level in want:
        np.testing.assert_allclose(got[level], want[level], rtol=0, atol=1e-12)
    assert abs(got_map - want_map) <= 1e-12


def test_plot_recall_precision_cli(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from semantic_embeddings_torch.embeddings import save_features

    rng = np.random.default_rng(4)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"f{i}.pickle"))
        save_features(paths[-1], rng.normal(size=(32, 8)).astype(np.float32))
    out = str(tmp_path / "curves.png")
    curves = trp.main(["--dataset", "synthetic-10-64-32", "--data_root", str(tmp_path),
                       "--feat", paths[0], "--feat", paths[1], "--label", "first",
                       "--norm", "true", "--bins", "20", "--out", out, "--device", "cpu"])
    assert sorted(curves) == ["f1", "first"] and "first: mAP" in capsys.readouterr().out
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(SystemExit, match="no CUDA device"):
            trp.main(["--dataset", "synthetic-10-64-32", "--data_root", str(tmp_path),
                      "--feat", paths[0]])


def test_compute_class_embedding_device_refused_without_a_gpu(tmp_path):
    """The factorizations run on the card by default, and on a bare
    ``--device`` (the JAX package's flag); with no GPU the CLI and the
    solvers raise, and nothing runs on the host in their place.  ``--device
    cpu`` runs host LAPACK."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal is that of a host without one")
    from semantic_embeddings_torch.cli import compute_class_embedding
    from semantic_embeddings_torch.embeddings import sim_approx, unitsphere_embedding

    edges = tmp_path / "h.txt"
    edges.write_text("10 0\n10 1\n10 2\n")
    out = tmp_path / "e.pickle"
    for device in ([], ["--device"], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            compute_class_embedding.main(["--hierarchy", str(edges), "--out", str(out),
                                          *device])
        assert not out.exists()
    for fn in (unitsphere_embedding, sim_approx):
        for device in ("cuda", CPU):
            with pytest.raises(RuntimeError, match="is not a CUDA device that is present"):
                fn(np.eye(3), device=device)
    compute_class_embedding.main(["--hierarchy", str(edges), "--out", str(out),
                                  "--device", "cpu"])
    assert out.exists()


def test_metrics_logger_matches_the_jax_logger(tmp_path):
    """The JSONL file is the JAX logger's, byte for byte; the TensorBoard
    events hold the JAX logger's ``epoch_<metric>`` scalars at each epoch."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    from semantic_embeddings_torch.cli.common import MetricsLogger
    from semantic_embeddings_tpu.cli.common import MetricsLogger as JMetricsLogger

    metrics = [{"loss": 1.5, "val_loss": np.float32(2.25)}, {"loss": 0.75, "val_loss": 1.0}]
    for cls, name in ((MetricsLogger, "port"), (JMetricsLogger, "jax")):
        logger = cls(str(tmp_path / name))
        for epoch, m in enumerate(metrics):
            logger(epoch, m)
    assert ((tmp_path / "port" / "metrics.jsonl").read_bytes()
            == (tmp_path / "jax" / "metrics.jsonl").read_bytes())
    port, jax_events = EventAccumulator(str(tmp_path / "port")), None
    port.Reload()
    assert sorted(port.Tags()["scalars"]) == ["epoch_loss", "epoch_val_loss"]
    if JMetricsLogger(str(tmp_path / "probe"))._tb is not None:  # tensorflow wrote events
        jax_events = EventAccumulator(str(tmp_path / "jax"))
        jax_events.Reload()
    for tag in ("epoch_loss", "epoch_val_loss"):
        got = [(s.step, s.value) for s in port.Scalars(tag)]
        assert got == [(e, float(m[tag[6:]])) for e, m in enumerate(metrics)]
        if jax_events is not None:
            want = [(t.step, float(tensor_util.make_ndarray(t.tensor_proto)))
                    for t in jax_events.Tensors(tag)]
            assert got == want
    again = MetricsLogger(str(tmp_path / "port"))  # the directory starts afresh
    assert not (tmp_path / "port" / "metrics.jsonl").exists() and again._tb is not None
