"""The port's own class-embedding solvers, pickle I/O and
``compute_class_embedding`` CLI against the JAX package's.

Both are host numpy in f64; on the same taxonomy (made here from a seed)
the solvers and the two CLIs agree to 1e-12 (LAPACK on the same matrices,
so in practice exactly), and each package reads what the other writes.
"""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import pickle

import numpy as np
import pytest

from semantic_embeddings_torch import embeddings as E
from semantic_embeddings_torch.cli import compute_class_embedding as cli
from semantic_embeddings_torch.hierarchy import ClassHierarchy, semantic_distance_matrix
from semantic_embeddings_tpu import embeddings as JE
from semantic_embeddings_tpu.cli import compute_class_embedding as jcli

from test_torch_hierarchy import write_taxonomy

TOL = dict(rtol=0, atol=1e-12)


@pytest.fixture
def tree_path(tmp_path):
    return str(write_taxonomy(tmp_path / "tree.txt", "tree", n_nodes=40, seed=3))


@pytest.fixture
def distances(tree_path):
    """lcs_height between the tree's leaves: an ultrametric, so every
    solver's placement exists."""
    h = ClassHierarchy.from_file(tree_path, id_type=int)
    return semantic_distance_matrix(h, sorted(h.leaves()))


@pytest.mark.parametrize("solver, args", [
    ("unitsphere_embedding", ()),
    ("sim_approx", ()),
    ("sim_approx", (5,)),
    ("mds", ()),
    ("mds", (4,)),
    ("euclidean_embedding", ()),
])
def test_solvers_match(distances, solver, args):
    """unitsphere and sim_approx take the similarity 1 - d; mds and the
    hypersphere placement the distance d."""
    target = 1.0 - distances if solver in ("unitsphere_embedding", "sim_approx") else distances
    ours = getattr(E, solver)(target, *args)
    theirs = getattr(JE, solver)(target, *args)
    assert ours.dtype == theirs.dtype == np.float64
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, **TOL)


@pytest.mark.parametrize("labels", [[3, 1, 2], ["b", "a", "c"]])
def test_embedding_pickles_round_trip(tmp_path, labels):
    emb = np.random.default_rng(4).normal(size=(3, 5))
    for save, load in ((E.save_embeddings, JE.load_embeddings),
                       (JE.save_embeddings, E.load_embeddings),
                       (E.save_embeddings, E.load_embeddings)):
        path = str(tmp_path / "e.pickle")
        save(path, labels, emb)
        got_labels, got = load(path)
        assert got_labels == labels
        np.testing.assert_array_equal(got, emb)
        with open(path, "rb") as f:
            assert pickle.load(f)["label2ind"] == {lbl: i for i, lbl in enumerate(labels)}


def test_feature_pickles_round_trip(tmp_path):
    feats = np.random.default_rng(5).normal(size=(7, 4)).astype(np.float32)
    for save, load in ((E.save_features, JE.load_features),
                       (JE.save_features, E.load_features)):
        path = str(tmp_path / "f.pickle")
        save(path, feats)
        ids, got = load(path)
        np.testing.assert_array_equal(ids, np.arange(7))
        np.testing.assert_array_equal(got, feats)
    ids, got = E.load_features(feats)
    assert ids is None
    np.testing.assert_array_equal(got, feats)


@pytest.mark.parametrize("flags", [
    ["--method", "unitsphere"],
    ["--method", "approx_sim", "--num_dim", "6", "--norm"],
    ["--method", "spheres"],
    ["--method", "mds", "--num_dim", "5"],
    ["--method", "unitsphere", "--class_list", "CLASSES"],
    ["--method", "mds", "--is_a"],
])
def test_clis_match(tmp_path, tree_path, flags, capsys):
    """The two CLIs on one taxonomy: the same ind2label, label2ind and
    embedding within 1e-12.  ``--is_a`` reads the DAG variant."""
    flags = list(flags)
    hierarchy = tree_path
    if "--is_a" in flags:
        hierarchy = str(write_taxonomy(tmp_path / "dag.txt", "dag", n_nodes=40, seed=3))
    if "CLASSES" in flags:
        leaves = sorted(ClassHierarchy.from_file(tree_path, id_type=int).leaves())
        (tmp_path / "classes.txt").write_text(
            "".join(f"{c} extra\n" for c in leaves[::-2]))
        flags[flags.index("CLASSES")] = str(tmp_path / "classes.txt")
    dumps = []
    # the port factors on the card unless --device cpu; the JAX CLI on the host
    # unless its --device flag is given
    for main, name, device in ((cli.main, "ours", ["--device", "cpu"]),
                               (jcli.main, "theirs", [])):
        out = str(tmp_path / f"{name}.pickle")
        main(["--hierarchy", hierarchy, "--out", out] + flags + device)
        with open(out, "rb") as f:
            dumps.append(pickle.load(f))
    ours, theirs = dumps
    assert ours["ind2label"] == theirs["ind2label"]
    assert ours["label2ind"] == theirs["label2ind"]
    np.testing.assert_allclose(ours["embedding"], theirs["embedding"], **TOL)
    assert "Computed" in capsys.readouterr().out
