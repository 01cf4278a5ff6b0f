"""The port's own taxonomy math against the JAX package's.

``semantic_embeddings_torch.hierarchy`` (and the hierarchical precision in
``semantic_embeddings_torch.evaluation``) are copies of the JAX package's
numpy-only modules; on the same taxonomy, made here from a seed, both must
give equal results.  Everything is exact integer or f64 arithmetic in the
same order, so the tolerance is 0 (equality), except where stated.
"""

import numpy as np
import pytest

from semantic_embeddings_torch.hierarchy import ClassHierarchy, pairwise_matrices
from semantic_embeddings_torch.hierarchy import semantic_distance_matrix
from semantic_embeddings_tpu.hierarchy import ClassHierarchy as JClassHierarchy
from semantic_embeddings_tpu.hierarchy import pairwise_matrices as jpairwise_matrices
from semantic_embeddings_tpu.hierarchy import semantic_distance_matrix as jsemantic_distance_matrix

KINDS = ["tree", "dag"]


def write_taxonomy(path, kind, n_nodes=60, seed=0):
    """A random taxonomy rooted at node 0: each node i > 0 hangs under a
    random earlier node.  ``tree`` writes ``parent child`` lines; ``dag``
    gives every fourth node a second earlier parent and writes ``child
    parent`` (is_a) lines.  Returns the file's path."""
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(1, n_nodes):
        parent = int(rng.integers(0, max(1, i // 2)))
        edges.append((parent, i))
        if kind == "dag" and i % 4 == 0 and i > 2:
            other = int(rng.integers(0, i))
            if other != parent:
                edges.append((other, i))
    with open(path, "w") as f:
        for parent, child in edges:
            f.write(f"{child} {parent}\n" if kind == "dag" else f"{parent} {child}\n")
    return path


@pytest.fixture(params=KINDS)
def taxonomies(request, tmp_path):
    kind = request.param
    path = str(write_taxonomy(tmp_path / f"{kind}.txt", kind))
    is_a = kind == "dag"
    return (kind, ClassHierarchy.from_file(path, is_a_relations=is_a, id_type=int),
            JClassHierarchy.from_file(path, is_a_relations=is_a, id_type=int))


def test_structure_matches(taxonomies):
    kind, ours, theirs = taxonomies
    assert ours.is_tree() == theirs.is_tree() == (kind == "tree")
    assert ours.leaves() == theirs.leaves()
    assert ours.max_height == theirs.max_height
    assert ours.heights == theirs.heights
    for node in sorted(ours.nodes):
        for use_min in (False, True):
            assert ours.depth(node, use_min) == theirs.depth(node, use_min)


def test_pair_queries_match(taxonomies):
    """lcs (both depth rules), lcs_height and wup_similarity on 200 node
    pairs drawn from a seed, leaves and inner nodes alike."""
    _, ours, theirs = taxonomies
    nodes = sorted(ours.nodes)
    rng = np.random.default_rng(1)
    for a, b in rng.choice(nodes, size=(200, 2)):
        a, b = int(a), int(b)
        for use_min in (False, True):
            assert ours.lcs(a, b, use_min) == theirs.lcs(a, b, use_min)
        assert ours.lcs_height(a, b) == theirs.lcs_height(a, b)
        assert ours.wup_similarity(a, b) == theirs.wup_similarity(a, b)


def test_pairwise_matrices_device_matches_jax_bitwise(taxonomies):
    """``pairwise_matrices_device`` on the CPU (``device="cpu"``) against
    the JAX package's (XLA on the CPU): the f32 GEMM of the ancestor masks,
    the gathered heights and the f32 divisions give bitwise equal matrices
    on a tree; a DAG takes the host path in both.  Within 1e-7 of the host
    path's f64 matrices."""
    from semantic_embeddings_torch.hierarchy.vectorized import pairwise_matrices_device
    from semantic_embeddings_tpu.hierarchy.vectorized import (
        pairwise_matrices_device as jpairwise_matrices_device,
    )

    kind, ours, theirs = taxonomies
    leaves = sorted(ours.leaves())
    got = pairwise_matrices_device(ours, leaves, device="cpu")
    want = jpairwise_matrices_device(theirs, leaves)
    host = pairwise_matrices(ours, leaves)
    for key in ("lcs_height", "wup"):
        assert got[key].dtype == want[key].dtype == np.float64
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got[key], host[key], rtol=0, atol=1e-7)


def test_pairwise_matrices_device_refuses_disconnected_roots(tmp_path):
    """Two trees: pairs across them share no hypernym, and both packages
    say so with the same message."""
    from semantic_embeddings_torch.hierarchy.vectorized import pairwise_matrices_device
    from semantic_embeddings_tpu.hierarchy.vectorized import (
        pairwise_matrices_device as jpairwise_matrices_device,
    )

    path = tmp_path / "forest.txt"
    path.write_text("0 1\n0 2\n10 11\n10 12\n")
    ours = ClassHierarchy.from_file(str(path), id_type=int)
    theirs = JClassHierarchy.from_file(str(path), id_type=int)
    with pytest.raises(ValueError) as got:
        pairwise_matrices_device(ours, [1, 2, 11, 12], device="cpu")
    with pytest.raises(ValueError) as want:
        jpairwise_matrices_device(theirs, [1, 2, 11, 12])
    assert str(got.value) == str(want.value)
    assert "multiple disconnected roots" in str(got.value)


def test_dense_matrices_match(taxonomies):
    _, ours, theirs = taxonomies
    leaves = sorted(ours.leaves())
    np.testing.assert_array_equal(semantic_distance_matrix(ours, leaves),
                                  jsemantic_distance_matrix(theirs, leaves))
    mine, ref = pairwise_matrices(ours, leaves), jpairwise_matrices(theirs, leaves)
    assert set(mine) == set(ref) == {"lcs_height", "wup"}
    for key in mine:
        np.testing.assert_array_equal(mine[key], ref[key])


@pytest.mark.parametrize("ignore_qids", [True, False])
@pytest.mark.parametrize("ks", [(1, 5, 20), 10])
def test_hierarchical_precision_matches(taxonomies, ignore_qids, ks):
    """Rankings by noisy class similarity over 5 images of each of the
    first 12 leaves; means and per-query values agree to 1e-12 (f64 sums
    of the same terms in the same order, so in practice exactly)."""
    _, ours, theirs = taxonomies
    classes = sorted(ours.leaves())[:12]
    labels = {i: c for i, c in enumerate(np.repeat(classes, 5).tolist())}
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(len(labels), 8))
    for i, c in labels.items():
        feats[i, c % 8] += 2.0
    sims = feats @ feats.T
    retrieved = {q: list(np.argsort(-sims[q], kind="stable")) for q in labels}
    kwargs = dict(ks=ks, compute_ahp=True, compute_ap=True, ignore_qids=ignore_qids)
    means, per_query = ours.hierarchical_precision(retrieved, labels, **kwargs)
    ref_means, ref_per_query = theirs.hierarchical_precision(retrieved, labels, **kwargs)
    assert means.keys() == ref_means.keys()
    for name in means:
        np.testing.assert_allclose(means[name], ref_means[name], rtol=0, atol=1e-12)
        assert per_query[name].keys() == ref_per_query[name].keys()
        np.testing.assert_allclose(list(per_query[name].values()),
                                   list(ref_per_query[name].values()), rtol=0, atol=1e-12)
