"""The port's exact top-k and retrieval evaluation against the JAX package's,
on the same inputs (numpy seeds), on the CPU.

Features are chosen so that every similarity is exact in f32 (small
integers; or rows of four entries +-1, whose normalized dot products are
multiples of 1/4), so that a GEMM summed in another order cannot flip a
rank: the rankings, ties included, must then be identical, and the metric
scalars agree to f32 rounding of the cumulative sums (1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from semantic_embeddings_tpu.evaluation import retrieval as jretrieval
from semantic_embeddings_tpu.hierarchy import ClassHierarchy as JClassHierarchy
from semantic_embeddings_tpu.ops.topk import exact_topk as jexact_topk
from semantic_embeddings_torch.evaluation import retrieval
from semantic_embeddings_torch.hierarchy import ClassHierarchy
from semantic_embeddings_torch.ops.topk import exact_topk, exact_topk_payload

CPU = torch.device("cpu")
METRIC_ATOL = 1e-6


def _ties(seed, b, n, values=5):
    return np.random.default_rng(seed).integers(0, values, (b, n)).astype(np.float32)


def _inf_heavy(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n)).astype(np.float32)
    x[rng.random((b, n)) < rng.uniform(0.3, 0.95)] = -np.inf
    x[:, int(n * 0.7):] = -np.inf
    return x


def _inf_rows(seed, b, n):
    """Whole rows of +inf, of -inf, and rows mixing both with ties."""
    x = _ties(seed, b, n, values=3)
    x[0] = np.inf
    x[1] = -np.inf
    x[2, ::3] = np.inf
    x[2, 1::3] = -np.inf
    return x


# (inputs, k, chunk): the JAX package's adversarial tie patterns and
# inf-heavy rows (tests/test_ops.py), k at and around the chunk edges
TOPK_CASES = {
    "ties-a": (_ties(1, 3, 2999), 260, 300),
    "ties-b": (_ties(2, 2, 1000), 7, 8),
    "ties-c": (_ties(3, 1, 517), 1, 64),
    "ties-two-values": (_ties(4, 4, 4097, values=2), 251, 2048),
    "k-equals-chunk": (_ties(5, 2, 1200), 128, 128),
    "k-one-under-chunk": (_ties(6, 2, 1200), 127, 128),
    "n-equals-chunk": (_ties(7, 2, 256), 40, 256),
    "n-one-over-chunk": (_ties(8, 2, 257), 40, 256),
    "k-equals-n": (_ties(9, 2, 300), 300, 64),
    "inf-heavy-a": (_inf_heavy(10, 2, 3000), 279, 1500),
    "inf-heavy-b": (_inf_heavy(11, 2, 401), 64, 64),
    "inf-rows": (_inf_rows(12, 4, 900), 100, 128),
    "normal": (np.random.default_rng(13).normal(size=(3, 5000)).astype(np.float32),
               251, 2048),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_exact_topk_matches_lax_top_k(name):
    """Values and indices bitwise equal to ``lax.top_k`` and to the JAX
    package's ``exact_topk``; the payload gather equals ``payload[i]``."""
    x, k, chunk = TOPK_CASES[name]
    v_ref, i_ref = (np.asarray(a) for a in lax.top_k(jnp.asarray(x), k))
    v_jax, i_jax = (np.asarray(a) for a in jexact_topk(jnp.asarray(x), k, chunk=chunk))
    v, i = exact_topk(torch.from_numpy(x), k, chunk=chunk)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_array_equal(i_jax, i_ref)
    payload = np.random.default_rng(0).integers(0, 9, x.shape[1])
    v2, p2 = exact_topk_payload(torch.from_numpy(x), torch.from_numpy(payload), k,
                                chunk=chunk)
    np.testing.assert_array_equal(v2.numpy(), v_ref)
    np.testing.assert_array_equal(p2.numpy(), payload[i_ref])


def test_exact_topk_k_too_large_raises():
    with pytest.raises(ValueError, match="k=9"):
        exact_topk(torch.zeros((1, 4)), 9)


def _taxonomy(tmp_path):
    """12 leaves 0..11 under 4 superclasses 50..53 under root 100."""
    path = tmp_path / "taxonomy.txt"
    lines = []
    for s in range(4):
        lines.append(f"100 {50 + s}")
        lines += [f"{50 + s} {3 * s + leaf}" for leaf in range(3)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _features(normalize, n=300, d=8, seed=0):
    """Exact-similarity features: small integers, or (for normalize) rows
    with four entries +-1 (norm 2)."""
    rng = np.random.default_rng(seed)
    if not normalize:
        return rng.integers(-3, 4, (n, d)).astype(np.float32)
    feats = np.zeros((n, d), np.float32)
    for row in feats:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    return feats


def _labels(n=300, seed=1):
    return [int(c) for c in np.random.default_rng(seed).integers(0, 12, n)]


PROTOCOLS = {
    # the full ranking: P@k, AHP over all ranks and AP
    "full": dict(ks=(1, 5, 10, 50), compute_ahp=True, compute_ap=True),
    # the prefix protocol: P@k and AHP@20 through the exact top-k
    "prefix": dict(ks=(1, 5, 10), compute_ahp=20, compute_ap=False),
}


def _assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert abs(got[name] - want[name]) <= METRIC_ATOL, (name, got[name], want[name])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_evaluate_retrieval_features_matches_jax(tmp_path, normalize, protocol):
    path = _taxonomy(tmp_path)
    feats, labels = _features(normalize), _labels()
    kwargs = dict(PROTOCOLS[protocol], normalize=normalize, block_size=128)
    want, want_q = jretrieval.evaluate_retrieval_features(
        feats, labels, JClassHierarchy.from_file(path, id_type=int), **kwargs)
    got, got_q = retrieval.evaluate_retrieval_features(
        feats, labels, ClassHierarchy.from_file(path, id_type=int), device=CPU, **kwargs)
    _assert_metrics_close(got, want)
    for name in want_q:
        assert list(got_q[name]) == list(want_q[name])
        np.testing.assert_allclose(list(got_q[name].values()),
                                   list(want_q[name].values()), rtol=0, atol=1e-5)
    if protocol == "prefix":  # the same means through the full sort
        full, _ = retrieval.evaluate_retrieval_features(
            feats, labels, ClassHierarchy.from_file(path, id_type=int), device=CPU,
            ks=(1, 5, 10), compute_ahp=20, compute_ap=True, normalize=normalize)
        for name in got:
            assert abs(full[name] - got[name]) <= METRIC_ATOL, name


@pytest.mark.parametrize("n", [12, 40, 100])
def test_ks_past_the_ranking_clamp_as_jax(tmp_path, n):
    """P@k for a k past the ranking's N - 1 entries reads P@(N - 1), as the
    JAX package's gather clamps (both CLIs always ask for k = 100)."""
    path = _taxonomy(tmp_path)
    feats = _features(False, n=n)
    # every one of the 12 classes present, so no optimal curve is zero
    labels = [int(c) for c in np.random.default_rng(1).permutation(np.arange(n) % 12)]
    kwargs = dict(ks=(1, 10, 50, 100), compute_ahp=True, compute_ap=True)
    want, want_q = jretrieval.evaluate_retrieval_features(
        feats, labels, JClassHierarchy.from_file(path, id_type=int), **kwargs)
    got, got_q = retrieval.evaluate_retrieval_features(
        feats, labels, ClassHierarchy.from_file(path, id_type=int), device=CPU, **kwargs)
    _assert_metrics_close(got, want)
    for name in want_q:
        np.testing.assert_allclose(list(got_q[name].values()),
                                   list(want_q[name].values()), rtol=0, atol=1e-6)
    assert got["P@100 (WUP)"] == got["P@50 (WUP)"] or n > 50


def test_dict_features_pair_labels_by_id(tmp_path):
    """A dump keyed by non-ascending ids pairs labels by id, not by row."""
    path = _taxonomy(tmp_path)
    feats, labels = _features(False), _labels()
    ids = np.random.default_rng(2).permutation(len(feats))
    dump = {int(i): feats[i] for i in ids}
    want, want_q = jretrieval.evaluate_retrieval_features(
        dump, labels, JClassHierarchy.from_file(path, id_type=int), block_size=128)
    got, got_q = retrieval.evaluate_retrieval_features(
        dump, labels, ClassHierarchy.from_file(path, id_type=int), block_size=128,
        device=CPU)
    _assert_metrics_close(got, want)
    assert list(got_q["AP"]) == [int(i) for i in ids]
    # the same as the rows in dump order with their labels taken by id
    rows, _ = retrieval.evaluate_retrieval_features(
        feats[ids], [labels[i] for i in ids], ClassHierarchy.from_file(path, id_type=int),
        block_size=128, device=CPU)
    assert rows == got


def test_short_labels_raise(tmp_path):
    path = _taxonomy(tmp_path)
    with pytest.raises(ValueError, match="labels has 299 entries for 300"):
        retrieval.evaluate_retrieval_features(
            _features(False), _labels()[:-1], ClassHierarchy.from_file(path, id_type=int),
            device=CPU)


@pytest.mark.parametrize("normalize", [False, True])
def test_pairwise_retrieval_matches_jax(normalize):
    feats = _features(normalize, n=150)
    dump = {int(i) + 1000: f for i, f in enumerate(feats)}
    want = jretrieval.pairwise_retrieval(dump, normalize, return_generator=False)
    got = retrieval.pairwise_retrieval(dump, normalize, return_generator=False,
                                       device=CPU)
    assert list(got) == list(want)
    for q in want:
        assert [int(i) for i in got[q]] == [int(i) for i in want[q]], q
        assert got[q][0] == q  # the query is pinned to rank 0


def test_ranking_blocks_are_stable_with_the_query_first():
    """Ties keep database order after the query."""
    feats = np.zeros((5, 3), np.float32)  # every similarity ties
    blocks = list(retrieval.pairwise_ranking_blocks(feats, block_size=2, device=CPU))
    assert [s for s, _ in blocks] == [0, 2, 4]
    rows = np.concatenate([b for _, b in blocks])
    for q, row in enumerate(rows):
        assert row.tolist() == [q] + [i for i in range(5) if i != q]


def test_default_block_size_follows_the_2gb_rule():
    assert retrieval.default_block_size(10_000) == 8192
    assert retrieval.default_block_size(50_000) == 8192
    assert retrieval.default_block_size(200_000) == 2048
    assert retrieval.default_block_size(10_000_000) == 1024
