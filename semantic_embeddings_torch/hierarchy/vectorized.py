"""Dense pairwise class-similarity matrices from a taxonomy.

The port's own copy of ``semantic_embeddings_tpu/hierarchy/vectorized.py``:
host numpy, and :func:`pairwise_matrices_device`, whose one GEMM for large
trees runs on the card through ``torch``.

The original implementation computes pairwise LCS-height / Wu-Palmer values
with an O(n^2) Python loop over memoized per-pair recursions
(its ``compute_class_embedding.py:211-214`` and
``class_hierarchy.py:123-208``).  Here the whole n x n matrix
is assembled from a few *blocked boolean matrix products*: ancestors are
grouped by their (depth, height) signature, and for each group — processed in
decreasing LCS-preference order — one rank-|group| GEMM decides which class
pairs have their lowest common subsumer in that group.  The GEMMs run on BLAS
on the host, turning the taxonomy precompute from minutes of pointer chasing
into a handful of matmuls.
"""

from __future__ import annotations

import numpy as np

_BIG = 2 ** 30


def _class_ancestor_arrays(hierarchy, classes):
    """Per-class ancestor mask / distance arrays over the ancestor union.

    Returns ``(mask, dist, anc_nodes)`` where ``mask`` is (n_classes, U) bool,
    ``dist`` is (n_classes, U) int32 (min edge distance, _BIG if not an
    ancestor) and ``anc_nodes`` lists the node indices forming the union U.
    """
    idx = [hierarchy._node_index[c] for c in classes]
    anc_maps = [hierarchy._ancestors(i) for i in idx]

    union = {}
    for m in anc_maps:
        for a in m:
            if a not in union:
                union[a] = len(union)
    anc_nodes = np.fromiter(union.keys(), dtype=np.int64, count=len(union))

    n, u = len(classes), len(union)
    mask = np.zeros((n, u), dtype=bool)
    dist = np.full((n, u), _BIG, dtype=np.int32)
    for row, m in enumerate(anc_maps):
        cols = np.fromiter((union[a] for a in m), dtype=np.int64, count=len(m))
        mask[row, cols] = True
        dist[row, cols] = np.fromiter(m.values(), dtype=np.int32, count=len(m))
    return mask, dist, anc_nodes


def pairwise_matrices_device(hierarchy, classes, dtype=np.float64, device="cuda"):
    """Device variant of :func:`pairwise_matrices` for large trees (the JAX
    package's ``pairwise_matrices_device``), on the card unless ``device``
    says otherwise.

    Key identity: in a (single-root) tree the common ancestors of two nodes
    are exactly the chain root..LCS, so ``depth(LCS) = |anc(i) & anc(j)| =
    (M @ M.T)[i, j]`` with M the boolean ancestor matrix: the whole
    LCS-depth matrix is ONE f32 GEMM (``torch.matmul``; exact, the counts
    are small integers).  Heights then come from a per-class ancestor-chain
    table gathered at that depth (``take_along_dim``); ``lcs_height`` and
    ``wup`` are computed in f32, as the JAX package computes them, and cast
    to ``dtype``.  DAGs fall back to the host grouped-GEMM path.
    """
    if not hierarchy.is_tree():
        return pairwise_matrices(hierarchy, classes, dtype=dtype)

    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"pairwise_matrices_device: no CUDA device for {device}")
    mask, _, anc_nodes = _class_ancestor_arrays(hierarchy, classes)
    node_depth = hierarchy._depth_max_arr[anc_nodes].astype(np.int32)
    node_height = hierarchy._height_arr[anc_nodes].astype(np.int32)
    max_height = hierarchy.max_height
    n, _ = mask.shape

    # Per-class ancestor chain ordered by depth: chain_height[i, d-1] =
    # height of class i's ancestor at depth d.
    max_depth = int(node_depth.max())
    chain_height = np.zeros((n, max_depth), dtype=np.float32)
    for i in range(n):
        cols = np.flatnonzero(mask[i])
        chain_height[i, node_depth[cols] - 1] = node_height[cols]

    class_depth = hierarchy._depth_max_arr[
        [hierarchy._node_index[c] for c in classes]
    ].astype(np.float32)

    maskf = torch.from_numpy(mask.astype(np.float32)).to(device)
    chain_h = torch.from_numpy(chain_height).to(device)
    cdepth = torch.from_numpy(class_depth).to(device)
    counts = torch.matmul(maskf, maskf.T)
    lcs_depth = counts  # tree identity: |common ancestors| = depth(LCS)
    idx = torch.clamp(lcs_depth.to(torch.int64) - 1, 0, chain_h.shape[1] - 1)
    # heights[i, j] = chain_h[i, idx[i, j]] (the LCS lies on both chains)
    heights = torch.take_along_dim(chain_h, idx, dim=1)
    # by a tensor: a CUDA division by a Python number multiplies by its
    # reciprocal, which rounds otherwise than the CPU's (and XLA's) division
    lcs_h = heights / torch.tensor(float(max_height), device=device)
    wup = (2.0 * lcs_depth) / (cdepth[:, None] + cdepth[None, :])
    if float(counts.min()) < 1:
        raise ValueError(
            "Some class pairs share no common hypernym; the hierarchy has "
            "multiple disconnected roots covering the requested classes."
        )
    return {
        "lcs_height": lcs_h.cpu().numpy().astype(dtype),
        "wup": wup.cpu().numpy().astype(dtype),
    }


def pairwise_matrices(hierarchy, classes, compute_wup=True, dtype=np.float64):
    """Computes dense pairwise semantic matrices for a list of class labels.

    Parameters
    ----------
    hierarchy:
        A :class:`~semantic_embeddings_torch.hierarchy.ClassHierarchy`.
    classes:
        Sequence of class labels (hierarchy nodes) defining row/column order.
    compute_wup:
        Also compute the Wu-Palmer similarity matrix.

    Returns
    -------
    dict with keys
      - ``lcs_height``: (n, n) normalized LCS-height *dissimilarity* matrix
        (``class_hierarchy.py:199-208`` semantics).
      - ``wup``: (n, n) Wu-Palmer *similarity* matrix (if requested).
    """
    n = len(classes)
    mask, dist, anc_nodes = _class_ancestor_arrays(hierarchy, classes)
    depth = hierarchy._depth_max_arr[anc_nodes].astype(np.int64)
    height = hierarchy._height_arr[anc_nodes].astype(np.int64)
    max_height = hierarchy.max_height

    # LCS preference: maximize depth, then (tie-break, DAGs only) minimize
    # height.  Encode both into one sortable score per ancestor.
    hspan = int(height.max()) + 2
    score = depth * hspan + (hspan - 1 - height)

    lcs_h = np.full((n, n), -1.0, dtype=dtype)
    wup = np.full((n, n), 0.0, dtype=dtype) if compute_wup else None
    lcs_depth = np.zeros((n, n), dtype=np.int64)
    remaining = np.ones((n, n), dtype=bool)

    tree = hierarchy.is_tree()
    maskf = mask.astype(np.float32)
    order = np.argsort(-score, kind="stable")
    groups = np.split(order, np.flatnonzero(np.diff(score[order]) != 0) + 1)

    routed = None
    if compute_wup and not tree:
        # Routed class->node distances, reference shortest_path semantics
        # (class_hierarchy.py:143-156): R[i, u] = min over ancestors h of u
        # of dist(i, h) + dist(u, h) — on a DAG this can undercut the
        # direct upward distance by routing through a shallower hypernym.
        union_col = {int(node): i for i, node in enumerate(anc_nodes)}
        routed = np.empty_like(dist, dtype=np.int64)
        dist64 = dist.astype(np.int64)
        for col, node in enumerate(anc_nodes):
            anc_u = hierarchy._ancestors(int(node))
            cols_u = np.fromiter((union_col[h] for h in anc_u),
                                 dtype=np.int64, count=len(anc_u))
            d_u = np.fromiter(anc_u.values(), dtype=np.int64,
                              count=len(anc_u))
            routed[:, col] = (dist64[:, cols_u] + d_u[None, :]).min(axis=1)

    for cols in groups:
        if not remaining.any():
            break
        g_depth = int(depth[cols[0]])
        g_height = int(height[cols[0]])
        mg = maskf[:, cols]
        shared = (mg @ mg.T) > 0.5
        newly = shared & remaining
        if not newly.any():
            remaining &= ~shared
            continue
        lcs_h[newly] = g_height / max_height
        lcs_depth[newly] = g_depth
        if compute_wup and not tree:
            # Per-pair LCS pick identical to the scalar API's tie-break
            # (_lcs_idx: max depth, min height, then MIN NODE INDEX): walk
            # the group's nodes in ascending index and assign each pair at
            # its first common node, with the reference WUP formula
            # 2 ds / (2 ds + routed(i, lcs) + routed(j, lcs)).
            cols_by_index = cols[np.argsort(anc_nodes[cols], kind="stable")]
            group_pending = newly.copy()
            for u in cols_by_index:
                if not group_pending.any():
                    break
                pu = mask[:, u]
                pairs = group_pending & np.logical_and.outer(pu, pu)
                if not pairs.any():
                    continue
                ru = routed[:, u]
                wup[pairs] = (2.0 * g_depth) / (
                    2.0 * g_depth + (ru[:, None] + ru[None, :])[pairs]
                )
                group_pending &= ~pairs
        remaining &= ~shared

    if remaining.any():
        raise ValueError(
            "Some class pairs share no common hypernym; the hierarchy has "
            "multiple disconnected roots covering the requested classes."
        )

    if compute_wup and tree:
        # In a tree, dist(x, lcs) = depth(x) - depth(lcs), so WUP reduces to
        # 2*d_lcs / (depth_i + depth_j) with global depths.
        class_depth = hierarchy._depth_max_arr[
            [hierarchy._node_index[c] for c in classes]
        ].astype(np.int64)
        wup = (2.0 * lcs_depth) / (class_depth[:, None] + class_depth[None, :])
        wup = wup.astype(dtype)

    out = {"lcs_height": lcs_h}
    if compute_wup:
        out["wup"] = wup
    return out


def semantic_distance_matrix(hierarchy, classes, dtype=np.float64):
    """The target dissimilarity matrix used by the embedding CLI.

    Equivalent to the original implementation's double loop
    (``compute_class_embedding.py:211-214``; zero diagonal for
    leaf classes since leaves have height 0).
    """
    return pairwise_matrices(hierarchy, classes, compute_wup=False, dtype=dtype)[
        "lcs_height"
    ]
