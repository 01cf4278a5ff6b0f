"""Array-backed class taxonomy (tree or DAG).

The port's own copy of ``semantic_embeddings_tpu/hierarchy/class_hierarchy.py``
(host numpy; the port imports nothing of that package).

Capability parity with the original implementation's ``ClassHierarchy``
(its ``class_hierarchy.py:7-367``), re-designed for array math: nodes are mapped to dense integer indices once, global node
properties (height, depth) are computed with iterative topological passes, and
per-node ancestor information is kept as small integer dictionaries so that
the vectorized pairwise-matrix builder (``semantic_embeddings_torch.hierarchy.
vectorized``) can assemble dense (n_classes x n_classes) similarity matrices
with a handful of blocked matrix products instead of O(n^2) memoized
recursions.

Conventions (identical to the reference):

- *height* of a node: length in edges of the longest downward path to a leaf
  (leaves have height 0); ``max_height`` is the height of the highest node.
- *depth* of a node: 1 + length of the longest (or, optionally, shortest)
  upward path to a root; roots have depth 1.
- LCS(a, b): the common hypernym of maximum depth (``class_hierarchy.py:123``).
- ``lcs_height(a, b)``: height(LCS) / max_height — a dissimilarity in [0, 1]
  (``class_hierarchy.py:199``).
- ``wup_similarity(a, b)``: 2*d / (d + dist(a,lcs) + d + dist(b,lcs)) with
  d = depth(LCS) and dist measured in minimum edge count
  (``class_hierarchy.py:179``).
"""

from __future__ import annotations

import numpy as np


_BIG = np.int32(2 ** 30)


class ClassHierarchy:
    """A class taxonomy supporting similarity queries and retrieval metrics.

    Parameters
    ----------
    parents:
        Mapping from a class label to the list of its parent labels.
    children:
        Mapping from a class label to the list of its child labels.
    """

    def __init__(self, parents, children):
        self.parents = parents
        self.children = children
        self.nodes = set(parents.keys()) | set(children.keys())

        # Dense integer indexing of nodes.  Iteration order of the input dicts
        # is preserved first (parents, then children keys) so indexing is
        # deterministic for a given edge file.
        self._node_list = []
        self._node_index = {}
        for label in list(parents.keys()) + list(children.keys()):
            if label not in self._node_index:
                self._node_index[label] = len(self._node_list)
                self._node_list.append(label)
        n = len(self._node_list)

        self._parent_idx = [
            [self._node_index[p] for p in parents.get(label, ())]
            for label in self._node_list
        ]
        self._child_idx = [
            [self._node_index[c] for c in children.get(label, ())]
            for label in self._node_list
        ]

        self._height_arr = self._longest_path_down()
        self._depth_max_arr = self._depth_arr(use_min=False)
        self._depth_min_arr = None  # computed lazily
        self.max_height = int(self._height_arr.max()) if n else 0

        # Reference-compatible dict view of node heights.
        self.heights = {
            label: int(self._height_arr[i]) for i, label in enumerate(self._node_list)
        }

        # label -> {ancestor_idx: min_edge_distance}; memoized, computed in
        # topological order on demand.
        self._anc_cache = {}

    # ------------------------------------------------------------------
    # Construction / IO
    # ------------------------------------------------------------------

    @classmethod
    def from_file(cls, rel_file, is_a_relations=False, id_type=str):
        """Parses a text file of ``parent child`` (or ``child parent``) tuples.

        Mirrors ``class_hierarchy.py:337-367``.
        """
        parents, children = {}, {}
        with open(rel_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                first, second = (id_type(tok) for tok in line.split(maxsplit=1))
                parent, child = (second, first) if is_a_relations else (first, second)
                parents.setdefault(child, []).append(parent)
                children.setdefault(parent, []).append(child)
        return cls(parents, children)

    def save(self, filename, is_a_relations=False):
        """Writes the hierarchy as lines of tuples (``class_hierarchy.py:319``)."""
        with open(filename, "w") as f:
            if is_a_relations:
                for child, ps in self.parents.items():
                    f.writelines(f"{child} {p}\n" for p in ps)
            else:
                for parent, cs in self.children.items():
                    f.writelines(f"{parent} {c}\n" for c in cs)

    # ------------------------------------------------------------------
    # Global node properties (iterative topological DP)
    # ------------------------------------------------------------------

    def _longest_path_down(self):
        """Height of every node: longest edge-path to a leaf, leaves = 0."""
        n = len(self._node_list)
        heights = np.zeros(n, dtype=np.int32)
        # Kahn-style: process nodes whose children are all done.
        pending_children = np.array(
            [len(c) for c in self._child_idx], dtype=np.int64
        )
        stack = [i for i in range(n) if pending_children[i] == 0]
        while stack:
            i = stack.pop()
            for p in self._parent_idx[i]:
                if heights[i] + 1 > heights[p]:
                    heights[p] = heights[i] + 1
                pending_children[p] -= 1
                if pending_children[p] == 0:
                    stack.append(p)
        return heights

    def _depth_arr(self, use_min):
        """Depth of every node (roots = 1); longest or shortest root path."""
        n = len(self._node_list)
        depth = np.ones(n, dtype=np.int32)
        pending_parents = np.array(
            [len(p) for p in self._parent_idx], dtype=np.int64
        )
        stack = [i for i in range(n) if pending_parents[i] == 0]
        if use_min:
            depth[:] = _BIG
            for i in stack:
                depth[i] = 1
        while stack:
            i = stack.pop()
            for c in self._child_idx[i]:
                cand = depth[i] + 1
                if use_min:
                    if cand < depth[c]:
                        depth[c] = cand
                else:
                    if cand > depth[c]:
                        depth[c] = cand
                pending_parents[c] -= 1
                if pending_parents[c] == 0:
                    stack.append(c)
        return depth

    # ------------------------------------------------------------------
    # Structure queries
    # ------------------------------------------------------------------

    def is_tree(self):
        """True iff no node has more than one parent (``class_hierarchy.py:46``)."""
        return all(len(ps) <= 1 for ps in self.parents.values())

    def leaves(self):
        """Labels of all nodes without children."""
        return [
            label
            for label in self.nodes
            if label not in self.children or not self.children[label]
        ]

    def depth(self, label, use_min_depth=False):
        """Depth of a node; roots have depth 1 (``class_hierarchy.py:159``)."""
        i = self._node_index[label]
        if use_min_depth:
            if self._depth_min_arr is None:
                self._depth_min_arr = self._depth_arr(use_min=True)
            return int(self._depth_min_arr[i])
        return int(self._depth_max_arr[i])

    def _ancestors(self, idx):
        """``{ancestor_idx: min_edge_distance}`` incl. the node itself (dist 0).

        Iterative with memoization; equivalent information to the reference's
        ``all_hypernym_distances`` (``class_hierarchy.py:81``) plus, combined
        with the global depth array, ``all_hypernym_depths``.
        """
        cached = self._anc_cache.get(idx)
        if cached is not None:
            return cached
        # Resolve dependencies iteratively (post-order over the parent DAG).
        order, stack, visiting = [], [(idx, False)], set()
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if node in self._anc_cache or node in visiting:
                continue
            visiting.add(node)
            stack.append((node, True))
            for p in self._parent_idx[node]:
                if p not in self._anc_cache:
                    stack.append((p, False))
        for node in order:
            if node in self._anc_cache:
                continue
            dists = {node: 0}
            for p in self._parent_idx[node]:
                for anc, d in self._anc_cache[p].items():
                    nd = d + 1
                    if anc not in dists or nd < dists[anc]:
                        dists[anc] = nd
            self._anc_cache[node] = dists
        return self._anc_cache[idx]

    # ------------------------------------------------------------------
    # Pairwise queries (scalar API; the matrix API lives in `vectorized`)
    # ------------------------------------------------------------------

    def _lcs_idx(self, ia, ib):
        """Index of the max-depth common hypernym, or -1 if none exists.

        Ties in depth are broken towards the smaller height and then the
        smaller node index (deterministic; on trees the LCS is unique, so
        this only matters for multi-parent DAGs where the reference's pick
        among equally deep subsumers is itself unspecified).
        """
        anc_a = self._ancestors(ia)
        anc_b = self._ancestors(ib)
        if len(anc_b) < len(anc_a):
            anc_a, anc_b = anc_b, anc_a
        best = -1
        best_key = None
        for anc in anc_a:
            if anc in anc_b:
                key = (self._depth_max_arr[anc], -self._height_arr[anc], -anc)
                if best_key is None or key > best_key:
                    best_key = key
                    best = anc
        return best

    def lcs(self, a, b, use_min_depth=False):
        """Lowest common subsumer label (``class_hierarchy.py:123``)."""
        if use_min_depth:
            # Rarely used variant: rank common subsumers by min-path depth.
            if self._depth_min_arr is None:
                self._depth_min_arr = self._depth_arr(use_min=True)
            anc_a = self._ancestors(self._node_index[a])
            anc_b = self._ancestors(self._node_index[b])
            common = set(anc_a) & set(anc_b)
            if not common:
                return None
            best = max(common, key=lambda i: (self._depth_min_arr[i], -i))
            return self._node_list[best]
        best = self._lcs_idx(self._node_index[a], self._node_index[b])
        return None if best < 0 else self._node_list[best]

    def shortest_path_length(self, a, b):
        """Min #edges between two nodes via a common hypernym
        (``class_hierarchy.py:143``)."""
        anc_a = self._ancestors(self._node_index[a])
        anc_b = self._ancestors(self._node_index[b])
        best = None
        for anc, da in anc_a.items():
            db = anc_b.get(anc)
            if db is not None and (best is None or da + db < best):
                best = da + db
        return best

    def lcs_height(self, a, b):
        """Normalized-LCS-height dissimilarity in [0, 1]
        (``class_hierarchy.py:199``)."""
        lcs = self._lcs_idx(self._node_index[a], self._node_index[b])
        if lcs < 0:
            # Disconnected forest: silently indexing _height_arr[-1] would
            # report the two unrelated classes as (near-)maximally similar.
            # The reference raises here too (max() over an empty hypernym
            # intersection, class_hierarchy.py:123-140).
            raise ValueError(f"nodes {a!r} and {b!r} share no common subsumer"
                             " (is the hierarchy a forest?)")
        return self._height_arr[lcs] / self.max_height

    def wup_similarity(self, a, b):
        """Wu-Palmer similarity in (0, 1] (``class_hierarchy.py:179``).

        Reference-exact distance semantics: ``d1 = depth(LCS) +
        shortest_path_length(a, LCS)`` (``class_hierarchy.py:192-193``),
        where the shortest path may route through a *shallower* common
        hypernym of ``a`` and the LCS (``:143-156``) — on multi-parent
        DAGs this can be shorter than the direct upward distance.  Every
        common hypernym of ``x`` and the LCS is an ancestor of the LCS, so
        the route minimum runs over ``ancestors(LCS)``.
        """
        ia, ib = self._node_index[a], self._node_index[b]
        lcs = self._lcs_idx(ia, ib)
        if lcs < 0:
            raise ValueError(f"nodes {a!r} and {b!r} share no common subsumer"
                             " (is the hierarchy a forest?)")
        ds = int(self._depth_max_arr[lcs])
        anc_l = self._ancestors(lcs)
        anc_a = self._ancestors(ia)
        anc_b = self._ancestors(ib)
        d1 = ds + min(anc_a[h] + dh for h, dh in anc_l.items())
        d2 = ds + min(anc_b[h] + dh for h, dh in anc_l.items())
        return (2.0 * ds) / (d1 + d2)

    # ------------------------------------------------------------------
    # Retrieval metric
    # ------------------------------------------------------------------

    def hierarchical_precision(
        self,
        retrieved,
        labels,
        ks=(1, 10, 50, 100),
        compute_ahp=False,
        compute_ap=False,
        ignore_qids=True,
        all_ids=None,
    ):
        """Average hierarchical precision at several cut-offs.

        Same signature and output structure as the reference
        (``class_hierarchy.py:211-316``); the computation is delegated to the
        vectorized implementation in
        ``semantic_embeddings_torch.evaluation.hierarchical``.
        """
        from ..evaluation.hierarchical import hierarchical_precision

        return hierarchical_precision(
            self,
            retrieved,
            labels,
            ks=ks,
            compute_ahp=compute_ahp,
            compute_ap=compute_ap,
            ignore_qids=ignore_qids,
            all_ids=all_ids,
        )
