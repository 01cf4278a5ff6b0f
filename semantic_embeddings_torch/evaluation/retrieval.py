"""All-pairs retrieval: blockwise GEMM + ranking + metric core on the device.

Counterpart of the JAX package's ``evaluation/retrieval.py``: one device,
or a list of them (``--gpus``) over which the query blocks split with the
database replicated, or the database's rows split (``--db_sharded``).  The database stays on the device; each block of
queries takes one (B x d) @ (d x N) GEMM, a stable ranking on the device,
and the hierarchical-precision math of
:class:`~semantic_embeddings_torch.evaluation.hierarchical.HPEvaluator` on
the ranked class ids, so that only per-query scalars leave the device, and
peak memory is O(B * N) instead of O(N^2).

Ties keep database order, as the JAX package's stable sorts do: the full
ranking is ``torch.sort(stable=True)`` of the negated similarities, the
prefix ranking :func:`~semantic_embeddings_torch.ops.topk.exact_topk`.  Each
query is pinned to rank 0 by +-inf and dropped there (the reference's
query-id removal).  The GEMM runs in the dtype of the features, f32; the
CLIs keep TF32 off (``cli.common.set_float32_precision``), without which
near-ties would flip against an f32 ranking.
"""

from __future__ import annotations

import numpy as np
import torch

from ..embeddings.io import load_features
from ..ops.topk import exact_topk
from .hierarchical import HPEvaluator


def _similarities(queries, database, normalize):
    """(B, N) similarities: dot products of normalized features, else the
    negated squared Euclidean distances."""
    if normalize:
        return queries @ database.T
    sq_db = torch.sum(database * database, dim=-1)
    sq_q = torch.sum(queries * queries, dim=-1)
    return -(sq_q[:, None] + sq_db[None, :]) + 2.0 * (queries @ database.T)


def _ranked(sims, q_index, topk=None):
    """Database indices ranked by (B, N) ``sims``, each query pinned to rank
    0 by +inf (in place; among several +inf, before every later index): the
    full stable descending sort (B, N), or the exact top-(topk + 1).  Equal
    similarities keep database order either way.  (The negated similarities
    of the Euclidean branch are the distances, bit for bit.)"""
    sims[torch.arange(sims.shape[0], device=sims.device), q_index] = float("inf")
    if topk is not None:
        return exact_topk(sims, topk + 1)[1]
    return torch.sort(-sims, dim=-1, stable=True).indices


def _database(features, normalize, device):
    """(N, d) f32 features on ``device``, L2-normalized on the host first
    when asked (as the JAX package does)."""
    feats = np.asarray(features, dtype=np.float32)
    if normalize:
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    return torch.from_numpy(np.ascontiguousarray(feats)).to(device)


def pairwise_ranking_blocks(features, normalize=False, block_size=1024, *, device):
    """Yields ``(start, ranking_block)``, each block a host (B, N) array of
    database indices with the query pinned to rank 0.

    ``features``: (N, d) array, moved to ``device`` once; each block is one
    GEMM and one stable sort there."""
    database = _database(features, normalize, device)
    n = database.shape[0]
    for start in range(0, n, block_size):
        stop = min(start + block_size, n)
        q_index = torch.arange(start, stop, device=device)
        sims = _similarities(database[start:stop], database, normalize)
        yield start, _ranked(sims, q_index).cpu().numpy()


def pairwise_retrieval(features, normalize=False, return_generator=True, *, device):
    """The reference's API (``evaluate_retrieval.py:22-73``): yields
    ``(query_id, ranked id list)`` per query, ids taken from the feature dict
    keys (or positional indices)."""
    ids, feats = load_features(features)

    def gen():
        for start, block in pairwise_ranking_blocks(feats, normalize, device=device):
            for row_idx, row in enumerate(block):
                # the query sits at rank 0; the reference's query-id removal
                # deletes it wherever it ranks, so this is order-equivalent
                qid = start + row_idx
                if ids is not None:
                    yield ids[qid], ids[row].tolist()
                else:
                    yield qid, row.tolist()

    return gen() if return_generator else dict(gen())


def ranked_classes(sims, q_index, db_classes, topk=None):
    """The database's class ids ranked by (B, N) ``sims`` (see
    :func:`_ranked`), the query's rank 0 dropped: (B, N - 1) by the full
    stable sort, or (B, topk) by the exact top-(topk + 1)."""
    return db_classes[_ranked(sims, q_index, topk)[:, 1:]]


def _device_metric_fn(evaluator, normalize, device, topk=None):
    """``block_metrics(queries, database, q_index, ranked=None)`` ->
    ``{metric: (B,)}`` f32 tensors on ``device``: the GEMM, the ranking, the
    class gathers, the cumulative sums and the metric reductions, all on the
    device.  ``ranked``: the block's ranked database indices, query first,
    where the caller ranked them (the database-sharded merge).

    Assumes the query pinned to rank 0 and dropped (query-id removal with
    the optimal cumulative curve cut at rank 0).  ``topk``: when the metrics
    need only a ranking prefix (P@k and clipped AHP, no AP), rank by the
    exact top-(topk + 1) instead of a full N-wide sort, and cut the optimal
    curves from (C, N - 1) to (C, topk).
    """
    ks = evaluator.ks
    compute_ahp = evaluator.compute_ahp
    compute_ap = evaluator.compute_ap
    if topk is not None and (compute_ap or isinstance(compute_ahp, bool)
                             and compute_ahp):
        raise ValueError("topk requires compute_ap=False and clipped AHP")
    # Per-class optimal cumulative curves with the self result removed:
    # best[1:] - 1.0 (the reference's class_hierarchy.py:294-295 with the
    # query at rank 0), cut to the prefix before they are stacked.
    n_cls = evaluator.wup_sim.shape[0]
    stop = None if topk is None else topk + 1
    best_w = np.stack([evaluator._best_cum(c)[0][1:stop] - 1.0 for c in range(n_cls)])
    best_l = np.stack([evaluator._best_cum(c)[1][1:stop] - 1.0 for c in range(n_cls)])

    def table(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    wup_sim, lcs_sim = table(evaluator.wup_sim), table(evaluator.lcs_sim)
    best_w, best_l = table(best_w), table(best_l)
    db_classes = table(evaluator.db_classes, torch.int64)

    def block_metrics(queries, database, q_index, ranked=None):
        if ranked is None:
            sims = _similarities(queries, database, normalize)
            ranked = _ranked(sims, q_index, topk)
            del sims
        ranked_cls = db_classes[ranked[:, 1:]]
        q_cls = db_classes[q_index]
        wup = wup_sim[q_cls[:, None], ranked_cls]
        lcs = lcs_sim[q_cls[:, None], ranked_cls]
        bw, bl = best_w[q_cls], best_l[q_cls]
        cum_w = torch.cumsum(wup, dim=1)
        cum_l = torch.cumsum(lcs, dim=1)
        out = {}
        for k in ks:
            # a k past an array's end reads its last column, as jnp's
            # gather clamps; each array is clamped to its own length
            ic, ib = min(k, cum_w.shape[1]) - 1, min(k, bw.shape[1]) - 1
            out[f"P@{k} (WUP)"] = cum_w[:, ic] / bw[:, ib]
            out[f"P@{k} (LCS_HEIGHT)"] = cum_l[:, ic] / bl[:, ib]
        if compute_ahp:
            m = cum_w.shape[1]
            clip = None if isinstance(compute_ahp, bool) else int(compute_ahp)
            kc = m if clip is None else min(clip, m)
            dx = 1.0 / (m if clip is None else clip)
            for tag, cum, bst in (("WUP", cum_w, bw), ("LCS_HEIGHT", cum_l, bl)):
                ratio = cum[:, :kc] / bst[:, :kc]
                out[f"AHP{evaluator.ahp_suffix} ({tag})"] = dx * (
                    ratio.sum(dim=1) - (ratio[:, 0] + ratio[:, -1]) / 2)
        if compute_ap:
            rel = (ranked_cls == q_cls[:, None]).to(torch.float32)
            cum_rel = torch.cumsum(rel, dim=1)
            ranks = torch.arange(1, rel.shape[1] + 1, device=rel.device)
            prec_at = cum_rel / ranks[None, :]
            n_pos = cum_rel[:, -1]
            out["AP"] = (prec_at * rel).sum(dim=1) / torch.clamp_min(n_pos, 1)
        return out

    return block_metrics


def ranking_check(device, topk=None, n=4000, d=16, n_classes=100, queries=512, seed=0):
    """Ranked class ids (host tensor) of :func:`ranked_classes` on
    ``device`` for tie-heavy inputs, which the card's run is held to
    bitwise against the CPU's: integer features in [-2, 2] (every f32 sum
    exact, in any order; many equal similarities), the first query's row
    all -inf, the second's all +inf, the third's alternating."""
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.integers(-2, 3, (n, d)).astype(np.float32)).to(device)
    db_classes = torch.arange(n, device=device) % n_classes
    sims = _similarities(feats[:queries], feats, normalize=False)
    sims[0] = float("-inf")
    sims[1] = float("inf")
    sims[2, ::2] = float("-inf")
    sims[2, 1::2] = float("inf")
    return ranked_classes(sims, torch.arange(queries, device=device), db_classes, topk).cpu()


def default_block_size(n):
    """Queries per block: a ~2 GB f32 similarity block, a power of two in
    [1024, 8192]."""
    return int(min(8192, max(1024, 2 ** int(np.log2(max(1.0, 2e9 / 4.0 / max(n, 1)))))))


DB_SHARDED_MESH = "db_sharded needs a mesh"
DB_SHARDED_PROTOCOL = (
    "db_sharded requires the top-k prefix protocol "
    "(compute_ap=False and a clipped compute_ahp): full-sort "
    "metrics need every rank, which a sharded database cannot "
    "produce without an all-to-all of the whole sims matrix")


def _db_sharded_ranker(database, devices, normalize, topk):
    """``rank(queries, q_index)`` -> (B, topk + 1) global database indices,
    query first, with the database's rows split over ``devices``: the rows
    padded to a multiple of their number (the padding masked to -inf), each
    device ranks its shard by an exact top-(topk + 1) (each query pinned by
    +inf on the shard that holds it), and the first device merges the
    candidates by value descending, then global index ascending.  That is
    the replicated ranking bit for bit, ties included: each shard's
    candidates keep index order among equal values, the shards come in row
    order, and the merge is a stable sort."""
    n, n_dev = database.shape[0], len(devices)
    per = -(-n // n_dev)
    padded = torch.cat([database, database.new_zeros((per * n_dev - n, database.shape[1]))])
    shards = [padded[i * per:(i + 1) * per].to(dev) for i, dev in enumerate(devices)]
    k_out = topk + 1
    first = devices[0]

    def rank(queries, q_index):
        values, index = [], []
        for i, (dev, shard) in enumerate(zip(devices, shards)):
            sims = _similarities(queries.to(dev), shard, normalize)
            lo = i * per
            if lo + per > n:  # padded rows never win
                sims[:, max(n - lo, 0):] = float("-inf")
            q = q_index.to(dev)
            mine = (q >= lo) & (q < lo + per)
            sims[torch.nonzero(mine).squeeze(1), q[mine] - lo] = float("inf")
            v, j = exact_topk(sims, min(k_out, per))
            values.append(v.to(first))
            index.append((j + lo).to(first))
        values, index = torch.cat(values, dim=1), torch.cat(index, dim=1)
        order = torch.sort(values, dim=1, descending=True, stable=True).indices
        return torch.gather(index, 1, order[:, :k_out])

    return rank


def evaluate_retrieval_features(features, labels, hierarchy, ks=(1, 10, 50, 100),
                                compute_ahp=True, compute_ap=True, normalize=False,
                                block_size=None, *, device=None, devices=None,
                                db_sharded=False):
    """Features -> hierarchical retrieval metrics, computed on ``device``.

    ``features``: a feature dump (path or ``{'feat': {id: vector}}``), a
    ``{id: vector}`` dict, or an (N, d) array.  ``labels``: class labels,
    indexed by the dump's ids (or aligned with the array's rows).
    ``block_size``: queries per block; by default a ~2 GB f32 similarity
    block.  Every block is enqueued before anything is fetched, and the
    per-query scalars come back in one transfer.
    ``devices``: a list of devices (``--gpus N``; the JAX package's mesh)
    over which each query block is split, the database replicated on each;
    or with ``db_sharded`` the database's rows split over them
    (:func:`_db_sharded_ranker`), which takes the top-k prefix protocol
    (no AP, clipped AHP).  The results come together on the first device.
    Returns ``(means, per_query)`` with the reference's metric names.
    """
    if devices is None:
        if db_sharded:
            raise ValueError(DB_SHARDED_MESH)
        if device is None:
            raise ValueError("pass a device or a list of devices")
        devices = [device]
    devices = [torch.device(d) for d in devices]
    device = devices[0]
    ids, feats = load_features(features)
    if ids is not None:
        # dumps key rows by image id, in any order: pair labels by id
        labels = [labels[i] for i in ids]
    else:
        labels = list(labels)
    if len(labels) != len(feats):
        raise ValueError(
            f"labels has {len(labels)} entries for {len(feats)} feature rows")
    classes = list(dict.fromkeys(labels))
    class_index = {c: i for i, c in enumerate(classes)}
    db_classes = np.array([class_index[l] for l in labels], dtype=np.int64)

    evaluator = HPEvaluator(
        hierarchy, db_classes, classes, ks=ks, compute_ahp=compute_ahp,
        compute_ap=compute_ap, ignore_qids=True)
    database = _database(feats, normalize, device)
    n = database.shape[0]
    # When the metrics need only a ranking prefix (P@k and clipped AHP, no
    # AP), rank by the exact top-k instead of a full N-wide sort.
    topk = None
    if not compute_ap and not (isinstance(compute_ahp, bool) and compute_ahp):
        limit = max(max(ks) if ks else 1, int(compute_ahp))
        topk = limit if limit < n - 1 else None
    if block_size is None:
        block_size = default_block_size(n)
    names = evaluator.metric_names
    blocks = []
    if db_sharded:
        if topk is None:
            raise ValueError(DB_SHARDED_PROTOCOL)
        block_metrics = _device_metric_fn(evaluator, normalize, device, topk=topk)
        rank = _db_sharded_ranker(database, devices, normalize, topk)
        for start in range(0, n, block_size):
            q_index = torch.arange(start, min(start + block_size, n), device=device)
            out = block_metrics(None, None, q_index,
                                ranked=rank(database[start:start + block_size], q_index))
            blocks.append(torch.stack([out[name] for name in names]))
    else:
        # the database on every device; each query block split over them
        copies = {dev: (database.to(dev),
                        _device_metric_fn(evaluator, normalize, dev, topk=topk))
                  for dev in dict.fromkeys(devices)}
        for start in range(0, n, block_size):
            chunks = torch.arange(start, min(start + block_size, n)).tensor_split(len(devices))
            for dev, q_index in zip(devices, chunks):
                if len(q_index):
                    db, block_metrics = copies[dev]
                    q_index = q_index.to(dev)
                    out = block_metrics(db[q_index], db, q_index)
                    blocks.append(torch.stack([out[name] for name in names]).to(device))
    per_query_arr = torch.cat(blocks, dim=1).cpu().numpy().astype(np.float64)

    means = {name: float(vals.mean())
             for name, vals in zip(evaluator.metric_names, per_query_arr)}
    keys = range(n) if ids is None else ids
    per_query = {name: dict(zip(keys, vals))
                 for name, vals in zip(evaluator.metric_names, per_query_arr)}
    return means, per_query
