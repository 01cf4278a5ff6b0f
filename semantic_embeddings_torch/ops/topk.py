"""Exact chunked top-k with ``lax.top_k``'s tie order.

Counterpart of the JAX package's ``ops/topk.py``: the top ``k`` of each row,
where among equal values the smaller index wins and padding is -inf.
``torch.topk`` promises no tie order on CUDA, so each stage is a stable
descending sort (``torch.sort(stable=True)``), which keeps equal values in
index order.  The two-stage shape is the JAX version's: a top-k per
``chunk``-wide slice of the row, then a top-k of the ``n_chunks * k``
candidates, which are laid out chunk by chunk, so that among equal values
the stable sort again picks the smaller global index.

The JAX package computes this in jnp, not in a Pallas kernel; this is plain
PyTorch on whatever device ``x`` lies on.
"""

from __future__ import annotations

import numpy as np
import torch


def _stable_topk(x, k):
    """The first ``k`` of a stable descending sort along the last axis."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def exact_topk(x, k, chunk=2048):
    """Values and indices of the top ``k`` of each row of the 2-D ``x``, with
    ``lax.top_k``'s order (descending; the smaller index first among equal
    values).

    ``chunk`` is the inner reduction width (at least ``k``).  Rows are
    padded with -inf up to a multiple of it; padding is never selected while
    ``k`` <= the row length, since a real candidate of equal value comes
    earlier.
    """
    b, n = x.shape
    if k > n:
        raise ValueError(f"k={k} > row length {n}")
    chunk = max(int(chunk), int(k))
    if n <= chunk:
        return _stable_topk(x, k)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        x = torch.cat([x, x.new_full((b, pad), float("-inf"))], dim=1)
    v, i = _stable_topk(x.view(b, n_chunks, chunk), k)  # (b, n_chunks, k)
    base = torch.arange(n_chunks, device=x.device).view(1, n_chunks, 1) * chunk
    cand_v = v.reshape(b, n_chunks * k)
    cand_i = (i + base).reshape(b, n_chunks * k)
    v2, j = _stable_topk(cand_v, k)
    return v2, torch.gather(cand_i, 1, j)


def exact_topk_payload(x, payload, k, chunk=2048):
    """Top-``k`` values of each row of ``x`` with an integer ``payload`` (N,)
    gathered along (database class ids), in :func:`exact_topk`'s order."""
    v, idx = exact_topk(x, k, chunk=chunk)
    return v, payload[idx]


#: (rows, n, k, chunk) at which the card's top-k is held bitwise to the
#: CPU's: the retrieval protocols' shapes (k = 251 of 10,000 and 50,000,
#: chunk 2048) and k at and around the chunk edges
CHECK_CASES = [(64, 10_000, 251, 2048), (32, 50_000, 251, 2048), (16, 4097, 2048, 2048),
               (16, 1200, 127, 128), (16, 257, 40, 256), (8, 300, 300, 64)]


def check_inputs(case, seed=0):
    """Tie-heavy rows of ``case``'s shape as a host tensor: integers in
    [0, 4), a row of +inf, a row of -inf, and a row mixing both."""
    rows, n, _, _ = case
    x = np.random.default_rng(seed).integers(0, 4, (rows, n)).astype(np.float32)
    x[0] = np.inf
    x[1] = -np.inf
    x[2, ::3], x[2, 1::3] = np.inf, -np.inf
    return torch.from_numpy(x)
