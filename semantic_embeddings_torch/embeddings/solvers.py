"""Analytic class-embedding solvers.

The port's own copy of ``semantic_embeddings_tpu/embeddings/solvers.py``:
host numpy, or with ``device`` a CUDA device the two factorizations
(Cholesky and the symmetric eigendecomposition) in float64 on that device
through ``torch.linalg``, where that module runs them on the JAX device.

Places ``n`` classes in an embedding space so that dot products (or Euclidean
distances) reproduce taxonomy-derived (dis)similarities.  Functional parity
with the original ``compute_class_embedding.py:14-172``; the algorithms are
re-derived for batched linear algebra:

- ``unitsphere_embedding``: the original's sequential row-by-row placement
  (``compute_class_embedding.py:36-38``) constructs exactly the lower-
  triangular factor ``E`` with ``E @ E.T = S`` and a non-negative diagonal —
  i.e. the Cholesky factor of the similarity matrix.  We therefore compute it
  as a single fused ``cholesky(S)`` (O(n^3/3) instead of n back-substitutions).
- ``sim_approx``: eigendecomposition-based low-dimensional approximation.
- ``euclidean_embedding``: iterative hypersphere-intersection placement.
- ``mds``: classical multidimensional scaling via double centering.
"""

from __future__ import annotations

import numpy as np


def _cuda_f64(a, device):
    """``a`` as a float64 tensor on the CUDA ``device``; without a GPU this
    raises: the ``device`` path never falls back to the host."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device={device} is not a CUDA device that is present "
                           "(device=None runs on the host)")
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def unitsphere_embedding(class_sim, device=None):
    """n-dimensional unit-sphere embedding with exact dot-product similarities.

    Parameters
    ----------
    class_sim:
        (n, n) symmetric positive-definite similarity matrix with unit
        diagonal (e.g. ``1 - lcs_height``).
    device:
        A CUDA device (``torch.device`` or its name) to run the Cholesky
        factorization on in float64 (``torch.linalg.cholesky_ex``); None
        runs LAPACK on the host.

    Returns
    -------
    (n, n) float64 matrix whose rows are unit-norm class embeddings with
    ``E @ E.T == class_sim`` (lower-triangular, matching the original
    iterative construction up to LAPACK rounding).
    """
    class_sim = np.ascontiguousarray(class_sim, dtype=np.float64)
    if class_sim.ndim != 2 or class_sim.shape[0] != class_sim.shape[1]:
        raise ValueError(
            f"Given class_sim has invalid shape. Expected: (n, n). "
            f"Got: {class_sim.shape}"
        )
    if class_sim.shape[0] == 0:
        raise ValueError("Empty class_sim given.")
    try:
        if device is not None:
            import torch

            emb, info = torch.linalg.cholesky_ex(_cuda_f64(class_sim, device))
            if int(info) != 0:
                raise np.linalg.LinAlgError("matrix not positive definite")
            return emb.cpu().numpy()
        return np.linalg.cholesky(class_sim)
    except np.linalg.LinAlgError as err:
        raise RuntimeError(
            "Similarity matrix is not positive definite; the unit-sphere "
            "placement does not exist. Consider the 'approx_sim' method."
        ) from err


def sim_approx(class_sim, num_dim=None, device=None):
    """Low-dimensional embedding approximating dot-product similarities.

    Eigendecomposition path of the original ``compute_class_embedding.py:44-71``:
    factor ``S = Q diag(L) Q^T``, embed as ``Q * sqrt(L)``, keep the
    ``num_dim`` leading eigenvector columns.

    ``device``, a CUDA device, runs the symmetric eigendecomposition in
    float64 there (``torch.linalg.eigh`` also sorts the eigenvalues
    ascending, so the column selection below does not depend on the
    backend; the eigenvectors' signs may).
    """
    class_sim = np.asarray(class_sim, dtype=np.float64)
    if class_sim.ndim != 2 or class_sim.shape[0] != class_sim.shape[1]:
        raise ValueError(
            f"Given class_sim has invalid shape. Expected: (n, n). "
            f"Got: {class_sim.shape}"
        )
    if class_sim.shape[0] == 0:
        raise ValueError("Empty class_sim given.")

    if device is not None:
        import torch

        eigval, eigvec = (t.cpu().numpy()
                          for t in torch.linalg.eigh(_cuda_f64(class_sim, device)))
    else:
        eigval, eigvec = np.linalg.eigh(class_sim)
    if np.any(eigval < 0):
        raise RuntimeError("Given class_sim is not positive semi-definite.")
    emb = eigvec * np.sqrt(eigval)[None, :]
    if num_dim is not None and num_dim < emb.shape[1]:
        emb = emb[:, -num_dim:]  # eigh sorts ascending: keep leading modes
    return emb


def euclidean_embedding(class_dist, solver="general"):
    """(n-1)-dimensional placement with exact pairwise Euclidean distances.

    Successive hypersphere intersection (``compute_class_embedding.py:75-140``):
    class ``c`` is placed at the intersection of spheres centered at classes
    ``0..c-1`` with radii equal to the target distances.
    """
    import scipy.linalg

    class_dist = np.asarray(class_dist, dtype=np.float64)
    if class_dist.ndim != 2 or class_dist.shape[0] != class_dist.shape[1]:
        raise ValueError(
            f"Given class_dist has invalid shape. Expected: (n, n). "
            f"Got: {class_dist.shape}"
        )
    nc = class_dist.shape[0]
    if nc == 0:
        raise ValueError("Empty class_dist given.")

    emb = np.zeros((nc, nc - 1))
    if nc > 1:
        emb[1, 0] = class_dist[0, 1]
    for c in range(2, nc):
        centers = emb[1:c, : c - 1]
        radii_sq = class_dist[:c, c] ** 2
        rhs = (radii_sq[0] - radii_sq[1:] + np.sum(centers ** 2, axis=1)) / 2
        try:
            if solver == "general":
                x = np.linalg.solve(centers, rhs)
            elif solver == "triangular":
                x = scipy.linalg.solve_triangular(centers, rhs, lower=True)
            else:
                raise ValueError(f"Unknown solver: {solver}")
            ok = np.allclose(centers @ x, rhs)
        except (np.linalg.LinAlgError, scipy.linalg.LinAlgError):
            ok = False
        if not ok:
            raise RuntimeError(
                f"Failed to place class #{c + 1}: Hyperspheres do not intersect."
            )
        d_sq = np.sum(x ** 2)
        if d_sq > radii_sq[0]:
            raise RuntimeError(
                f"Failed to place class #{c + 1}: There is no common "
                f"intersection of all spheres "
                f"(offset: {np.sqrt(d_sq) - np.sqrt(radii_sq[0])})."
            )
        emb[c, : c - 1] = x
        emb[c, c - 1] = np.sqrt(radii_sq[0] - d_sq)
    return emb


def mds(class_dist, num_dim=None):
    """Classical MDS embedding of a distance matrix
    (``compute_class_embedding.py:144-172``)."""
    class_dist = np.asarray(class_dist)
    n = class_dist.shape[0]
    centering = np.eye(n, dtype=class_dist.dtype) - 1.0 / n
    gram = centering @ (class_dist ** 2) @ centering / -2

    eigval, eigvec = np.linalg.eigh(gram)
    keep = eigval > np.finfo(class_dist.dtype).eps
    eigval, eigvec = eigval[keep], eigvec[:, keep]
    if num_dim is not None:
        top = np.argsort(eigval)[::-1][:num_dim]
        eigval, eigvec = eigval[top], eigvec[:, top]
    return eigvec * np.sqrt(eigval)[None, :]
