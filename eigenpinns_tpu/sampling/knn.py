"""kNN graphs and prolongation operators.

Replaces the reference's sklearn NearestNeighbors paths
(`utils.build_knn_graph` src/utils.py:63-75 and `utils.build_prolongation`
src/utils.py:39-60) with scipy cKDTree host-side (preprocessing) and a
brute-force `jax.lax.top_k` variant for on-device use.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree


def knn_graph(X: np.ndarray, k: int) -> np.ndarray:
    """(2, N*k) directed edge index: row i -> each of its k nearest
    neighbors (self excluded) — semantics of src/utils.py:63-75."""
    n = X.shape[0]
    k = min(k, n - 1)
    from eigenpinns_tpu.geometry import native as _native

    if _native.available():
        cols = _native.knn_native(np.asarray(X, np.float64), k).reshape(-1)
    else:
        tree = cKDTree(X)
        _, idx = tree.query(X, k=k + 1)
        cols = idx[:, 1:].reshape(-1)
    rows = np.repeat(np.arange(n), k)
    return np.stack([rows, cols]).astype(np.int64)


def prolongation_matrix(X_coarse: np.ndarray, X_fine: np.ndarray,
                        k: int) -> sp.coo_matrix:
    """(n_fine, n_coarse) inverse-distance kNN interpolation weights —
    semantics of src/utils.py:39-60 (weights 1/(d+1e-12), row-normalized)."""
    k = min(k, X_coarse.shape[0])
    tree = cKDTree(X_coarse)
    dist, idx = tree.query(X_fine, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    w = 1.0 / (dist + 1e-12)
    w /= w.sum(axis=1, keepdims=True)
    n_fine = X_fine.shape[0]
    rows = np.repeat(np.arange(n_fine), k)
    return sp.coo_matrix(
        (w.reshape(-1), (rows, idx.reshape(-1))),
        shape=(n_fine, X_coarse.shape[0]),
    )


def knn_graph_device(X, k: int):
    """On-device brute-force kNN via pairwise distances + lax.top_k.

    O(N^2) FLOPs in dense matmuls — the right trade at <=100k points;
    beyond that, tile with the Pallas distance kernel (future work noted
    in SURVEY.md section 7 slice 3).
    """
    import jax
    import jax.numpy as jnp

    X = jnp.asarray(X)
    n = X.shape[0]
    sq = jnp.sum(X * X, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.dot(
        X, X.T, precision=jax.lax.Precision.HIGHEST)
    # Exclude self-matches (0 * inf = nan, so mask with where, not eye*inf).
    eye = jnp.eye(n, dtype=bool)
    d2 = jnp.where(eye, jnp.inf, d2)
    _, idx = jax.lax.top_k(-d2, k)
    rows = jnp.repeat(jnp.arange(n), k)
    return jnp.stack([rows, idx.reshape(-1)])
