"""Analytic test fixtures and eigenpair verification.

Formalizes the reference's embedded test harness
(`generate_test_matrices` / `verify_eigenpairs` / sized runners,
downsampling_toy_example.ipynb cell 0:257-310): synthetic (K, M) pairs
with known or easily-computed spectra, used across the test suite and the
matrix-only multigrid driver.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian_1d(n: int) -> sp.csr_matrix:
    """1D FD Laplacian; spectrum 2 - 2 cos(pi j / (n+1)), j = 1..n."""
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def laplacian_1d_eigenvalues(n: int, k: int) -> np.ndarray:
    j = np.arange(1, k + 1)
    return 2.0 - 2.0 * np.cos(np.pi * j / (n + 1))


def tridiagonal(n: int, seed: int = 0) -> sp.csr_matrix:
    """Random symmetric positive tridiagonal matrix."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(2.0, 4.0, size=n)
    o = rng.uniform(-1.0, -0.2, size=n - 1)
    return sp.diags([o, d, o], [-1, 0, 1]).tocsr()


def random_spd(n: int, density: float = 0.05, seed: int = 0):
    """Sparse random SPD pair (K, M) — K = A A^T + n I pattern, M SPD
    diagonal."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density,
                  random_state=np.random.RandomState(seed))
    K = (A @ A.T + sp.eye(n)).tocsr()
    M = sp.diags(rng.uniform(0.5, 2.0, size=n)).tocsr()
    return K, M


def generate_test_matrices(n: int, kind: str = "laplacian", seed: int = 0):
    """(K, M) fixture pair by kind: 'laplacian' | 'tridiagonal' |
    'random_spd' — matching the reference's generator."""
    if kind == "laplacian":
        return laplacian_1d(n), sp.eye(n).tocsr()
    if kind == "tridiagonal":
        return tridiagonal(n, seed), sp.eye(n).tocsr()
    if kind == "random_spd":
        return random_spd(n, seed=seed)
    raise ValueError(f"unknown kind '{kind}'")


def verify_eigenpairs(K, M, vals: np.ndarray, vecs: np.ndarray,
                      tol: float = 1e-6):
    """Residual norms ||K u - lam M u|| / ||K u|| and the orthonormality
    defect, as in `verify_eigenpairs` (cell 0:271-280).

    Returns (rel_residuals, max_gram_defect, ok).
    """
    Ku = K @ vecs
    Mu = M @ vecs
    res = Ku - Mu * vals[None, :]
    rel = np.linalg.norm(res, axis=0) / (np.linalg.norm(Ku, axis=0) + 1e-300)
    G = vecs.T @ Mu
    defect = np.abs(G - np.eye(vecs.shape[1])).max()
    return rel, float(defect), bool(rel.max() < tol and defect < tol)


def subsample_hierarchy(n: int, levels: list[int], method: str = "uniform",
                        K=None, seed: int = 0) -> list[np.ndarray]:
    """Nested index hierarchies for matrix-only multigrid
    (`build_hierarchy`, downsampling_toy_example.ipynb cell 0:20-57):
    'uniform' (evenly spaced), 'random', 'leverage' (row-norm weighted),
    'maxdist' (greedy farthest-point selection using |K| row entries as
    the distance proxy — cell 15's `farthest_point_sampling`).
    Returns indices per level, coarsest first, full range appended.
    """
    out = []
    rng = np.random.default_rng(seed)
    for m in levels:
        m = min(m, n)
        if method == "uniform":
            idx = np.unique(np.linspace(0, n - 1, m).astype(int))
        elif method == "random":
            idx = np.sort(rng.choice(n, size=m, replace=False))
        elif method == "leverage":
            if K is None:
                raise ValueError("leverage sampling needs K")
            scores = np.asarray(abs(K).sum(axis=1)).ravel()
            p = scores / scores.sum()
            idx = np.sort(rng.choice(n, size=m, replace=False, p=p))
        elif method == "maxdist":
            # FPS in the matrix graph: greedily pick the index farthest
            # (under min-coupling |K[last, :]|) from all picked ones —
            # "better coverage" coarse sets without coordinates.
            if K is None:
                raise ValueError("maxdist sampling needs K")
            Ka = abs(K.tocsr()) if hasattr(K, "tocsr") else np.abs(K)
            picked = [0]
            dist = np.full(n, np.inf)
            for _ in range(m - 1):
                row = np.asarray(
                    Ka[picked[-1]].todense()
                    if hasattr(Ka, "todense") else Ka[picked[-1]]).ravel()
                dist = np.minimum(dist, row)
                dist[picked] = -np.inf
                picked.append(int(np.argmax(dist)))
            idx = np.sort(np.asarray(picked))
        else:
            raise ValueError(f"unknown method '{method}'")
        out.append(idx)
    out.append(np.arange(n))
    return out


def icosphere(subdivisions: int):
    """Unit icosphere: (verts (V, 3) float64, faces (F, 3) int32) with
    V = 10 * 4**subdivisions + 2 (2,562 at 4 subdivisions) and
    counter-clockwise outward faces. Each subdivision splits every
    triangle into four at its edge midpoints, projected to the sphere."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        midpoint: dict = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in midpoint:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                midpoint[key] = len(verts) - 1
            return midpoint[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    return np.asarray(verts), np.asarray(faces, dtype=np.int32)
