"""Dense k x k generalized eigensolves and Rayleigh-Ritz refinement, on device.

The reference round-trips every Rayleigh-Ritz through CPU LAPACK
(`scipy.linalg.eigh(A, B)` at `src/multigrid_model.py:386-408`). Here the
k x k problem stays on the device: generalized eigh via Cholesky (or
spectral-filtered whitening when B may be near-singular) + jnp.linalg.eigh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eigenpinns_tpu.sparse import spmm, gram, hdot


def eigh_generalized(A: jax.Array, B: jax.Array, jitter: float = 0.0):
    """Solve A C = B C diag(w), A symmetric, B SPD. Returns (w, C) ascending.

    Cholesky reduction: B = L L^T, solve the standard problem for
    L^{-1} A L^{-T}, back-substitute. All ops are dense k x k on device.
    """
    k = A.shape[0]
    if jitter:
        B = B + jitter * jnp.eye(k, dtype=B.dtype)
    L = jnp.linalg.cholesky(B)
    Y = jax.scipy.linalg.solve_triangular(L, A, lower=True)
    C_std = jax.scipy.linalg.solve_triangular(L, Y.T, lower=True).T
    C_std = 0.5 * (C_std + C_std.T)
    w, V = jnp.linalg.eigh(C_std)
    C = jax.scipy.linalg.solve_triangular(L.T, V, lower=False)
    return w, C


def filtered_whiten(S: jax.Array, G: jax.Array, eps: float = 1e-6):
    """Spectral B-whitening of a basis S with Gram G = S^T B S.

    Returns (S W, good) where W = V diag(e^{-1/2}) from G's eigendecomposition
    and `good` marks directions kept (e > eps * e_max). Dropped directions
    become zero columns. Robust replacement for Cholesky when the subspace
    is (numerically) linearly dependent — the situation that made the
    reference's SVD-whitening run diverge (SURVEY.md section 7 hard parts).
    """
    G = 0.5 * (G + G.T)
    e, V = jnp.linalg.eigh(G)
    good = e > eps * jnp.maximum(e[-1], 1e-30)
    inv = jnp.where(good, 1.0 / jnp.sqrt(jnp.clip(e, 1e-30)), 0.0)
    return hdot(S, V * inv[None, :]), good, V * inv[None, :]


def rayleigh_ritz(U: jax.Array, K, M, jitter: float = 0.0):
    """Refine a subspace: solve the projected generalized problem and rotate.

    Parity with `MultigridGNN.refine_eigenvectors`
    (src/multigrid_model.py:386-408): A = U^T K U, B = U^T M U,
    eigh(A, B) -> U @ C. Runs fully on device.
    """
    A = gram(U, spmm(K, U))
    B = gram(U, spmm(M, U))
    w, C = eigh_generalized(0.5 * (A + A.T), 0.5 * (B + B.T), jitter=jitter)
    return w, hdot(U, C)


def rayleigh_ritz_robust(U: jax.Array, K, M, eps: float = 1e-6):
    """Rayleigh-Ritz with spectral filtering of the mass Gram.

    Safe when U has (nearly) dependent columns: dependent directions are
    dropped and their Ritz values pushed to +inf-like sentinels so the
    leading k outputs are the meaningful ones.
    """
    B = gram(U, spmm(M, U))
    Uw, good, _ = filtered_whiten(U, B, eps=eps)
    A = gram(Uw, spmm(K, Uw))
    A = 0.5 * (A + A.T)
    # Dynamic sentinel: keeps dropped directions out of the smallest-k
    # without wrecking f32 eigh conditioning (see lobpcg._sentinel).
    big = 10.0 * jnp.max(jnp.abs(jnp.diag(A))) + 1.0
    A = A + jnp.diag(jnp.where(good, 0.0, big))
    w, V = jnp.linalg.eigh(A)
    return w, hdot(Uw, V)
