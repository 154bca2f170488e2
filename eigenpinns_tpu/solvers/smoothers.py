"""Smoothers and coarse-grid correction for the multigrid hierarchy.

Device ports of capability from `utils.jacobi_smooth`
(src/utils.py:220-232) and `MultigridGNN.apply_coarse_grid_correction`
(src/multigrid_model.py:410-450): fixed-iteration-count linear iterations
expressed as lax.fori_loop over fused SpMM — no host round-trips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from eigenpinns_tpu.sparse import spmm
from eigenpinns_tpu.solvers.rayleigh_ritz import rayleigh_ritz


@partial(jax.jit, static_argnames=("n_iters",))
def jacobi_smooth(M, K, U_rough: jax.Array, alpha: float = 0.05,
                  n_iters: int = 5) -> jax.Array:
    """Approximately solve (M + alpha K) U = M U_rough by damped Jacobi.

    Semantics match src/utils.py:220-232: diagonal-preconditioned
    iteration starting from U = U_rough.
    """
    d_inv = 1.0 / (M.diagonal() + alpha * K.diagonal() + 1e-12)
    MU_rough = spmm(M, U_rough)

    def body(_, U):
        resid = MU_rough - (spmm(M, U) + alpha * spmm(K, U))
        return U + d_inv[:, None] * resid

    return jax.lax.fori_loop(0, n_iters, body, U_rough)


@partial(jax.jit, static_argnames=("n_iters",))
def smooth_eigenfunctions(M, K, U: jax.Array, tau: float = 0.1,
                          n_iters: int = 30) -> jax.Array:
    """Implicit spectral smoothing: solve (M + tau K) U_new = M U.

    Parity with `smooth_eigenfunctions`
    (multigrid_gnn_refine_fixed.ipynb cell 4:556-576), which used a host
    spsolve; here the SPD system is solved by on-device CG.
    """
    rhs = spmm(M, U)

    def matvec(X):
        return spmm(M, X) + tau * spmm(K, X)

    X = U
    R = rhs - matvec(X)
    P = R
    rs = jnp.sum(R * R, axis=0)

    def body(_, carry):
        X, R, P, rs = carry
        AP = matvec(P)
        alpha = rs / jnp.clip(jnp.sum(P * AP, axis=0), 1e-30)
        X = X + P * alpha[None, :]
        R = R - AP * alpha[None, :]
        rs_new = jnp.sum(R * R, axis=0)
        beta = rs_new / jnp.clip(rs, 1e-30)
        P = R + P * beta[None, :]
        return X, R, P, rs_new

    X, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (X, R, P, rs))
    return X


def m_orthonormalize_cholesky(U: jax.Array, M) -> jax.Array:
    """Cholesky M-orthonormalization: U (U^T M U)^{-1/2} via triangular
    solve — parity with `m_orthonormalize`
    (multigrid_gnn_refine_fixed.ipynb cell 4:578-599; its Cholesky-failure
    fallback is unnecessary here because callers with suspect bases use
    `filtered_whiten`)."""
    from eigenpinns_tpu.sparse import gram

    G = gram(U, spmm(M, U))
    G = 0.5 * (G + G.T)
    L = jnp.linalg.cholesky(G)
    # U_orth = U L^{-T}
    return jax.scipy.linalg.solve_triangular(
        L, U.T, lower=True).T


@partial(jax.jit, static_argnames=("n_iters",))
def cg_solve(A, B_rhs: jax.Array, n_iters: int = 50,
             ridge: float = 0.0) -> jax.Array:
    """Blocked conjugate gradient for (A + ridge I) X = B_rhs, X: (N, k).

    Used for the coarse solve in CGC when the coarse operator is kept
    sparse (the reference densifies and LU-solves it instead,
    src/multigrid_model.py:443-444 — O(n^3) and singular-prone; CG with a
    small ridge is the device equivalent).
    """
    def matvec(X):
        return spmm(A, X) + ridge * X

    X = jnp.zeros_like(B_rhs)
    R = B_rhs - matvec(X)
    P = R
    rs = jnp.sum(R * R, axis=0)

    def body(_, carry):
        X, R, P, rs = carry
        AP = matvec(P)
        alpha = rs / jnp.clip(jnp.sum(P * AP, axis=0), 1e-30)
        X = X + P * alpha[None, :]
        R = R - AP * alpha[None, :]
        rs_new = jnp.sum(R * R, axis=0)
        beta = rs_new / jnp.clip(rs, 1e-30)
        P = R + P * beta[None, :]
        return X, R, P, rs_new

    X, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (X, R, P, rs))
    return X


def coarse_grid_correction(U_fine, K_fine, M_fine, K_coarse, P, Pt,
                           ridge: float = 1e-6, cg_iters: int = 100):
    """One multigrid CGC step: U - P (K_c + ridge I)^{-1} P^T (K U - M U L).

    Parity with src/multigrid_model.py:410-450, with two device-side
    substitutions: the fine-level eigenvalue estimates come from on-device
    Rayleigh-Ritz, and the coarse solve is ridge-regularized CG instead of
    a dense LU of the (singular, nullspace-of-constants) coarse stiffness.

    `P` is the (n_fine, n_coarse) prolongation and `Pt` its transpose —
    both prebuilt as SparseELL host-side (ELL has no cheap transpose).

    Returns (U_cgc, lambda_fine).
    """
    lam_f, _ = rayleigh_ritz(U_fine, K_fine, M_fine)
    R_f = spmm(K_fine, U_fine) - spmm(M_fine, U_fine) * lam_f[None, :]
    R_c = spmm(Pt, R_f)
    delta_c = cg_solve(K_coarse, R_c, n_iters=cg_iters, ridge=ridge)
    delta_f = spmm(P, delta_c)
    return U_fine - delta_f, lam_f
