"""Differentiable M-orthonormalization (whitening) of eigenbases.

Two schemes from the reference's direct-learning notebooks:

  * Newton-Schulz: iterate Y_{t+1} = Y_t (3 I - G Y_t^2)/2 towards
    G^{-1/2} using ONLY matmuls — dense-matmul hardware, stable gradients
    (scripts/simplified_loss.ipynb cell 0:44-87);
  * SVD/eigh whitening: U B^{-1/2} with B = U^T M U via eigh
    (loss_with_rigid_body.ipynb cell 0:214-222). The recorded reference
    run DIVERGED with unguarded SVD whitening (BASELINE.md negative
    result); here the inverse sqrt is clipped by a conditioning guard.

Both return U_orth with U_orth^T M U_orth ~= I, differentiable end-to-end.
"""

from __future__ import annotations

import jax.numpy as jnp

from eigenpinns_tpu.sparse import gram, hdot, spmm


def newton_schulz_inv_sqrt(G: jnp.ndarray, n_iters: int = 5):
    """A^{-1/2} for SPD A via the coupled Newton-Schulz iteration.

    Frobenius pre-scaling ensures convergence (||I - A/s||_2 < 1).
    Matmul-only: ideal for the matrix units and for reverse-mode AD.
    """
    k = G.shape[0]
    eye = jnp.eye(k, dtype=G.dtype)
    scale = jnp.sqrt(jnp.sum(G * G))
    Y = G / scale
    Z = eye

    def step(carry, _):
        Y, Z = carry
        T = 0.5 * (3.0 * eye - hdot(Z, Y))
        return (hdot(Y, T), hdot(T, Z)), None

    import jax

    (Y, Z), _ = jax.lax.scan(step, (Y, Z), None, length=n_iters)
    return Z / jnp.sqrt(scale)


def newton_schulz_orthonormalize(U, M, n_iters: int = 5):
    """U @ (U^T M U)^{-1/2} via Newton-Schulz."""
    G = gram(U, spmm(M, U))
    G = 0.5 * (G + G.T)
    return hdot(U, newton_schulz_inv_sqrt(G, n_iters=n_iters))


def spectral_orthonormalize(U, M, cond_clip: float = 1e6):
    """U B^{-1/2} with B^{-1/2} from eigh, conditioning-guarded.

    Eigenvalues of the Gram below max_e / cond_clip are clipped before the
    inverse sqrt — the guard whose absence sank the reference's k=50 run.
    """
    G = gram(U, spmm(M, U))
    G = 0.5 * (G + G.T)
    e, V = jnp.linalg.eigh(G)
    e = jnp.clip(e, jnp.max(e) / cond_clip)
    inv_sqrt = hdot(V * (1.0 / jnp.sqrt(e))[None, :], V.T)
    return hdot(U, inv_sqrt)


def gram_condition_penalty(U, M, eps: float = 1e-12):
    """log(e_max / e_min) of the Gram — the stability regularizer of
    loss_with_rigid_body.ipynb cell 0:263-265 in a smooth form."""
    G = gram(U, spmm(M, U))
    G = 0.5 * (G + G.T)
    e = jnp.linalg.eigvalsh(G)
    return jnp.log(jnp.clip(e[-1], eps) / jnp.clip(e[0], eps))
