"""Generalized LOBPCG for the smallest-k eigenpairs of K u = lambda M u.

On-device replacement for the reference's ARPACK calls
(`scipy.sparse.linalg.eigsh(L, k, M, which='SM')` at src/utils.py:172-183):
the coarsest hierarchy level and any "exact" solve the framework needs can
run on device without a host round-trip. The algorithm is Knyazev's locally
optimal block preconditioned conjugate gradient with:

  * B-inner-product Rayleigh-Ritz on the [X, W, P] block basis,
  * spectral-filtered whitening (instead of Cholesky) for robustness in
    f32 — near-dependent directions are dropped, not inverted,
  * Jacobi (inverse-diagonal) preconditioning of the residual block,
  * fixed-shape lax.while_loop: compiles once, early-exits on tolerance.

Everything is dense (N, 3k) matmul + SpMM.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from eigenpinns_tpu.sparse import spmm, gram, hdot
from eigenpinns_tpu.solvers.rayleigh_ritz import filtered_whiten


class LobpcgResult(NamedTuple):
    eigenvalues: jax.Array   # (k,)
    eigenvectors: jax.Array  # (N, k), M-orthonormal
    iterations: jax.Array    # ()
    residual_norms: jax.Array  # (k,) final ||K u - lam M u|| / max(1, |lam|)


def _sentinel(A: jax.Array) -> jax.Array:
    """Ritz-value sentinel for dropped basis directions.

    Must exceed every true Ritz value of interest (so dropped directions
    are never selected among the smallest k) while staying within f32
    dynamic range *relative to the matrix entries*: a fixed huge constant
    (1e8+) makes f32 eigh lose the small eigenvalues entirely, where
    f32-eps * sentinel swamps the genuine couplings. diag(A) holds the
    Rayleigh quotients of the basis directions, which bound the wanted
    spectrum from above, so 10x its max is both safe and well-scaled.
    """
    return 10.0 * jnp.max(jnp.abs(jnp.diag(A))) + 1.0


def _b_orthonormalize(X, M, eps):
    """Spectral M-orthonormalization of a block; dropped directions -> 0.

    Columns are pre-normalized to unit M-norm so the Gram eigenvalues are
    O(1) and the relative filter `eps` is meaningful even for blocks whose
    raw columns have wildly different scales (e.g. near-converged
    residuals)."""
    d = jnp.sqrt(jnp.clip(jnp.sum(X * spmm(M, X), axis=0), 0.0))
    X = X * jnp.where(d > 0, 1.0 / jnp.clip(d, 1e-30), 0.0)[None, :]
    G = gram(X, spmm(M, X))
    Xw, good, _ = filtered_whiten(X, G, eps=eps)
    return Xw, good


def _project_out(Y, X, MX):
    """Remove the M-span of (M-orthonormal) X from Y: Y - X (X^T M Y).

    Applied twice — classical reorthogonalization for f32 robustness."""
    Y = Y - hdot(X, gram(MX, Y))
    return Y - hdot(X, gram(MX, Y))


@partial(jax.jit, static_argnames=("k", "max_iter"))
def lobpcg(
    K,
    M,
    X0: jax.Array,
    k: int | None = None,
    max_iter: int = 200,
    tol: float = 1e-6,
    whiten_eps: float = 1e-8,
    Y: jax.Array | None = None,
) -> LobpcgResult:
    """Smallest-k generalized eigenpairs from initial block X0 (N, k).

    `Y` (N, j), M-orthonormal: external DEFLATION constraints — the
    iteration is confined to the M-orthogonal complement of span(Y), so
    it converges to the smallest eigenpairs NOT in Y. This is how large
    mode counts are computed in blocks (see lobpcg_blocked): converged
    blocks become Y for the next sweep. Constraint handling is the
    classical one (Knyazev's lobpcg.py `Y`): X0, W and P are projected
    against Y every iteration.
    """
    if k is None:
        k = X0.shape[1]
    n = X0.shape[0]
    dtype = X0.dtype

    diagK = K.diagonal()
    precond = 1.0 / jnp.clip(diagK, 1e-12)
    MY = spmm(M, Y) if Y is not None else None

    def _deflate(V):
        return _project_out(V, Y, MY) if Y is not None else V

    def body(state):
        X, P, lam, it, _ = state
        # X is M-orthonormal on entry.
        MX = spmm(M, X)
        R = spmm(K, X) - MX * lam[None, :]
        res = jnp.linalg.norm(R, axis=0) / jnp.clip(jnp.abs(lam), 1.0)

        # Precondition and M-orthogonalize W against Y and X, then
        # orthonormalize.
        W = precond[:, None] * R
        W = _project_out(_deflate(W), X, MX)
        W, good_w = _b_orthonormalize(W, M, whiten_eps)
        # Same for the conjugate block P.
        MW = spmm(M, W)
        P = _project_out(_project_out(_deflate(P), X, MX), W, MW)
        P, good_p = _b_orthonormalize(P, M, whiten_eps)

        # S is (numerically) M-orthonormal -> standard Rayleigh-Ritz.
        S = jnp.concatenate([X, W, P], axis=1)  # (N, 3k)
        A = gram(S, spmm(K, S))
        good = jnp.concatenate(
            [jnp.ones((k,), bool), good_w, good_p])
        A = 0.5 * (A + A.T)
        A = A + jnp.diag(jnp.where(good, 0.0, _sentinel(A)))
        w, V = jnp.linalg.eigh(A)
        lam_new, C = w[:k], V[:, :k]
        X_new = hdot(S, C)
        P_new = hdot(S, C.at[:k, :].set(0.0))  # W/P contribution only
        return X_new, P_new, lam_new, it + 1, res

    def cond(state):
        _, _, _, it, res = state
        return jnp.logical_and(it < max_iter, jnp.max(res) > tol)

    # Start from an M-orthonormal X0 (deflated against Y); P starts at 0.
    X0, _ = _b_orthonormalize(_deflate(X0), M, whiten_eps)
    lam0 = jnp.diag(gram(X0, spmm(K, X0)))
    P0 = jnp.zeros_like(X0)
    state = (X0, P0, lam0, jnp.asarray(0), jnp.full((k,), jnp.inf, dtype))
    X, P, lam, it, res = jax.lax.while_loop(cond, body, state)

    # The Rayleigh-Ritz above treats S as M-orthonormal; in f32 its
    # blocks drift from that a little every iteration, more with N (a
    # defect of 5.5e-4 after 400 iterations at 300k nodes on the H100).
    # Re-whiten X and take one last Rayleigh-Ritz so the returned block
    # is M-orthonormal to f32 accuracy.
    X, good = _b_orthonormalize(X, M, whiten_eps)
    A = gram(X, spmm(K, X))
    A = 0.5 * (A + A.T)
    A = A + jnp.diag(jnp.where(good, 0.0, _sentinel(A)))
    lam, C = jnp.linalg.eigh(A)
    X = hdot(X, C)

    # Final residuals for reporting.
    R = spmm(K, X) - spmm(M, X) * lam[None, :]
    res = jnp.linalg.norm(R, axis=0) / jnp.clip(jnp.abs(lam), 1.0)
    return LobpcgResult(lam, X, it, res)


def lobpcg_from_random(K, M, k: int, key=None, dtype=jnp.float32, **kw):
    """Convenience: random init (plus the constant vector, which spans the
    lambda=0 rigid-body mode of closed-surface Laplacians)."""
    n = K.shape[0]
    if key is None:
        key = jax.random.PRNGKey(0)
    X0 = jax.random.normal(key, (n, k), dtype=dtype)
    X0 = X0.at[:, 0].set(1.0)
    return lobpcg(K, M, X0, k=k, **kw)


def lobpcg_blocked(
    K,
    M,
    k_total: int,
    block: int = 16,
    guard: int = 4,
    max_iter: int = 200,
    tol: float = 1e-6,
    key=None,
    dtype=jnp.float32,
    X0_full: jax.Array | None = None,
    checkpoint_dir: str = "",
    log_fn=None,
):
    """k_total smallest eigenpairs in deflated sweeps of `block` modes.

    Large mode counts (BASELINE config 5: 50 modes at 1M vertices) do not
    fit one LOBPCG block: the (N, 3k) basis and the O(k^2) Rayleigh-Ritz
    conditioning both degrade, and the edge of a big block converges far
    slower than its interior. Blocks of ~16 with `guard` extra vectors
    each, M-orthogonally DEFLATED against everything already converged
    (the `Y` constraint), keep every sweep well-conditioned at any
    k_total. `X0_full` (N, >= k_total) optionally warm-starts every block
    (e.g. prolongated coarse eigenvectors).

    `checkpoint_dir` persists every converged block (plus the PRNG key
    stream) to `<dir>/lobpcg_blocked.npz` and resumes from the last one
    on restart — a multi-hundred-second 1M x 50 sweep interrupted
    mid-run continues instead of restarting from zero, with bit-equal
    results (the restored key reproduces the block init sequence).

    Returns (eigenvalues (k_total,), eigenvectors (N, k_total),
    residual_norms (k_total,)) as numpy arrays.
    """
    import numpy as np

    n = K.shape[0]
    if key is None:
        key = jax.random.PRNGKey(0)
    # Fixed-width deflation basis (zero columns are inert in the
    # projector) so every sweep reuses ONE compiled executable.
    Y = jnp.zeros((n, k_total), dtype=dtype)
    vals, vecs, resids = [], [], []
    b0 = 0

    ckpt_path = None
    fingerprint = ""
    if checkpoint_dir:
        import hashlib
        import os

        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "lobpcg_blocked.npz")
        # Problem fingerprint: a same-shape checkpoint from a DIFFERENT
        # operator/tolerance must not be resumed (it would be returned
        # as the answer without a single solve iteration).
        h = hashlib.sha1()
        for op in (K, M):
            d = np.asarray(op.diagonal(), np.float64)
            h.update(d[:4096].tobytes())
        h.update(np.float64([tol, guard, max_iter]).tobytes())
        fingerprint = h.hexdigest()
        if os.path.exists(ckpt_path):
            z = np.load(ckpt_path)
            if (int(z["n"]) == n and int(z["k_total"]) == k_total
                    and int(z["block"]) == block
                    and str(z.get("fingerprint")) == fingerprint):
                b0 = int(z["b0"])
                if b0 > 0:
                    vals = [z["vals"]]
                    vecs = [z["vecs"]]
                    resids = [z["resids"]]
                    Y = jax.lax.dynamic_update_slice(
                        Y, jnp.asarray(z["vecs"], dtype), (0, 0))
                key = jnp.asarray(z["key"], jnp.uint32)
            else:
                import warnings

                warnings.warn(
                    "lobpcg_blocked: ignoring checkpoint in "
                    f"{checkpoint_dir} (different problem/settings)",
                    stacklevel=2)

    def _save(b_next, key_next):
        import os
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=checkpoint_dir, suffix=".npz")
        os.close(fd)
        np.savez(tmp, n=n, k_total=k_total, block=block, b0=b_next,
                 fingerprint=fingerprint,
                 vals=np.concatenate(vals),
                 vecs=np.concatenate(vecs, axis=1),
                 resids=np.concatenate(resids),
                 key=np.asarray(key_next))
        os.replace(tmp, ckpt_path)

    while b0 < k_total:
        keep = min(block, k_total - b0)
        kb = min(block + guard, k_total + guard - b0)
        key, sub = jax.random.split(key)
        X0 = jax.random.normal(sub, (n, kb), dtype=dtype)
        if X0_full is not None and b0 + keep <= X0_full.shape[1]:
            X0 = X0.at[:, :keep].set(
                jnp.asarray(X0_full[:, b0:b0 + keep], dtype=dtype))
        elif b0 == 0:
            X0 = X0.at[:, 0].set(1.0)   # rigid-body mode
        res = lobpcg(K, M, X0, k=kb, max_iter=max_iter, tol=tol, Y=Y)
        vals.append(np.asarray(res.eigenvalues[:keep]))
        vecs.append(np.asarray(res.eigenvectors[:, :keep]))
        resids.append(np.asarray(res.residual_norms[:keep]))
        if log_fn is not None:
            log_fn(b0, keep, res)
        Y = jax.lax.dynamic_update_slice(
            Y, res.eigenvectors[:, :keep], (0, b0))
        b0 += keep
        if ckpt_path is not None:
            _save(b0, key)
    if ckpt_path is not None:
        # A finished sweep's checkpoint must not shadow the next run.
        import os

        try:
            os.remove(ckpt_path)
        except OSError:
            pass
    return (np.concatenate(vals), np.concatenate(vecs, axis=1),
            np.concatenate(resids))
