"""Matrix-only hierarchical eigensolver with neural upscalers.

Capability parity with `hierarchical_eigensolve`
(downsampling_toy_example.ipynb cell 0:223-250): works directly on a
(K, M) matrix pair without geometry, refining coarse eigenvectors
level-by-level with a per-eigenpair MLP upscaler (trainable lambda),
losses = residual + decaying normalization + deflation orthogonality +
1D smoothness, finishing each level with a simple Rayleigh-quotient +
Gram-Schmidt refinement (cell 0:78-97).

DELIBERATE DEVIATION: the reference builds coarse operators by raw index
subsampling `K[np.ix_(idx, idx)]` (cell 0:20-57), which DESTROYS banded
connectivity — subsampling a tridiagonal Laplacian at stride >= 2 yields
diag(2) and a meaningless all-equal coarse spectrum (verified). Coarse
operators here are GALERKIN products K_c = P^T K P with P the
index-position linear-interpolation prolongation — the algebraic-
multigrid construction that actually preserves the low spectrum. The
upscaler itself (per-pair MLP + trainable lambda) is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from eigenpinns_tpu.models import HierarchicalUpscaler
from eigenpinns_tpu.sparse import as_operator, spmm
from eigenpinns_tpu.train.loop import run_scan_loop
from eigenpinns_tpu.utils.fixtures import subsample_hierarchy


class UpscaleState(NamedTuple):
    params: object
    opt_state: object


@dataclasses.dataclass
class UpscaleResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    level_sizes: list


def _refine(U, lam, K, M):
    """Per-vector refinement (cell 0:78-97): Rayleigh quotient, modified
    Gram-Schmidt in M, M-normalization."""
    k = U.shape[1]
    cols = []
    for i in range(k):
        v = U[:, i]
        for u_prev in cols:
            v = v - (v @ spmm(M, u_prev[:, None])[:, 0]) * u_prev
        v = v / jnp.sqrt(v @ spmm(M, v[:, None])[:, 0] + 1e-12)
        cols.append(v)
    U = jnp.stack(cols, axis=1)
    Ku, Mu = spmm(K, U), spmm(M, U)
    lam = jnp.sum(U * Ku, axis=0) / (jnp.sum(U * Mu, axis=0) + 1e-12)
    return U, lam


def hierarchical_eigensolve(
    K,
    M,
    n_pairs: int,
    levels: list[int],
    sampling: str = "uniform",
    hidden=(64, 64),
    epochs_per_level: int = 1500,
    scan_chunk: int = 250,
    lr: float = 2e-3,
    w_res: float = 1.0,
    w_norm0: float = 10.0,
    norm_decay: float = 100.0,
    norm_floor: float = 0.05,
    w_defl: float = 10.0,
    w_smooth: float = 0.0,
    seed: int = 0,
) -> UpscaleResult:
    """Solve the smallest n_pairs of K u = lam M u through a subsampled
    matrix hierarchy with neural coarse->fine upscaling."""
    import scipy.sparse as sp

    n = K.shape[0]
    K = K.tocsr() if sp.issparse(K) else sp.csr_matrix(K)
    M = M.tocsr() if sp.issparse(M) else sp.csr_matrix(M)
    idx_levels = subsample_hierarchy(n, levels, method=sampling, K=K,
                                     seed=seed)

    def interp_matrix(pos_c, pos_f):
        """(n_f, n_c) linear-interpolation prolongation over positions."""
        j = np.searchsorted(pos_c, pos_f, side="right") - 1
        j = np.clip(j, 0, len(pos_c) - 2)
        t = (pos_f - pos_c[j]) / np.maximum(pos_c[j + 1] - pos_c[j], 1e-12)
        t = np.clip(t, 0.0, 1.0)
        rows = np.repeat(np.arange(len(pos_f)), 2)
        cols = np.stack([j, j + 1], axis=1).reshape(-1)
        vals_ = np.stack([1 - t, t], axis=1).reshape(-1)
        return sp.coo_matrix((vals_, (rows, cols)),
                             shape=(len(pos_f), len(pos_c))).tocsr()

    # Galerkin coarse operators from the finest down (see module
    # docstring for why raw K[ix, ix] subsampling is unusable).
    K_levels, M_levels, P_list = [K], [M], []
    for level in range(len(idx_levels) - 1, 0, -1):
        pos_f = idx_levels[level].astype(np.float64)
        pos_c = idx_levels[level - 1].astype(np.float64)
        P = interp_matrix(pos_c, pos_f)
        P_list.insert(0, P)
        K_levels.insert(0, (P.T @ K_levels[0] @ P).tocsr())
        M_levels.insert(0, (P.T @ M_levels[0] @ P).tocsr())

    # Coarsest exact solve.
    from eigenpinns_tpu.solvers.oracle import eigsh_smallest

    vals, U = eigsh_smallest(K_levels[0], M_levels[0],
                             min(n_pairs, len(idx_levels[0]) - 2))
    U = jnp.asarray(U, jnp.float32)
    lam = jnp.asarray(vals, jnp.float32)

    for level in range(1, len(idx_levels)):
        idx = idx_levels[level]
        n_f = len(idx)
        K_l = as_operator(K_levels[level])
        M_l = as_operator(M_levels[level])
        P = P_list[level - 1]
        new_cols = []
        new_lams = []
        for pair in range(U.shape[1]):
            u_c = U[:, pair]
            base = jnp.asarray(P @ np.asarray(u_c, np.float64),
                               jnp.float32)
            model = HierarchicalUpscaler(tuple(hidden), n_f,
                                         lambda_init=float(lam[pair]))
            params = model.init(
                jax.random.PRNGKey(seed + 101 * level + pair), u_c, base)
            opt = optax.adam(lr)
            opt_state = opt.init(params)
            U_prev = (jnp.stack(new_cols, axis=1) if new_cols
                      else jnp.zeros((n_f, 1), jnp.float32))
            have_prev = bool(new_cols)

            def loss_fn(params, epoch):
                u_f, lam_f = model.apply(params, u_c, base)
                Mu = spmm(M_l, u_f[:, None])[:, 0]
                Ku = spmm(K_l, u_f[:, None])[:, 0]
                res = jnp.mean((Ku - lam_f * Mu) ** 2)
                loss = w_res * res
                decay = jnp.exp(-epoch.astype(jnp.float32) / norm_decay)
                w_norm = w_norm0 * (norm_floor + (1 - norm_floor) * decay)
                loss = loss + w_norm * (u_f @ Mu - 1.0) ** 2
                if have_prev:
                    loss = loss + w_defl * jnp.sum((Mu @ U_prev) ** 2)
                if w_smooth:
                    loss = loss + w_smooth * jnp.mean(
                        (u_f[1:] - u_f[:-1]) ** 2)
                return loss, {"loss": loss, "lam": lam_f}

            def step(state: UpscaleState, epoch):
                (_, metrics), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(state.params, epoch)
                updates, opt_state = opt.update(grads, state.opt_state)
                params = optax.apply_updates(state.params, updates)
                return UpscaleState(params, opt_state), metrics

            result = run_scan_loop(step, UpscaleState(params, opt_state),
                                   n_epochs=epochs_per_level,
                                   chunk=scan_chunk)
            u_f, lam_f = model.apply(result.state.params, u_c, base)
            new_cols.append(u_f)
            new_lams.append(lam_f)
        U = jnp.stack(new_cols, axis=1)
        lam = jnp.stack(new_lams)
        U, lam = _refine(U, lam, K_l, M_l)

    return UpscaleResult(
        eigenvalues=np.asarray(lam),
        eigenvectors=np.asarray(U),
        level_sizes=[len(i) for i in idx_levels],
    )
