"""Node-sharded LOBPCG — the distributed solver path.

Completes the BASELINE north-star distributed mode for the SOLVER side
(direct_sharded.py covers training): eigenvector blocks are row-sharded
over a `jax.sharding.Mesh`'s "data" axis, K U / M U ride the halo-banded
sharded SpMM (two (B, k) ppermutes over ICI per product —
parallel/sharded_banded.py, cluster-split remainder at 1M scale), and
every k x k reduction (Grams, Rayleigh-Ritz projections) is a jnp
reduction over the sharded node axis that GSPMD turns into local
partials + psum. The 3k x 3k eigensolve is replicated.

The iteration itself is literally `solvers/lobpcg.py` — the sharded
SpMMs enter through a `FunctionOperator` (sparse/ops.py), so the
deflation constraint `Y` and `lobpcg_blocked`'s many-mode sweeps work
sharded unchanged.

Equality with the single-device solver is asserted on an 8-device CPU
mesh in tests/test_parallel.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from eigenpinns_tpu.solvers.direct_sharded import (
    ShardedProblem,
    prepare_sharded_problem,
)
from eigenpinns_tpu.sparse.ops import FunctionOperator


def _sharded_operators(prob: ShardedProblem, K, M):
    """FunctionOperator pair over the sharded SpMMs, diagonals in the
    permuted+padded layout."""
    n, n_pad, perm = prob.n, prob.n_pad, prob.perm
    dK = np.zeros(n_pad, np.float32)
    dK[:n] = np.asarray(K.tocsr().diagonal(), np.float32)[perm]
    shard = NamedSharding(prob.mesh, P("data"))
    Kop = FunctionOperator(prob.spmm_K,
                           jax.device_put(jnp.asarray(dK), shard))
    if prob.m_diag is not None:
        dM = prob.m_diag
    else:
        dM = np.zeros(n_pad, np.float32)
        dM[:n] = np.asarray(M.tocsr().diagonal(), np.float32)[perm]
        dM = jnp.asarray(dM)
    Mop = FunctionOperator(prob.spmm_M, jax.device_put(dM, shard))
    return Kop, Mop


def lobpcg_sharded(
    K,
    M,
    k: int,
    mesh=None,
    n_devices: int | None = None,
    X=None,
    X0: np.ndarray | None = None,
    block: int = 0,
    guard: int = 4,
    max_iter: int = 200,
    tol: float = 1e-6,
    seed: int = 0,
    max_bandwidth: int = 4096,
    window: int = 1024,
    problem: ShardedProblem | None = None,
    checkpoint_dir: str = "",
    log_fn=None,
):
    """Smallest-k generalized eigenpairs of scipy (K, M), node-sharded.

    `X` ((n, 3) coordinates) enables the cluster ordering fallback for
    operators whose RCM stencil does not fit a one-neighbor halo.
    `X0` ((n, >=k), CALLER vertex order) warm-starts the block(s).
    `block` > 0 switches to deflated sweeps (`lobpcg_blocked`) for
    large k. Returns (eigenvalues (k,), eigenvectors (n, k) in the
    caller's vertex order, residual_norms (k,)).
    """
    from eigenpinns_tpu.solvers.lobpcg import lobpcg, lobpcg_blocked

    prob = problem if problem is not None else prepare_sharded_problem(
        K, M, X=X, mesh=mesh, n_devices=n_devices,
        max_bandwidth=max_bandwidth, window=window)
    n, n_pad, perm = prob.n, prob.n_pad, prob.perm
    Kop, Mop = _sharded_operators(prob, K, M)
    shard = NamedSharding(prob.mesh, P("data"))

    def _pad_shard(V):
        Vp = np.zeros((n_pad, V.shape[1]), np.float32)
        Vp[:n] = np.asarray(V, np.float32)[perm]
        return jax.device_put(jnp.asarray(Vp), shard)

    if X0 is not None:
        X0p = _pad_shard(X0)
    else:
        key = jax.random.PRNGKey(seed)
        width = k if not block else max(k, block + guard)
        X0h = np.array(
            jax.random.normal(key, (n, max(k, width))), np.float32)
        X0h[:, 0] = 1.0          # rigid-body mode of closed surfaces
        X0p = _pad_shard(X0h)

    if block:
        vals, vecs, resids = lobpcg_blocked(
            Kop, Mop, k, block=block, guard=guard, max_iter=max_iter,
            tol=tol, X0_full=X0p, checkpoint_dir=checkpoint_dir,
            log_fn=log_fn)
    else:
        res = lobpcg(Kop, Mop, X0p[:, :k], k=k, max_iter=max_iter,
                     tol=tol)
        vals = np.asarray(res.eigenvalues)
        vecs = np.asarray(res.eigenvectors)
        resids = np.asarray(res.residual_norms)

    out = np.empty((n, k), vecs.dtype)
    out[perm] = vecs[:n]
    return vals, out, resids
