"""Large-scale spectral basis driver: N-point cloud -> k eigenpairs.

The production path for BASELINE config 5 ("1M-vertex mesh spectral
basis, 50 deflated modes"): everything the reference would do with
robust_laplacian + ARPACK (delta_pinns_validation notebooks' `eigsh`
calls on the full operator) but sized for 10^6 nodes on one device:

  1. native C++ point-cloud Laplacian (geometry/point_cloud.py),
  2. coarse voxel subset -> host eigsh warm start -> kNN prolongation,
  3. a tiled device operator — strip-BSR (sparse/bsr.py) or
     cluster-ordered SplitBanded (sparse/split.py); see
     `operator_format` below,
  4. blocked deflated LOBPCG (solvers/lobpcg.lobpcg_blocked): sweeps of
     ~16 modes, each M-orthogonally deflated against all converged ones.

Solve time and accuracy on the H100 at 1M nodes: not measured.

Replaces: the reference's ARPACK-on-full-operator pattern
(src/utils.py:171-178 `compute_eigenvalues`), which at 1M nodes needs a
sparse factorization per shift and does not fit its workflow.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class SpectralBasisResult:
    eigenvalues: np.ndarray     # (k,)
    eigenvectors: np.ndarray    # (n, k) in ORIGINAL point order
    residual_norms: np.ndarray  # (k,) scaled |Ku - lam Mu| / |lam|
    timings: dict


def spectral_basis(
    X: np.ndarray,
    k: int = 50,
    n_neighbors: int = 15,
    coarse_n: int = 65536,
    prolongation_neighbors: int = 8,
    window: int = 1024,
    block: int = 16,
    guard: int = 4,
    max_iter: int = 120,
    tol: float = 2e-4,
    operators=None,
    operator_format: str = "bsr",
    operator_precision: str = "highest",
    n_devices: int | None = None,
    mesh=None,
    checkpoint_dir: str = "",
    log_fn=print,
) -> SpectralBasisResult:
    """Smallest-k Laplace-Beltrami eigenpairs of an (n, 3) point cloud.

    `operators`: optional pre-built (L_csr, m_diag) pair to skip the
    Laplacian build (e.g. when cached on disk).

    `operator_format`: 'bsr' (strip-BSR, default) or 'split'
    (cluster-ordered banded core + gather remainder; `window` applies to
    this format only). 'split' needs a cluster ordering on the host
    and holds less device memory; which format solves faster on the
    H100 is not measured.

    `operator_precision`: precision of the solver's K-applies
    (sparse.ops.operator_dot) — 'highest' (default; full f32) or 'high'
    (TF32 on the H100, ~3e-4 relative error per product; the LOBPCG
    orthogonalization/Rayleigh-Ritz arithmetic stays f32-HIGHEST
    regardless). The residual cannot fall below the operator's own
    rounding, so 'high' is for tol >= 1e-2 screening passes only.

    `n_devices`/`mesh`: run the blocked solve node-sharded over a
    `jax.sharding.Mesh` (solvers/lobpcg_sharded.py — halo-banded /
    cluster-split sharded SpMM, psum'd Grams). `operator_format` is
    ignored on this path (the sharded builder picks banded vs split
    from the operator's stencil).
    """
    import jax
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sampling.knn import prolongation_matrix
    from eigenpinns_tpu.sampling.samplers import voxel_levels
    from eigenpinns_tpu.solvers.lobpcg import lobpcg_blocked
    from eigenpinns_tpu.solvers.oracle import eigsh_smallest
    from eigenpinns_tpu.sparse import Diagonal, SplitBanded

    timings = {}
    n = X.shape[0]

    t0 = time.time()
    if operators is not None:
        L, m_diag = operators
    else:
        L, M = point_cloud_laplacian(X, n_neighbors=n_neighbors)
        m_diag = np.asarray(M.diagonal()).ravel()
    timings["laplacian_s"] = time.time() - t0

    # Coarse warm start: eigsh on a voxel subset, prolongated up. The
    # subset spectrum approximates the fine one well enough that every
    # LOBPCG block starts near its target invariant subspace.
    t0 = time.time()
    coarse_n = min(coarse_n, n)
    if coarse_n < n:
        idx = voxel_levels(X, [coarse_n])[0]
        Xc = X[idx]
        Lc, Mc = point_cloud_laplacian(Xc, n_neighbors=n_neighbors)
        _, vecs_c = eigsh_smallest(Lc, Mc, k)
        P = prolongation_matrix(Xc, X, prolongation_neighbors)
        X0_full = (P @ vecs_c).astype(np.float32)
    else:
        import scipy.sparse as sp

        _, X0_full = eigsh_smallest(L, sp.diags(m_diag).tocsr(), k)
        X0_full = X0_full.astype(np.float32)
    timings["warm_start_s"] = time.time() - t0

    if n_devices is not None or mesh is not None:
        # Distributed path: the same blocked deflated sweeps over the
        # node-sharded halo SpMM.
        import scipy.sparse as sp

        from eigenpinns_tpu.solvers.lobpcg_sharded import lobpcg_sharded

        if operator_precision != "highest":
            import warnings

            warnings.warn(
                "operator_precision is not supported on the sharded "
                "path (halo-banded ops run f32-HIGHEST); solving at "
                "'highest'", stacklevel=2)
        t0 = time.time()
        vals, vecs, resids = lobpcg_sharded(
            L, sp.diags(m_diag).tocsr(), k, mesh=mesh,
            n_devices=n_devices, X=np.asarray(X), X0=X0_full,
            block=block, guard=guard, max_iter=max_iter, tol=tol,
            window=window, checkpoint_dir=checkpoint_dir,
            log_fn=(None if log_fn is None else
                    lambda b0, keep, r: log_fn(
                        f"  modes [{b0}:{b0 + keep}] converged")))
        timings["solve_s"] = time.time() - t0
        return SpectralBasisResult(vals, vecs, resids, timings)

    t0 = time.time()
    if operator_format == "bsr":
        from eigenpinns_tpu.sparse import BSRTile

        op, perm = BSRTile.from_scipy(L)
        jax.block_until_ready(op.data)
    else:
        op, perm = SplitBanded.from_scipy(L, X=np.asarray(X),
                                          window=window)
        jax.block_until_ready(op.core.band)
    if operator_precision != "highest" and hasattr(op, "with_precision"):
        # strip-BSR only; SplitBanded has no reduced-precision variant.
        op = op.with_precision(operator_precision)
    M_op = Diagonal(jnp.asarray(m_diag[perm], jnp.float32))
    timings["operator_s"] = time.time() - t0

    def _log(b0, keep, res):
        if log_fn is not None:
            log_fn(f"  modes [{b0}:{b0 + keep}] converged, "
                   f"max scaled res "
                   f"{float(np.max(np.asarray(res.residual_norms[:keep]))):.2e}")

    t0 = time.time()
    vals, vecs, resids = lobpcg_blocked(
        op, M_op, k, block=block, guard=guard, max_iter=max_iter,
        tol=tol, X0_full=jnp.asarray(X0_full[perm]),
        checkpoint_dir=checkpoint_dir, log_fn=_log)
    timings["solve_s"] = time.time() - t0

    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return SpectralBasisResult(vals, vecs[inv], resids, timings)


def spectral_basis_family(
    X_list,
    k: int = 50,
    n_neighbors: int = 15,
    coarse_n: int = 65536,
    prolongation_neighbors: int = 8,
    block: int = 16,
    guard: int = 4,
    max_iter: int = 120,
    tol: float = 2e-4,
    log_fn=print,
) -> list:
    """`spectral_basis` over a FAMILY of point clouds with ONE compiled
    solver executable (BASELINE config 5's "batched over a mesh family"
    at spectral-basis scale).

    vmap-batching (solvers/batched.py) tops out where a single member's
    operator already fills the chip; here the batching is COMPILE-level
    instead: every member's strip-BSR operator is padded to the family's
    common (rows, strip width) shape, so the jitted LOBPCG program —
    traced once for the first member — is reused verbatim for the rest
    (zero rows/width are inert in the Gram arithmetic). Returns a list
    of SpectralBasisResult in input order.
    """
    import jax
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sampling.knn import prolongation_matrix
    from eigenpinns_tpu.sampling.samplers import voxel_levels
    from eigenpinns_tpu.solvers.lobpcg import lobpcg_blocked
    from eigenpinns_tpu.solvers.oracle import eigsh_smallest
    from eigenpinns_tpu.sparse import Diagonal
    from eigenpinns_tpu.sparse.bsr import BSRTile, _round_up

    # Pass 1 (host): Laplacians + the family's common padded shape.
    probs = []
    for X in X_list:
        L, M = point_cloud_laplacian(np.asarray(X),
                                     n_neighbors=n_neighbors)
        probs.append((np.asarray(X), L,
                      np.asarray(M.diagonal()).ravel()))
    n_pad = _round_up(max(L.shape[0] for _, L, _ in probs), 128)
    # Probe each member's natural chunk count at the common row count.
    # static_layout=False: the layout tables become traced operands so
    # every same-shape member reuses ONE compiled executable (the whole
    # point of the family padding; costs ~4% kernel time vs the
    # compile-specialized static layout).
    n_chunks = 0
    ops = []
    for X, L, m_diag in probs:
        op, perm = BSRTile.from_scipy(L, pad_rows_to=n_pad,
                                      static_layout=False)
        n_chunks = max(n_chunks, op.n_chunks)
        ops.append((op, perm))
    # Rebuild any member below the common chunk count (host-side; the
    # RCM ordering is reused, only zero pad chunks are appended).
    ops = [(op, perm) if op.n_chunks == n_chunks else
           BSRTile.from_scipy(L, pad_rows_to=n_pad,
                              pad_chunks_to=n_chunks,
                              perm=perm, static_layout=False)
           for (op, perm), (_, L, _) in zip(ops, probs)]

    results = []
    for (op, perm), (X, L, m_diag) in zip(ops, probs):
        n = X.shape[0]
        timings = {}
        t0 = time.time()
        coarse = min(coarse_n, n)
        if coarse < n:
            idx = voxel_levels(X, [coarse])[0]
            Lc, Mc = point_cloud_laplacian(X[idx],
                                           n_neighbors=n_neighbors)
            _, vecs_c = eigsh_smallest(Lc, Mc, k)
            P = prolongation_matrix(X[idx], X, prolongation_neighbors)
            X0 = (P @ vecs_c).astype(np.float32)
        else:
            import scipy.sparse as sp

            _, X0 = eigsh_smallest(L, sp.diags(m_diag).tocsr(), k)
            X0 = X0.astype(np.float32)
        timings["warm_start_s"] = time.time() - t0

        d = np.zeros(n_pad, np.float32)
        d[:n] = m_diag[perm]
        M_op = Diagonal(jnp.asarray(d))
        X0p = np.zeros((n_pad, k), np.float32)
        X0p[:n] = X0[perm]          # op row order; padded rows stay zero
        t0 = time.time()
        vals, vecs, resids = lobpcg_blocked(
            op, M_op, k, block=block, guard=guard, max_iter=max_iter,
            tol=tol, X0_full=jnp.asarray(X0p),
            log_fn=None if log_fn is None else
            (lambda b0, keep, r: log_fn(f"  [{n}v] modes [{b0}:{b0+keep}]")))
        timings["solve_s"] = time.time() - t0
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        results.append(SpectralBasisResult(vals, vecs[:n][inv], resids,
                                           timings))
    return results
