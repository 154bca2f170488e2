"""Split operators: banded core + sparse remainder, for large clouds.

Global RCM ordering of a surface-sampled cloud has bandwidth ~ the sweep
front (measured 6k at 1M points), making the fully-banded format cost
24 GB. The fix is geometric: cluster the nodes spatially (FPS centers +
nearest-center assignment), order clusters contiguously with RCM inside
each, and DECOMPOSE the operator

    A = A_band + A_rem

where A_band holds every entry inside a capped per-tile window (the
intra-cluster bulk — dense tile matmuls of banded.py) and A_rem holds
the few cluster-boundary entries (gather-ELL with its scatter-free VJP).
SpMM = banded_spmm + ell spmm; both parts already differentiate without
scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from eigenpinns_tpu.sparse.banded import (
    BandedELL,
    _round_up,
    banded_spmm,
    banded_spmm_gram,
)
from eigenpinns_tpu.sparse.formats import SparseELL
from eigenpinns_tpu.sparse.ops import spmm as _ell_dispatch_spmm


def hilbert_order(X: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a 3D Hilbert curve.

    For surface-sampled clouds this is a stronger locality ordering than
    global RCM: measured on the 300k bench cloud, RCM leaves bandwidth
    W=3491 while the Hilbert ordering puts the median kNN-neighbor index
    spread at ~3 with a short tail — so a capped banded core (window 512)
    captures ~98% of nnz at ~4x fewer band bytes than the RCM band.
    Vectorized Skilling transform (transpose-to-axes inverse): Gray
    decode + per-bit exchange/invert, then bit interleave.
    """
    X = np.asarray(X, dtype=np.float64)
    Xq = X - X.min(0)
    scale = Xq.max()
    if scale <= 0:
        return np.arange(X.shape[0], dtype=np.int64)
    Xq = (Xq / scale * ((1 << bits) - 1)).astype(np.uint64)
    c = Xq.T.copy()  # (3, N) axis-major coordinates
    n_ax = 3
    top = np.uint64(1) << np.uint64(bits - 1)
    q = top
    while q > np.uint64(1):
        p = q - np.uint64(1)
        for i in range(n_ax):
            mask = (c[i] & q) > 0
            c[0][mask] ^= p
            t = (c[0] ^ c[i]) & p
            c[0][~mask] ^= t[~mask]
            c[i][~mask] ^= t[~mask]
        q >>= np.uint64(1)
    for i in range(1, n_ax):
        c[i] ^= c[i - 1]
    t = np.zeros(c.shape[1], dtype=np.uint64)
    q = top
    while q > np.uint64(1):
        mask = (c[n_ax - 1] & q) > 0
        t[mask] ^= q - np.uint64(1)
        q >>= np.uint64(1)
    for i in range(n_ax):
        c[i] ^= t
    key = np.zeros(c.shape[1], dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(n_ax):
            key = (key << np.uint64(1)) | ((c[i] >> np.uint64(b))
                                           & np.uint64(1))
    return np.argsort(key, kind="stable")


def spatial_cluster_order(X: np.ndarray, n_clusters: int,
                          adjacency=None) -> np.ndarray:
    """Permutation grouping nodes into spatially contiguous clusters.

    FPS picks well-spread centers, each node joins its nearest center,
    and nodes are ordered (cluster, RCM-within-cluster). Returns perm
    such that X[perm] is cluster-contiguous.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import cKDTree

    from eigenpinns_tpu.sampling.samplers import farthest_point_indices

    n = X.shape[0]
    centers = farthest_point_indices(X, min(n_clusters, n), seed=0)
    _, assign = cKDTree(X[centers]).query(X, k=1)
    # One global cluster-sort, then per-cluster RCM on diagonal blocks
    # extracted from COO by range masks — scipy's np.ix_ fancy indexing
    # on a 1M-row CSR takes minutes, this path takes seconds.
    order0 = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order0], np.arange(len(centers) + 1))
    perm = order0.copy()
    if adjacency is not None:
        inv = np.empty(n, dtype=np.int64)
        inv[order0] = np.arange(n)
        coo = adjacency.tocoo()
        r = inv[coo.row]
        c = inv[coo.col]
        cluster_of = np.searchsorted(bounds, r, side="right") - 1
        same = cluster_of == (np.searchsorted(bounds, c, side="right") - 1)
        rs, cs, ds = r[same], c[same], coo.data[same]
        for ci in range(len(centers)):
            lo, hi = bounds[ci], bounds[ci + 1]
            m = hi - lo
            if m <= 2:
                continue
            sel = (rs >= lo) & (rs < hi)
            block = sp.coo_matrix(
                (ds[sel], (rs[sel] - lo, cs[sel] - lo)),
                shape=(m, m)).tocsr()
            local = np.asarray(reverse_cuthill_mckee(
                block, symmetric_mode=True))
            perm[lo:hi] = order0[lo:hi][local]
    return perm


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SplitBanded:
    """A = banded core + ELL remainder (both scatter-free in fwd and bwd)."""

    core: Any        # BandedELL
    remainder: Any   # SparseELL | None

    def tree_flatten(self):
        if self.remainder is None:
            return (self.core,), (False,)
        return (self.core, self.remainder), (True,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        if aux[0]:
            return cls(children[0], children[1])
        return cls(children[0], None)

    @property
    def shape(self):
        return self.core.shape

    @property
    def n(self):
        return self.core.n

    def diagonal(self) -> jax.Array:
        d = self.core.diagonal()
        if self.remainder is not None:
            d = d + self.remainder.diagonal()
        return d

    @classmethod
    def from_scipy(cls, A, X: np.ndarray | None = None,
                   dtype=jnp.float32, tile: int = 128,
                   window: int = 1024, n_clusters: int | None = None,
                   order: str | np.ndarray = "cluster"):
        """Decompose a (pre-permutation) operator.

        When X is given, a locality ordering is computed first and the
        returned perm must be applied to all node data. `window` caps the
        banded core's width; everything outside lands in the remainder.
        `order` picks the ordering: 'cluster' (FPS centers + per-cluster
        RCM — the 1M spectral-basis default), 'hilbert' (space-filling
        curve; tighter windows on surface clouds, so it pairs with small
        `window` for training operators), or an explicit permutation
        array. Without X, falls back to global RCM. Returns (op, perm).
        """
        import scipy.sparse as sp

        A = A.tocsr()
        A.sum_duplicates()
        n = A.shape[0]
        # The banded core's VJP applies the core itself as A^T (no
        # transpose core is attached on this path), and the remainder's
        # mirror entries may land in the core — both assume NUMERIC
        # symmetry, not just pattern symmetry. Reject anything else.
        d = (A - A.T).tocsr()
        if d.nnz and abs(d).max() > 1e-6 * max(abs(A).max(), 1e-300):
            raise ValueError(
                "SplitBanded requires a numerically symmetric operator "
                f"(max |A - A^T| = {abs(d).max():.3g}); use "
                "SparseELL/BandedELL.from_scipy, which attach an explicit "
                "transpose for the VJP")
        if isinstance(order, np.ndarray):
            perm = np.asarray(order, dtype=np.int64)
            if perm.shape != (n,):
                raise ValueError(
                    f"explicit order has shape {perm.shape}, expected ({n},)")
        elif X is not None and order == "hilbert":
            perm = hilbert_order(np.asarray(X))
        elif X is not None:
            if order != "cluster":
                raise ValueError(f"unknown order {order!r}")
            if n_clusters is None:
                n_clusters = max(1, int(np.ceil(n / max(window * 24, 1))))
                n_clusters = max(n_clusters, int(np.ceil(n / 100_000)))
            perm = spatial_cluster_order(np.asarray(X), n_clusters,
                                         adjacency=A)
        else:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm].tocsr()

        n_pad = _round_up(max(n, tile), tile)
        B = _round_up(min(window, n_pad), 128)
        # Row-centered windows: keep the diagonal inside every window (the
        # symmetric-mirror band test needs it; data-driven centers were
        # tried and lose badly — junction tiles average into the gap
        # between clusters and capture neither side).
        t_ids = np.arange(n_pad // tile)
        starts = np.clip(t_ids * tile + tile // 2 - B // 2, 0,
                         max(n_pad - B, 0)).astype(np.int64)

        coo = Ap.tocoo()
        tile_of_row = coo.row // tile
        local = coo.col - starts[tile_of_row]
        in_band = (local >= 0) & (local < B)
        # Keep the core SYMMETRIC (banded_spmm's VJP applies the core to
        # the cotangent): an entry stays in the band only if its mirror
        # (j, i) also fits its own tile's window; stragglers join the
        # remainder, which carries an explicit transpose.
        local_m = coo.row - starts[coo.col // tile]
        in_band &= (local_m >= 0) & (local_m < B)

        band = np.zeros((n_pad, B), dtype=np.dtype(jnp.dtype(dtype).name))
        band[coo.row[in_band], local[in_band]] = \
            coo.data[in_band].astype(band.dtype)
        core = BandedELL(jnp.asarray(band),
                         jnp.asarray(starts.astype(np.int32)), n, n, tile)

        remainder = None
        n_out = int((~in_band).sum())
        if n_out:
            rem = sp.coo_matrix(
                (coo.data[~in_band],
                 (coo.row[~in_band], coo.col[~in_band])),
                shape=(n, n)).tocsr()
            # The remainder is tiny (a few % of nnz) — keep it f32 even
            # for bf16 cores; its accuracy is free.
            rem_dtype = (jnp.float32 if jnp.dtype(dtype) == jnp.bfloat16
                         else dtype)
            remainder = SparseELL.from_scipy(rem, dtype=rem_dtype)
        return cls(core, remainder), perm

    @property
    def remainder_nnz_fraction(self) -> float:
        if self.remainder is None:
            return 0.0
        rem = float(np.count_nonzero(np.asarray(self.remainder.values)))
        core = float(np.count_nonzero(np.asarray(self.core.band)))
        return rem / max(rem + core, 1.0)


def split_spmm(A: SplitBanded, U: jax.Array) -> jax.Array:
    out = banded_spmm(A.core, U)
    if A.remainder is not None:
        out = out + _ell_dispatch_spmm(A.remainder, U)
    return out


def split_spmm_gram(A: SplitBanded, U: jax.Array):
    """(A @ U, U^T A U): Gram of the banded core, plus the thin
    remainder correction U^T (A_rem U)."""
    from eigenpinns_tpu.sparse.ops import gram

    W, G = banded_spmm_gram(A.core, U)
    if A.remainder is not None:
        Wr = _ell_dispatch_spmm(A.remainder, U)
        W = W + Wr
        G = G + gram(U, Wr)
    return W, G
