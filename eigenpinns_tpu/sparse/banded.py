"""Banded-dense sparse format: mesh Laplacians as dense tile matmuls.

Mesh/kNN Laplacians are LOCAL operators: after a bandwidth-minimizing
reordering (reverse Cuthill-McKee), every nonzero of row i lies within a
narrow window of columns around i. That makes SpMM expressible as dense
tile matmuls:

  for each tile of T=128 rows: out[tile] = band[tile] @ U[window(tile)]

with band[tile] the densified (T, B) slice of A and window(tile) a
contiguous (B, k) slice of U. B is the maximum per-tile column spread
(rounded to 128). The densified matmul does B/W times more FLOPs than the
gather (W = max row degree); XLA lowers the batched tile products to
dense matrix-multiply kernels.

`BandedELL.from_scipy` computes the RCM permutation; callers apply it to
node-indexed data once in preprocessing.

WHEN TO USE: the densification multiplies FLOPs and memory by B/W
(bandwidth over max row degree). Surface meshes have RCM bandwidth
O(sqrt(N)) (bunny: B=384 vs W=16); volumetric/noisy clouds can hit B in
the tens of thousands (12.8k on a 100k slab cloud), where banded-dense
loses outright. `from_scipy` enforces `max_bandwidth` so callers use the
gather-ELL path (whose fwd AND bwd are scatter-free, ops._ell_spmm)
rather than silently allocating gigabytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BandedELL:
    """Row-tiled banded-dense matrix (symmetric operators).

    band:   (N_pad, B) float — densified rows, columns relative to the
            tile's window start
    starts: (n_tiles,) int32 — window start row of U for each tile
    n:      true row count (N_pad = round_up(n, tile))
    n_cols: column count of the (square) operator
    tile:   rows per tile (static)
    """

    band: Any
    starts: Any
    n: int
    n_cols: int
    tile: int
    transpose_banded: Any = None  # BandedELL | None (None = symmetric)

    def tree_flatten(self):
        if self.transpose_banded is None:
            return ((self.band, self.starts),
                    (self.n, self.n_cols, self.tile, False))
        return ((self.band, self.starts, self.transpose_banded),
                (self.n, self.n_cols, self.tile, True))

    @classmethod
    def tree_unflatten(cls, aux, children):
        n, n_cols, tile, has_t = aux
        if has_t:
            return cls(children[0], children[1], n, n_cols, tile,
                       children[2])
        return cls(children[0], children[1], n, n_cols, tile)

    @property
    def bandwidth(self) -> int:
        return self.band.shape[1]

    @property
    def shape(self):
        return (self.n, self.n_cols)

    def diagonal(self) -> jax.Array:
        """Main diagonal: row i's entry sits at band[i, i - starts[tile]]."""
        n_pad = self.band.shape[0]
        rows = jnp.arange(n_pad)
        local = rows - self.starts[rows // self.tile]
        local = jnp.clip(local, 0, self.bandwidth - 1)
        return self.band[rows, local][: self.n]

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32, tile: int = 128,
                   reorder: bool = True, max_bandwidth: int = 4096,
                   with_transpose: bool = True):
        """Convert a (symmetric) scipy sparse matrix.

        Returns (op, perm) where perm is the RCM permutation applied —
        op represents P A P^T; SpMM inputs/outputs live in permuted order.
        Raises ValueError when the post-RCM bandwidth exceeds
        `max_bandwidth` (densification would be counterproductive — use
        the gather-ELL path instead).
        """
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        A = A.tocsr()
        A.sum_duplicates()
        n = A.shape[0]
        if reorder:
            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        else:
            perm = np.arange(n)
        Ap = A[perm][:, perm].tocsr()

        n_pad = _round_up(max(n, tile), tile)
        n_tiles = n_pad // tile
        indptr, indices, data = Ap.indptr, Ap.indices, Ap.data

        # Per-tile window: [min col, max col] over the tile's rows
        # (vectorized per-tile min/max via ufunc.reduceat).
        tile_ptr = indptr[np.minimum(
            np.arange(0, n_pad + tile, tile), n)]
        nnz_tile = np.diff(tile_ptr)
        starts = np.zeros(n_tiles, dtype=np.int64)
        ends = np.zeros(n_tiles, dtype=np.int64)
        nonempty = nnz_tile > 0
        if indices.size:
            red_idx = tile_ptr[:-1].copy()
            # reduceat needs strictly valid segment starts; replace empty
            # segments afterwards.
            red_idx = np.minimum(red_idx, max(indices.size - 1, 0))
            mins = np.minimum.reduceat(indices, red_idx)
            maxs = np.maximum.reduceat(indices, red_idx)
            starts[nonempty] = mins[nonempty]
            ends[nonempty] = maxs[nonempty]
        spread = int((ends - starts + 1).max()) if n_tiles else 1
        if spread > max_bandwidth:
            raise ValueError(
                f"post-RCM tile bandwidth {spread} exceeds max_bandwidth="
                f"{max_bandwidth}; banded densification would cost "
                f"{spread}x row-degree FLOPs — use the ELL path")
        B = _round_up(max(spread, 128), 128)
        # Clamp starts so windows stay inside the padded U (N_pad + B pad).
        starts = np.minimum(starts, max(n_pad - B, 0)).astype(np.int32)

        # Vectorized band fill: each nonzero lands at
        # band[row, col - starts[row // tile]].
        deg = np.diff(indptr)
        rows = np.repeat(np.arange(n), deg)
        local = indices - starts[rows // tile]
        # Build in the TARGET dtype: an f64 staging array at (383k, 4096)
        # scale is 12 GB of host memory for no accuracy benefit.
        band = np.zeros((n_pad, B), dtype=np.dtype(jnp.dtype(dtype).name))
        band[rows, local] = data.astype(band.dtype)

        # Nonsymmetric operators also band A^T (same ordering) for the
        # scatter-free VJP. with_transpose=False stops the recursion when
        # building that transpose itself.
        transpose = None
        if with_transpose:
            d = (Ap - Ap.T).tocsr()
            if d.nnz and abs(d).max() > 1e-12 * max(abs(Ap).max(), 1e-300):
                transpose = cls.from_scipy(
                    Ap.T.tocsr(), dtype=dtype, tile=tile, reorder=False,
                    max_bandwidth=max_bandwidth, with_transpose=False)[0]

        op = cls(jnp.asarray(band, dtype=dtype), jnp.asarray(starts),
                 n, n, tile, transpose)
        return op, perm

    def pad_u(self, U: jax.Array) -> jax.Array:
        """Pad U's row axis to N_pad + B so every window read is in-range.

        U may already be longer than the target (rectangular shard-local
        blocks read from a halo window — parallel/sharded_banded.py); the
        builder guarantees every window read is in range in that case.
        """
        n_pad = self.band.shape[0]
        target = n_pad + self.bandwidth
        if U.shape[0] >= target:
            return U
        return jnp.pad(U, ((0, target - U.shape[0]), (0, 0)))


def _banded_matmul(A: BandedELL, U: jax.Array) -> jax.Array:
    """A @ U as one batched (tile, B) x (B, k) product per row tile."""
    Upad = A.pad_u(U)
    tile, B = A.tile, A.bandwidth
    n_tiles = A.band.shape[0] // tile

    def one_tile(t):
        window = jax.lax.dynamic_slice_in_dim(Upad, A.starts[t], B, axis=0)
        return jnp.dot(
            jax.lax.dynamic_slice_in_dim(A.band, t * tile, tile, axis=0),
            window, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32).astype(U.dtype)

    out = jax.vmap(one_tile)(jnp.arange(n_tiles))
    return out.reshape(-1, U.shape[1])[: A.n]


@jax.custom_vjp
def banded_spmm(A: BandedELL, U: jax.Array) -> jax.Array:
    """Banded SpMM with a matching-kernel VJP.

    The backward w.r.t. U applies A^T in the same banded product —
    `transpose_banded` when attached, A itself for symmetric operators.
    The operator is treated as a CONSTANT of the optimization (zero
    cotangent) — differentiate through `spmm` on the ELL path if operator
    gradients are ever needed.
    """
    return _banded_matmul(A, U)


def _banded_fwd(A, U):
    return _banded_matmul(A, U), A


def _zero_like_banded(A):
    dt = (None if A.transpose_banded is None
          else _zero_like_banded(A.transpose_banded))
    return BandedELL(jnp.zeros_like(A.band),
                     np.zeros(A.starts.shape, jax.dtypes.float0),
                     A.n, A.n_cols, A.tile, dt)


def _banded_bwd(A, g):
    At = A.transpose_banded if A.transpose_banded is not None else A
    return (_zero_like_banded(A), _banded_matmul(At, g))


banded_spmm.defvjp(_banded_fwd, _banded_bwd)


def banded_spmm_gram(A: BandedELL, U: jax.Array):
    """(A @ U, U^T A U) — the SpMM and the k x k Gram of the loss
    (`U^T M U` of gram_orthogonality, src/multigrid_model.py:320-322).
    XLA schedules the Gram as the SpMM's epilogue; autodiff through
    `banded_spmm`'s VJP gives dU = A^T (gW + U gG) + W gG^T."""
    W = banded_spmm(A, U)
    G = jnp.dot(U.T, W, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32).astype(U.dtype)
    return W, G
