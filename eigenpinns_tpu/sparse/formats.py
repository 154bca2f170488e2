"""Sparse matrix containers (JAX pytrees).

The reference's hot ops are sparse K@U / M@U products done with
`torch.sparse.mm` COO kernels (`src/multigrid_model.py:306-321`), with a
per-epoch scipy->torch conversion bug noted in SURVEY.md section 3.1.
Here every operator is preprocessed ONCE (host-side) into a padded
row-major "ELL" layout:

    indices: (N, W) int32   column index of each stored entry (pad: 0)
    values:  (N, W) float   entry value                        (pad: 0.0)

with W = max row degree rounded up to a multiple of 8. SpMM then becomes
a dense gather + weighted reduction over W — static shapes, fully
fusable by XLA (`sparse.ops.spmm`).

Mesh/cloud Laplacians have near-uniform row degree (kNN graphs: exactly
k+1; FEM: valence ~7), so padding waste is small.
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
class SparseELL:
    """Padded row-major sparse matrix (ELLPACK).

    `transpose_ell` optionally stores A^T in the same layout; it feeds the
    scatter-free custom VJP of `spmm` (ops._ell_spmm). None means the
    operator is symmetric and its own transpose.
    """

    indices: Any  # (N, W) int32
    values: Any   # (N, W) float
    n_cols: int   # static
    transpose_ell: Any = None  # SparseELL | None (None = symmetric)

    def tree_flatten(self):
        if self.transpose_ell is None:
            return (self.indices, self.values), (self.n_cols, False)
        return ((self.indices, self.values, self.transpose_ell),
                (self.n_cols, True))

    @classmethod
    def tree_unflatten(cls, aux, children):
        n_cols, has_t = aux
        if has_t:
            return cls(children[0], children[1], n_cols, children[2])
        return cls(children[0], children[1], n_cols)

    @property
    def shape(self):
        return (self.indices.shape[0], self.n_cols)

    @property
    def width(self) -> int:
        return self.indices.shape[1]

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32, pad_multiple: int = 8,
                   with_transpose: bool = True):
        """Canonicalize any scipy sparse matrix into ELL (host-side, once).

        Unless the matrix is (numerically) symmetric, its transpose is
        also converted and attached for the scatter-free SpMM VJP.
        """
        A = A.tocsr()
        A.sum_duplicates()
        n, m = A.shape

        def _pack(B):
            nn = B.shape[0]
            deg = np.diff(B.indptr)
            w = max(_round_up(int(deg.max()) if nn else 1, pad_multiple),
                    pad_multiple)
            indices = np.zeros((nn, w), dtype=np.int32)
            values = np.zeros((nn, w), dtype=np.float64)
            # Vectorized CSR->ELL: position-within-row for every nonzero.
            rows = np.repeat(np.arange(nn), deg)
            pos = np.arange(B.nnz) - np.repeat(B.indptr[:-1], deg)
            indices[rows, pos] = B.indices
            values[rows, pos] = B.data
            return (jnp.asarray(indices), jnp.asarray(values, dtype=dtype))

        idx, vals = _pack(A)
        transpose = None
        if with_transpose:
            symmetric = False
            if n == m:
                d = (A - A.T).tocsr()
                symmetric = d.nnz == 0 or abs(d).max() < 1e-12 * max(
                    abs(A).max(), 1e-300)
            if not symmetric:
                ti, tv = _pack(A.T.tocsr())
                transpose = cls(ti, tv, n)
        return cls(idx, vals, m, transpose)

    def to_scipy(self):
        import scipy.sparse as sp

        n, w = self.indices.shape
        rows = np.repeat(np.arange(n), w)
        A = sp.coo_matrix(
            (np.asarray(self.values, dtype=np.float64).reshape(-1),
             (rows, np.asarray(self.indices).reshape(-1))),
            shape=self.shape,
        ).tocsr()
        A.sum_duplicates()
        # Padding contributed explicit zeros in column 0; prune them.
        A.eliminate_zeros()
        return A

    def diagonal(self) -> jax.Array:
        n = self.indices.shape[0]
        row_ids = jnp.arange(n)[:, None]
        mask = self.indices == row_ids
        return jnp.sum(jnp.where(mask, self.values, 0.0), axis=1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Diagonal:
    """Diagonal operator (lumped mass matrices)."""

    diag: Any  # (N,)

    def tree_flatten(self):
        return (self.diag,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32):
        return cls(jnp.asarray(A.diagonal(), dtype=dtype))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.diags(np.asarray(self.diag, dtype=np.float64)).tocsr()

    def diagonal(self) -> jax.Array:
        return self.diag


def as_operator(A, dtype=jnp.float32, pad_multiple: int = 8):
    """scipy sparse -> Diagonal if (numerically) diagonal, else SparseELL."""
    import scipy.sparse as sp

    if sp.issparse(A):
        if A.shape[0] == A.shape[1]:
            offdiag = (A - sp.diags(A.diagonal())).tocsr()
            if offdiag.nnz == 0 or abs(offdiag).max() == 0.0:
                return Diagonal.from_scipy(A, dtype=dtype)
        return SparseELL.from_scipy(A, dtype=dtype, pad_multiple=pad_multiple)
    raise TypeError(f"expected scipy sparse, got {type(A)}")
