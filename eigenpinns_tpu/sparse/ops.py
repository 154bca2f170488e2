"""Core sparse linear algebra: SpMM, Gram reductions, block structure.

Replaces the reference's torch.sparse COO products
(`src/multigrid_model.py:306-322`, `src/utils.py:14-20,127-165`) with
XLA-friendly gather/reduce formulations over the padded-ELL layout, plus
dense matmuls for the k x k Gram/Rayleigh reductions. Everything here is
jit-safe and differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eigenpinns_tpu.sparse.formats import Diagonal, SparseELL


@jax.tree_util.register_pytree_node_class
class FunctionOperator:
    """Duck-typed operator: any U -> A @ U callable plus its diagonal.

    Lets solver code written against `spmm(A, U)` / `A.diagonal()` (e.g.
    solvers/lobpcg.py) run on operators that are FUNCTIONS — the sharded
    SpMMs of parallel/sharded_banded.py in particular
    (solvers/lobpcg_sharded.py). A pytree callable (`ShardedSpMM`) keeps
    its operator arrays as traced leaves, so jit takes them as
    arguments; a plain function rides the treedef (jax.tree_util.Partial)
    and its captured arrays become constants of the executable.
    """

    def __init__(self, fn, diag):
        if jax.tree_util.treedef_is_leaf(jax.tree_util.tree_structure(fn)):
            fn = jax.tree_util.Partial(fn)
        self.fn = fn
        self.diag = diag

    def diagonal(self):
        return self.diag

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    def tree_flatten(self):
        return (self.fn, self.diag), None

    @classmethod
    def tree_unflatten(cls, _, children):
        op = object.__new__(cls)
        op.fn, op.diag = children
        return op


def hdot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Full-f32 matmul. Accelerator matmuls at the default precision round
    f32 inputs (TF32 on the H100: ~1e-3 relative error), which is fatal
    for orthogonalization/Gram arithmetic (LOBPCG diverges where the same
    code in full f32 converges). All numerically sensitive products
    route through here."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32).astype(a.dtype)


def operator_dot(a: jax.Array, b: jax.Array, precision: str) -> jax.Array:
    """f32 result of a @ b for a block `a` of a stored operator, at one of
    the operator formats' precision names:

      'highest'  full f32 (Precision.HIGHEST) — solver grade;
      'high'     Precision.HIGH. On the H100 XLA runs it on the TF32
                 tensor cores, ~1e-3 relative error (PERF.md) —
                 training-loss grade only; on the CPU it is full f32;
      'bf16'     the operator is stored in bf16 (half the bytes, ~3
                 decimal digits) and multiplies the f32 operand at the
                 default precision (TF32 on the H100) — training-loss
                 grade only.
    """
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "bf16": jax.lax.Precision.DEFAULT}[precision]
    return jnp.dot(a, b, precision=prec, preferred_element_type=jnp.float32)


# Cap on the gathered (N, W, k) intermediate. Beyond it the SpMM chunks
# the mode axis: at 1M x W24 x k150 the one-shot gather wants ~14 GB.
_GATHER_BUDGET_ELEMS = 512 * 1024 * 1024  # ~2 GB in f32


def _gather_spmm(indices: jax.Array, values: jax.Array,
                 U: jax.Array) -> jax.Array:
    """Raw ELL SpMM: gather U rows by padded column indices, contract W."""
    n, w = indices.shape
    k = U.shape[1]

    def one(u_block):
        gathered = u_block[indices]       # (N, W, kc)
        return jnp.einsum(
            "nwk,nw->nk", gathered, values,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).astype(U.dtype)

    if n * w * k <= _GATHER_BUDGET_ELEMS or k <= 8:
        return one(U)
    n_chunks = -(-n * w * k // _GATHER_BUDGET_ELEMS)
    kc = -(-k // n_chunks)
    pad = (-k) % kc
    Up = jnp.pad(U, ((0, 0), (0, pad))) if pad else U
    blocks = jnp.moveaxis(Up.reshape(n, -1, kc), 1, 0)  # (chunks, N, kc)
    out = jax.lax.map(one, blocks)                      # (chunks, N, kc)
    return jnp.moveaxis(out, 0, 1).reshape(n, -1)[:, :k]


@jax.custom_vjp
def _ell_spmm(indices, values, t_indices, t_values, U):
    """ELL SpMM whose VJP uses the EXPLICIT transpose operator.

    The autodiff backward of a gather is a scatter-add, which serializes
    on colliding rows. Backpropagating A^T @ g as another gather
    SpMM removes every scatter from the training step. (t_indices,
    t_values) hold A^T in ELL; for symmetric operators they alias A's.
    """
    return _gather_spmm(indices, values, U)


def _ell_spmm_fwd(indices, values, t_indices, t_values, U):
    out = _gather_spmm(indices, values, U)
    return out, (indices, t_indices, t_values, U)


def _ell_spmm_bwd(res, g):
    indices, t_indices, t_values, U = res
    dU = _gather_spmm(t_indices, t_values, g)
    # Cotangent for `values` (DCE'd by XLA when operators are constants):
    dvalues = jnp.einsum(
        "nk,nwk->nw", g, U[indices],
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32).astype(g.dtype)
    import numpy as _np

    f0 = jax.dtypes.float0
    return (_np.zeros(indices.shape, f0), dvalues,
            _np.zeros(t_indices.shape, f0),
            jnp.zeros_like(t_values), dU)


_ell_spmm.defvjp(_ell_spmm_fwd, _ell_spmm_bwd)


def spmm(A, U: jax.Array) -> jax.Array:
    """A @ U for A in {SparseELL, Diagonal}, U: (N, k) dense.

    ELL path: gather U rows by the padded column indices and contract the
    width axis — `(N, W, k) * (N, W, 1) -> (N, k)`. Static shapes, no
    scatter (including in the backward pass — see `_ell_spmm`).
    """
    if isinstance(A, Diagonal):
        return A.diag[:, None] * U
    if isinstance(A, SparseELL):
        t = A.transpose_ell if A.transpose_ell is not None else A
        return _ell_spmm(A.indices, A.values, t.indices, t.values, U)
    from eigenpinns_tpu.sparse.banded import BandedELL, banded_spmm

    if isinstance(A, BandedELL):
        return banded_spmm(A, U)
    from eigenpinns_tpu.sparse.rolling import RollingBanded, rolling_spmm

    if isinstance(A, RollingBanded):
        return rolling_spmm(A, U)
    from eigenpinns_tpu.sparse.split import SplitBanded, split_spmm

    if isinstance(A, SplitBanded):
        return split_spmm(A, U)
    from eigenpinns_tpu.sparse.bsr import BSRTile, bsr_spmm

    if isinstance(A, BSRTile):
        return bsr_spmm(A, U)
    if isinstance(A, FunctionOperator):
        return A.fn(U)
    raise TypeError(f"unsupported operator {type(A)}")


def spmv(A, u: jax.Array) -> jax.Array:
    """A @ u for a single vector (N,)."""
    return spmm(A, u[:, None])[:, 0]


def spmm_gram(A, U: jax.Array):
    """(A @ U, U^T A U) — the SpMM and the loss's k x k orthonormality
    Gram (src/multigrid_model.py:320-322) in one call, dispatched on the
    operator format (the split format adds its remainder's correction).
    """
    from eigenpinns_tpu.sparse.banded import BandedELL, banded_spmm_gram

    if isinstance(A, BandedELL):
        return banded_spmm_gram(A, U)
    from eigenpinns_tpu.sparse.rolling import (
        RollingBanded,
        rolling_spmm_gram,
    )

    if isinstance(A, RollingBanded):
        return rolling_spmm_gram(A, U)
    from eigenpinns_tpu.sparse.split import SplitBanded, split_spmm_gram

    if isinstance(A, SplitBanded):
        return split_spmm_gram(A, U)
    from eigenpinns_tpu.sparse.bsr import BSRTile, bsr_spmm_gram

    if isinstance(A, BSRTile):
        return bsr_spmm_gram(A, U)
    W = spmm(A, U)
    return W, gram(U, W)


def gram(U: jax.Array, V: jax.Array) -> jax.Array:
    """U^T V (k x k), full f32 (see `hdot`)."""
    return hdot(U.T, V)


def m_gram(U: jax.Array, M) -> jax.Array:
    """U^T M U — the M-inner-product Gram matrix (reference's
    orthonormality core, `src/multigrid_model.py:320-322`)."""
    return gram(U, spmm(M, U))


def rayleigh_quotients(U: jax.Array, K, M, eps: float = 1e-12) -> jax.Array:
    """Per-mode Rayleigh quotients diag(U^T K U) / diag(U^T M U)
    (src/multigrid_model.py:309-311)."""
    Ku = spmm(K, U)
    Mu = spmm(M, U)
    num = jnp.sum(U * Ku, axis=0)
    den = jnp.sum(U * Mu, axis=0)
    return num / (den + eps)


def m_normalize_columns(U: jax.Array, M, eps: float = 1e-12) -> jax.Array:
    """Normalize each column to unit M-norm (src/multigrid_model.py:120-130)."""
    Mu = spmm(M, U)
    norms = jnp.sqrt(jnp.sum(U * Mu, axis=0) + eps)
    return U / norms[None, :]


def normalize_columns(U: jax.Array, eps: float = 1e-12):
    """Euclidean column normalization (src/utils.py:23-32)."""
    norms = jnp.linalg.norm(U, axis=0) + eps
    return U / norms, norms


def residual(U: jax.Array, K, M, lam: jax.Array) -> jax.Array:
    """Eigen-residual K U - M U diag(lam), shape (N, k)."""
    return spmm(K, U) - spmm(M, U) * lam[None, :]


def block_diag_ell(ops: list) -> SparseELL:
    """Stack per-level operators into one block-diagonal SparseELL — the
    analog of `utils.sparse_block_diag` (src/utils.py:127-165).

    All levels share one SpMM over the concatenated node axis; column
    indices are offset so each block only gathers within its own span.
    """
    mats = []
    for A in ops:
        if isinstance(A, Diagonal):
            n = A.diag.shape[0]
            A = SparseELL(
                jnp.arange(n, dtype=jnp.int32)[:, None],
                A.diag[:, None],
                n,
            )
        mats.append(A)
    width = max(A.width for A in mats)
    n_cols = sum(A.n_cols for A in mats)
    idx_blocks, val_blocks = [], []
    offset = 0
    for A in mats:
        pad = width - A.width
        idx = jnp.pad(A.indices, ((0, 0), (0, pad))) + offset
        val = jnp.pad(A.values, ((0, 0), (0, pad)))
        # Padded entries must stay inside this block: they carry value 0,
        # so pointing them at the block's first column is safe.
        idx_blocks.append(jnp.where(val != 0, idx, offset))
        val_blocks.append(val)
        offset += A.n_cols
    return SparseELL(
        jnp.concatenate(idx_blocks, axis=0),
        jnp.concatenate(val_blocks, axis=0),
        n_cols,
    )


def gcn_normalized_adjacency(edge_index, n_nodes: int) -> SparseELL:
    """D^{-1/2} (A + I) D^{-1/2} as SparseELL — the SpectralCorrector's
    aggregation operator (src/utils.py:78-124). Host-side build."""
    import numpy as np
    import scipy.sparse as sp

    e = np.asarray(edge_index)
    ones = np.ones(e.shape[1])
    A = sp.coo_matrix((ones, (e[0], e[1])), shape=(n_nodes, n_nodes))
    A = (A + sp.eye(n_nodes)).tocsr()
    A.sum_duplicates()
    A.data[:] = 1.0  # A+I with binarized duplicates, matching coalesce()
    deg = np.asarray(A.sum(axis=1)).ravel()
    d = 1.0 / np.sqrt(np.clip(deg, 1e-12, None))
    A = sp.diags(d) @ A @ sp.diags(d)
    return SparseELL.from_scipy(A)


def neighbor_mean(edge_index: jax.Array, x: jax.Array) -> jax.Array:
    """Mean over in-neighbors: agg[i] = mean_{(i,j) in E} x[j].

    Segment-sum formulation of the reference SimpleCorrector aggregation
    (`src/corrector_model.py:23-31`: index_add_ over rows + bincount).
    Prefer `neighbor_mean_operator` + `spmm` in training loops — the
    segment-sum is a scatter, and so is the gather's backward.
    """
    row, col = edge_index[0], edge_index[1]
    n = x.shape[0]
    agg = jax.ops.segment_sum(x[col], row, num_segments=n)
    deg = jax.ops.segment_sum(jnp.ones_like(row, dtype=x.dtype), row,
                              num_segments=n)
    return agg / jnp.clip(deg, 1.0)[:, None]


def neighbor_mean_scipy(edge_index, n_nodes: int):
    """The mean-aggregation matrix D^{-1} A as scipy CSR."""
    import numpy as np
    import scipy.sparse as sp

    e = np.asarray(edge_index)
    A = sp.coo_matrix((np.ones(e.shape[1]), (e[0], e[1])),
                      shape=(n_nodes, n_nodes)).tocsr()
    A.sum_duplicates()
    deg = np.asarray(A.sum(axis=1)).ravel()
    Dinv = sp.diags(1.0 / np.clip(deg, 1.0, None))
    return (Dinv @ A).tocsr()


def neighbor_mean_operator(edge_index, n_nodes: int) -> SparseELL:
    """The mean-aggregation matrix D^{-1} A as SparseELL (host-side build,
    transpose attached for the scatter-free VJP). `spmm(op, x)` equals
    `neighbor_mean(edge_index, x)`."""
    return SparseELL.from_scipy(neighbor_mean_scipy(edge_index, n_nodes))
