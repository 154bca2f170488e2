"""Chunk-compact tile-sparse (strip-BSR) SpMM: multiply only the
nonempty 128x128 tiles.

The banded formats (banded.py full-window, rolling.py uniform window)
multiply every tile inside the band, and about 2/3 of that arithmetic
multiplies zeros: per 128-row tile of the 300k cloud operator only a mean
of 10.2 (max 17) of the ~30 band-covered 128-wide column tiles hold any
nonzeros. This format stores the nonempty tiles RAGGED — padded only up
to a multiple of `chunk` (C) per row tile:

  * `data` is (S*T, C*T): chunk s holds C horizontally-stacked 128x128
    tiles of ONE row tile; a row tile with nw nonempty tiles owns
    ceil(max(nw,1)/C) consecutive chunks (pad slots are zero tiles).
  * `cid` (S, C) int32 maps chunk slot j -> column tile id (pad slots
    repeat a valid id; their zero tiles contribute nothing).
  * `rowid` (S,) int32, NONDECREASING: the row tile each chunk belongs
    to.

The SpMM gathers each chunk's (C*T, k) block of U, multiplies it by the
chunk's (T, C*T) strip in one batched product, and segment-sums the
per-chunk results by row tile. Any sparsity pattern tiles (no bandwidth
cap).

Replaces the reference's torch.sparse COO SpMV hot op
(src/multigrid_model.py:306-322). Same precision names as rolling.py
(sparse.ops.operator_dot) via with_precision(); Grams/Rayleigh quotients
stay f32-HIGHEST.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from eigenpinns_tpu.sparse.ops import operator_dot


class _Static:
    """Hashable wrapper for layout arrays living in treedef aux
    (jit caches compare treedefs with ==/hash; raw ndarrays break both)."""

    __slots__ = ("a", "_h")

    def __init__(self, a):
        self.a = np.ascontiguousarray(a)
        self.a.setflags(write=False)
        self._h = hash((self.a.shape, self.a.dtype.str, self.a.tobytes()))

    def __hash__(self):
        return self._h

    def __eq__(self, other):
        return (isinstance(other, _Static) and self._h == other._h
                and np.array_equal(self.a, other.a))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BSRTile:
    """Chunk-compact tile-sparse matrix (tile = 128).

    data:  (S*T, C*T) float — see module docstring
    cid:   (S, C) int32 — chunk slot -> column tile id
    rowid: (S,) int32 nondecreasing — chunk -> row tile
    nw:    (n_rt,) int32 — real (unpadded) nonempty tiles per row tile
    diag:  (n,) float — the operator diagonal (solver preconditioners)

    data and diag are pytree CHILDREN (runtime operands); the integer
    layout rides the treedef by default (static_layout) as compile-time
    constants, or travels as traced operands (static_layout=False) so
    same-shape operators share one executable.
    """

    data: Any
    cid: Any
    rowid: Any
    nw: Any
    diag: Any
    n: int
    n_cols: int
    tile: int = 128
    transpose_bsr: Any = None     # BSRTile | None (None = symmetric)
    mxu_precision: str = "highest"
    # True (default): cid/rowid/nw ride the treedef as compile-time
    # constants. False: they are traced operands, so SAME-SHAPE operators
    # share one compiled executable — what spectral_basis_family needs
    # to amortize one compile across a padded mesh family.
    static_layout: bool = True

    def tree_flatten(self):
        has_t = self.transpose_bsr is not None
        if self.static_layout:
            children = (self.data, self.diag) + (
                (self.transpose_bsr,) if has_t else ())
            return children, (True, _Static(self.cid), _Static(self.rowid),
                              _Static(self.nw), self.n, self.n_cols,
                              self.tile, has_t, self.mxu_precision)
        children = (self.data, self.cid, self.rowid, self.nw, self.diag) + (
            (self.transpose_bsr,) if has_t else ())
        return children, (False, self.n, self.n_cols, self.tile, has_t,
                          self.mxu_precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        if aux[0]:
            _, cid, rowid, nw, n, n_cols, tile, has_t, prec = aux
            t = children[2] if has_t else None
            return cls(children[0], cid.a, rowid.a, nw.a, children[1],
                       n, n_cols, tile, t, prec, True)
        _, n, n_cols, tile, has_t, prec = aux
        t = children[5] if has_t else None
        return cls(children[0], children[1], children[2], children[3],
                   children[4], n, n_cols, tile, t, prec, False)

    def with_precision(self, precision: str) -> "BSRTile":
        """'highest'/'high' share the f32 strips; 'bf16' materializes a
        half-size bf16 copy (training-loss-only precision — see
        rolling.py)."""
        t = (None if self.transpose_bsr is None
             else self.transpose_bsr.with_precision(precision))
        data = self.data
        if precision == "bf16" and data.dtype != jnp.bfloat16:
            data = data.astype(jnp.bfloat16)
        elif precision != "bf16" and data.dtype == jnp.bfloat16:
            # See rolling.py: solver-grade precision on bf16 strips
            # restores f32 storage.
            data = data.astype(jnp.float32)
        return dataclasses.replace(self, data=data,
                                   mxu_precision=precision,
                                   transpose_bsr=t)

    @property
    def shape(self):
        return (self.n, self.n_cols)

    @property
    def chunk(self) -> int:
        """Tiles per chunk (C)."""
        return self.cid.shape[1]

    @property
    def n_chunks(self) -> int:
        return self.cid.shape[0]

    @property
    def strip_w(self) -> int:
        """Max real nonempty tiles in any row tile (diagnostic)."""
        return int(np.asarray(self.nw).max(initial=1))

    @property
    def n_row_tiles(self) -> int:
        return self.nw.shape[0]

    @property
    def n_slots(self) -> int:
        """Real (unpadded) nonempty tiles."""
        return int(self.nw.sum())

    def diagonal(self) -> jax.Array:
        return jnp.asarray(self.diag)

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32, tile: int = 128,
                   reorder: bool = True, with_transpose: bool = True,
                   pad_rows_to: int | None = None,
                   pad_chunks_to: int | None = None,
                   perm: np.ndarray | None = None,
                   static_layout: bool = True,
                   chunk: int = 8):
        """Convert scipy sparse; returns (op, perm) like the other
        formats. No bandwidth cap — any sparsity pattern tiles.

        `pad_rows_to` / `pad_chunks_to` force the row count and total
        chunk count up to common values — mesh FAMILIES padded to one
        shape share a single compiled executable for every solver
        program (jit caches on shapes); pad chunks are zero tiles
        accumulated into the last row tile. `perm` supplies a
        precomputed ordering (skips the RCM pass on rebuilds)."""
        A = A.tocsr()
        A.sum_duplicates()
        n, n_cols = A.shape
        if perm is not None:
            perm = np.asarray(perm)
            Ap = A[perm][:, perm].tocsr()
        elif reorder:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
            Ap = A[perm][:, perm].tocsr()
        else:
            perm = np.arange(n)
            Ap = A

        if pad_rows_to is not None and pad_rows_to > n:
            # Append empty rows/cols (zero K and M rows are inert in the
            # solvers' Gram arithmetic; see lobpcg_sharded's analysis).
            import scipy.sparse as sp

            extra = pad_rows_to - n
            Ap = sp.csr_matrix(
                (Ap.data, Ap.indices,
                 np.concatenate([Ap.indptr,
                                 np.full(extra, Ap.indptr[-1])])),
                shape=(pad_rows_to, pad_rows_to))
            n = n_cols = pad_rows_to

        coo = Ap.tocoo()
        T, C = tile, int(chunk)
        n_rt = -(-n // T)
        n_ct = -(-n_cols // T)
        rt = (coo.row // T).astype(np.int64)
        ct = (coo.col // T).astype(np.int64)
        key = rt * n_ct + ct
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        tile_key, entry_start = np.unique(key_s, return_index=True)
        t_rt = (tile_key // n_ct).astype(np.int64)
        t_ct = (tile_key % n_ct).astype(np.int64)
        nw = np.bincount(t_rt, minlength=n_rt).astype(np.int32)
        # Chunks per row tile: >= 1 so every output block is written.
        cpr = np.maximum(-(-nw // C), 1)
        S = int(cpr.sum())
        if pad_chunks_to is not None:
            if pad_chunks_to < S:
                raise ValueError(
                    f"pad_chunks_to={pad_chunks_to} < required {S}")
            cpr[-1] += pad_chunks_to - S
            S = int(pad_chunks_to)
        chunk_start = np.concatenate(([0], np.cumsum(cpr)))  # (n_rt+1,)
        rowid = np.repeat(np.arange(n_rt, dtype=np.int32), cpr)

        # Slot of each nonempty tile inside its row tile (0..nw-1), then
        # split into (chunk, within-chunk) coordinates.
        slot_in_row = np.arange(tile_key.shape[0]) - np.concatenate(
            ([0], np.cumsum(nw)))[t_rt]
        t_chunk = chunk_start[t_rt] + slot_in_row // C
        t_slot = slot_in_row % C

        # Pad slots repeat a valid column id from the same row tile
        # (keeps gather DMAs in-bounds; zero tiles nullify the product).
        # Default cid 0 is fine for fully-empty padded row tiles.
        cid = np.zeros((S, C), np.int32)
        fallback = np.zeros(n_rt, np.int32)
        fallback[t_rt] = t_ct.astype(np.int32)   # any valid id per row tile
        cid[:] = fallback[rowid][:, None]
        cid[t_chunk, t_slot] = t_ct.astype(np.int32)

        np_dtype = np.dtype(jnp.dtype(dtype).name)
        slot_of_entry = np.searchsorted(tile_key, key_s)
        lr = (coo.row[order] % T).astype(np.int64)
        lc = (coo.col[order] % T).astype(np.int64)
        d_rows = t_chunk[slot_of_entry] * T + lr
        d_cols = t_slot[slot_of_entry] * T + lc
        from eigenpinns_tpu.sparse import rolling as _rolling

        if (S * T * C * T * np_dtype.itemsize
                >= _rolling._DEVICE_BUILD_MIN_BYTES):
            # Device-side assembly: upload nnz triplets (~MBs) instead
            # of the materialized strips (~GBs), see rolling._scatter_band.
            data = _rolling._scatter_band((S * T, C * T), dtype,
                                 d_rows.astype(np.int32),
                                 d_cols.astype(np.int32),
                                 coo.data[order].astype(np.float32))
        else:
            data_np = np.zeros((S * T, C * T), dtype=np_dtype)
            data_np[d_rows, d_cols] = coo.data[order].astype(np_dtype)
            data = jnp.asarray(data_np)

        diag = np.asarray(Ap.diagonal()).astype(data.dtype)

        transpose = None
        if with_transpose:
            d = (Ap - Ap.T).tocsr()
            if d.nnz and abs(d).max() > 1e-12 * max(abs(Ap).max(), 1e-300):
                if pad_chunks_to is not None:
                    # The transpose's chunk count generally differs from
                    # the forward's, so a family-common pad for it would
                    # need the family max over TRANSPOSES — not known
                    # here. Explicit > silently breaking the
                    # one-shared-executable property.
                    raise NotImplementedError(
                        "pad_chunks_to with a nonsymmetric operator: "
                        "family padding of the transpose is not "
                        "supported; pass with_transpose=False or use "
                        "symmetric operators")
                transpose = cls.from_scipy(
                    Ap.T.tocsr(), dtype=dtype, tile=tile, reorder=False,
                    with_transpose=False, static_layout=static_layout,
                    pad_rows_to=pad_rows_to, chunk=C)[0]

        op = cls(jnp.asarray(data), cid, rowid, nw, diag, n, n_cols, T,
                 transpose, "highest", static_layout)
        return op, perm

    def pad_u(self, U: jax.Array) -> jax.Array:
        target = -(-self.n_cols // self.tile) * self.tile
        return jnp.pad(U, ((0, target - U.shape[0]), (0, 0)))


def _bsr_matmul(A: BSRTile, U: jax.Array) -> jax.Array:
    """Per-chunk product against the gathered U block, segment-summed by
    row tile."""
    T, C = A.tile, A.chunk
    S = A.n_chunks
    k = U.shape[1]
    Up = A.pad_u(U).reshape(-1, T, k)                    # (n_ct, T, k)
    Ustrips = Up[jnp.asarray(A.cid)].reshape(S, C * T, k)
    strips = A.data.reshape(S, T, C * T)
    partial = jax.vmap(
        lambda s, u: operator_dot(s, u, A.mxu_precision))(
        strips, Ustrips)                                 # (S, T, k)
    out = jax.ops.segment_sum(partial, jnp.asarray(A.rowid),
                              num_segments=A.n_row_tiles)
    return out.reshape(-1, k)[: A.n].astype(U.dtype)


def bsr_spmm_hbm_bytes(A: BSRTile, k: int, rhs_itemsize: int = 4) -> int:
    """Device-memory bytes one `bsr_spmm(A, U)` must move for an (n, k)
    RHS of `rhs_itemsize` bytes/element: the stored strips, one (T, k)
    U tile per chunk slot (every chunk gathers its own C tiles), and the
    (n, k) result. Intermediates that XLA may materialize between the
    gather, the batched product and the segment sum are not counted, so
    this is the path's floor, not its measured traffic."""
    strip_b = A.data.nbytes
    gather_b = A.n_chunks * A.chunk * A.tile * k * rhs_itemsize
    out_b = A.n * k * rhs_itemsize
    return int(strip_b + gather_b + out_b)


def _zero_like_bsr(A: BSRTile):
    """Zero cotangent with the custom-vjp convention: float0 for the
    integer layout tables (traced children only), zeros for the float
    leaves. Static-layout tables stay in the treedef untouched."""
    t = None if A.transpose_bsr is None else _zero_like_bsr(A.transpose_bsr)
    kw = dict(data=jnp.zeros_like(A.data),
              diag=jnp.zeros_like(jnp.asarray(A.diag)),
              transpose_bsr=t)
    if not A.static_layout:
        f0 = jax.dtypes.float0
        kw.update(cid=np.zeros(np.shape(A.cid), f0),
                  rowid=np.zeros(np.shape(A.rowid), f0),
                  nw=np.zeros(np.shape(A.nw), f0))
    return dataclasses.replace(A, **kw)


@jax.custom_vjp
def bsr_spmm(A: BSRTile, U: jax.Array) -> jax.Array:
    """A @ U with a scatter-free VJP (dU = A^T gW; the operator is a
    constant of the optimization)."""
    return _bsr_matmul(A, U)


def _bsr_fwd(A, U):
    return _bsr_matmul(A, U), A


def _bsr_bwd(A, g):
    At = A.transpose_bsr if A.transpose_bsr is not None else A
    return (_zero_like_bsr(A), _bsr_matmul(At, g))


bsr_spmm.defvjp(_bsr_fwd, _bsr_bwd)


def bsr_spmm_gram(A: BSRTile, U: jax.Array):
    """(A @ U, U^T A U); the Gram is an XLA epilogue."""
    from eigenpinns_tpu.sparse.ops import hdot

    W = bsr_spmm(A, U)
    return W, hdot(U.T, W)
