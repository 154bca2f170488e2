"""Distributed banded operators: ring-halo exchange + per-shard banded SpMM.

This is the multi-chip form of the banded-dense format
(sparse/banded.py) — the production sharded SpMM for mesh/cloud
Laplacians. The reference has no distributed path at all (single
`torch.device`, src/multigrid_model.py:20); the design here follows
SURVEY.md sec 5's node-sharding plan:

  * rows are block-sharded over the mesh's "data" axis, `per` rows per
    device, with the operator RCM-ordered so every nonzero of shard s's
    rows lies within the halo window [s*per - B, (s+1)*per + B);
  * each SpMM exchanges ONE (B, k) halo slice per side via
    `lax.ppermute` between devices (O(B*k) bytes — independent of N),
    then runs the shard-local rectangular banded block through the
    banded product (sparse/banded.py): (tile, B) @ (B, k) matmuls;
  * the backward pass applies a prebuilt banded TRANSPOSE block per
    shard (banded_spmm's scatter-free custom VJP), and shard_map's AD
    transposes the ppermutes to route halo cotangents back to their
    source shards — no gathers or scatters anywhere;
  * cluster-split operators (sparse/split.py) add their sparse
    remainder via an all_gather'd gather-ELL term, so the 1M-point
    SplitBanded operator runs sharded end to end.

k x k reductions (Grams, Rayleigh numerators) need no hand-written
collectives: they are jnp einsums over the sharded node axis and XLA
GSPMD inserts the psums (the scaling-book recipe).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from eigenpinns_tpu.sparse.banded import BandedELL, _round_up, banded_spmm


def _tile_windows(indptr, indices, n_rows, tile):
    """Per-tile [min_col, max_col] windows of a CSR matrix (vectorized)."""
    n_pad = _round_up(max(n_rows, tile), tile)
    n_tiles = n_pad // tile
    tile_ptr = indptr[np.minimum(np.arange(0, n_pad + tile, tile), n_rows)]
    nnz_tile = np.diff(tile_ptr)
    starts = np.zeros(n_tiles, dtype=np.int64)
    ends = np.zeros(n_tiles, dtype=np.int64)
    nonempty = nnz_tile > 0
    if indices.size:
        red_idx = np.minimum(tile_ptr[:-1], max(indices.size - 1, 0))
        mins = np.minimum.reduceat(indices, red_idx)
        maxs = np.maximum.reduceat(indices, red_idx)
        starts[nonempty] = mins[nonempty]
        ends[nonempty] = maxs[nonempty]
    return starts, ends, n_pad, n_tiles


def _rect_banded(A_csr, tile: int, bandwidth: int | None = None):
    """Band a rectangular CSR block (no reordering, explicit n_cols).

    Returns a host-side (band, starts, B) triple; `bandwidth` forces a
    common B so per-shard blocks stack into one array.
    """
    n_rows, n_cols = A_csr.shape
    indptr, indices, data = A_csr.indptr, A_csr.indices, A_csr.data
    starts, ends, n_pad, _ = _tile_windows(indptr, indices, n_rows, tile)
    spread = int((ends - starts + 1).max()) if starts.size else 1
    B = bandwidth if bandwidth is not None else _round_up(
        max(spread, 128), 128)
    if spread > B:
        raise ValueError(f"tile spread {spread} exceeds bandwidth {B}")
    starts = np.minimum(starts, max(n_cols - 1, 0)).astype(np.int64)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n_rows), deg)
    local = indices - starts[rows // tile]
    band = np.zeros((n_pad, B), dtype=np.float32)
    band[rows, local] = data.astype(np.float32)
    return band, starts.astype(np.int32), B


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedBanded:
    """Row-sharded banded operator with per-shard transpose blocks.

    band:     (n_dev, per, B)    — shard-local banded rows; column index
              is relative to the shard's halo-window origin s*per - B
    starts:   (n_dev, tiles)     — per-tile window starts, window-relative
    band_t:   (n_dev, win_pad, B_t) — banded transpose of each local
              (per, win) block, rows = window rows, cols = local rows
    starts_t: (n_dev, tiles_t)
    n:        true (unpadded) global row count
    """

    band: Any
    starts: Any
    band_t: Any
    starts_t: Any
    n: int
    n_dev: int
    per: int
    B: int
    tile: int

    def tree_flatten(self):
        return ((self.band, self.starts, self.band_t, self.starts_t),
                (self.n, self.n_dev, self.per, self.B, self.tile))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def n_pad(self) -> int:
        return self.n_dev * self.per

    @property
    def win(self) -> int:
        return self.per + 2 * self.B

    def diagonal(self) -> jax.Array:
        """Main diagonal: shard s row r is window column B + r."""
        rows = jnp.arange(self.per)
        local = (self.B + rows)[None, :] - jnp.take_along_axis(
            self.starts, (rows // self.tile)[None, :].repeat(
                self.n_dev, axis=0), axis=1)
        local = jnp.clip(local, 0, self.B - 1)
        d = jnp.take_along_axis(
            self.band, local[:, :, None], axis=2)[:, :, 0]
        return d.reshape(-1)[: self.n]

    @classmethod
    def from_scipy(cls, A, n_dev: int, dtype=jnp.float32, tile: int = 128,
                   reorder: bool = True, max_bandwidth: int = 4096):
        """Shard a (numerically or structurally banded) operator.

        Returns (op, perm); the op's arrays stay on the host until
        `sharded_banded_spmm` places each shard on its device. Raises
        ValueError when the stencil cannot fit
        a one-neighbor halo (bandwidth > per) or exceeds max_bandwidth —
        callers fall back to all_gather paths.
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

        per = _round_up(-(-n // n_dev), tile)
        n_pad = per * n_dev
        if n_pad != n:
            Ap = sp.block_diag(
                [Ap, sp.csr_matrix((n_pad - n, n_pad - n))]).tocsr()

        starts_abs, ends_abs, _, _ = _tile_windows(
            Ap.indptr, Ap.indices, n_pad, tile)
        spread = int((ends_abs - starts_abs + 1).max()) if n_pad else 1
        B = _round_up(max(spread, 128), 128)
        if B > max_bandwidth:
            raise ValueError(
                f"post-RCM tile bandwidth {spread} exceeds max_bandwidth="
                f"{max_bandwidth}; use an all_gather/split path")
        if B > per:
            raise ValueError(
                f"bandwidth {B} exceeds rows-per-shard {per}: stencil "
                "crosses non-neighbor shards; use fewer devices or the "
                "all_gather path")
        win = per + 2 * B
        # Validate the one-neighbor halo invariant row-exactly: every
        # nonzero of shard s must fall in [s*per - B, (s+1)*per + B).
        coo = Ap.tocoo()
        s_of_row = coo.row // per
        lo = s_of_row * per - B
        if ((coo.col < lo) | (coo.col >= lo + win)).any():
            raise ValueError(
                "operator stencil crosses the one-neighbor halo window; "
                "reorder with RCM or use the all_gather path")

        tiles_per = per // tile
        band = np.zeros((n_dev, per, B), dtype=np.float32)
        starts_rel = np.zeros((n_dev, tiles_per), dtype=np.int32)
        bands_t, starts_t_list = [], []
        B_t_max = 128
        blocks_t = []
        for s in range(n_dev):
            w0 = s * per - B
            block = Ap[s * per:(s + 1) * per, :].tocoo()
            rows, cols, vals = block.row, block.col - w0, block.data
            blk = sp.csr_matrix((vals, (rows, cols)), shape=(per, win))
            # Forward band: per-tile windows, clamped into the window.
            st, en, _, _ = _tile_windows(blk.indptr, blk.indices, per, tile)
            st = np.minimum(st, win - B)
            deg = np.diff(blk.indptr)
            r = np.repeat(np.arange(per), deg)
            band[s][r, blk.indices - st[r // tile]] = blk.data
            starts_rel[s] = st.astype(np.int32)
            blk_t = blk.T.tocsr()
            blocks_t.append(blk_t)
            stt, ent, _, _ = _tile_windows(
                blk_t.indptr, blk_t.indices, win, tile)
            spread_t = int((ent - stt + 1).max()) if stt.size else 1
            B_t_max = max(B_t_max, _round_up(max(spread_t, 128), 128))
        band_t_list = []
        starts_t_arr = None
        for s in range(n_dev):
            bt, stt, _ = _rect_banded(blocks_t[s], tile, bandwidth=B_t_max)
            band_t_list.append(bt)
            if starts_t_arr is None:
                starts_t_arr = np.zeros((n_dev, len(stt)), dtype=np.int32)
            starts_t_arr[s] = stt

        op = cls(
            band=band.astype(dtype),
            starts=starts_rel,
            band_t=np.stack(band_t_list).astype(dtype),
            starts_t=starts_t_arr,
            n=n, n_dev=n_dev, per=per, B=B, tile=tile)
        return op, perm


def _halo_spmm(op: ShardedBanded, mesh: Mesh, axis: str, u_padded):
    """Two (B, k) ppermutes + one shard-local banded SpMM; differentiable
    (banded VJP via the prebuilt transpose blocks, ppermute cotangents
    routed back by shard_map AD)."""
    per, B, tile, win = op.per, op.B, op.tile, op.win
    n_dev = op.n_dev

    def inner(band, starts, band_t, starts_t, u_blk):
        u = u_blk[0]                                    # (per, k)
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        left = jax.lax.ppermute(u[-B:], axis, fwd)      # left nbr's tail
        right = jax.lax.ppermute(u[:B], axis, bwd)      # right nbr's head
        window = jnp.concatenate([left, u, right], axis=0)  # (win, k)
        A_t = BandedELL(band_t[0], starts_t[0], n=win, n_cols=per,
                        tile=tile)
        A_loc = BandedELL(band[0], starts[0], n=per, n_cols=win,
                          tile=tile, transpose_banded=A_t)
        return banded_spmm(A_loc, window)[None]

    f = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis))
    k = u_padded.shape[-1]
    out = f(op.band, op.starts, op.band_t, op.starts_t,
            u_padded.reshape(n_dev, per, k))
    return out.reshape(-1, k)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedRemainder:
    """Row-sharded gather-ELL term applied against an all_gather'd U.

    Carries the cluster-boundary entries of a SplitBanded operator whose
    columns cross non-neighbor shards (sparse/split.py breaks the halo
    invariant by construction). Values must be SYMMETRIC as a global
    matrix — the sharded split SpMM reuses the forward as its VJP.
    """

    indices: Any   # (n_dev, per, W) global columns
    values: Any    # (n_dev, per, W)
    n: int
    n_dev: int

    def tree_flatten(self):
        return ((self.indices, self.values), (self.n, self.n_dev))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_scipy(cls, R, n_dev: int, per: int, dtype=jnp.float32):
        import scipy.sparse as sp

        R = R.tocsr()
        n = R.shape[0]
        n_pad = per * n_dev
        if n_pad != n:
            R = sp.block_diag(
                [R, sp.csr_matrix((n_pad - n, n_pad - n))]).tocsr()
        W = max(int(np.diff(R.indptr).max()) if R.nnz else 1, 1)
        idx = np.zeros((n_pad, W), dtype=np.int32)
        val = np.zeros((n_pad, W), dtype=np.float32)
        deg = np.diff(R.indptr)
        rows = np.repeat(np.arange(n_pad), deg)
        slot = np.arange(R.nnz) - np.repeat(R.indptr[:-1], deg)
        idx[rows, slot] = R.indices
        val[rows, slot] = R.data
        return cls(idx.reshape(n_dev, per, W),
                   val.reshape(n_dev, per, W).astype(dtype), n, n_dev)


def _remainder_spmm(rem: ShardedRemainder, mesh: Mesh, axis: str,
                    u_padded):
    n_dev, per = rem.n_dev, rem.indices.shape[1]

    def rem_inner(idx, val, u_blk):
        u_full = jax.lax.all_gather(u_blk[0], axis, tiled=True)
        gathered = u_full[idx[0]]                       # (per, W, k)
        out = jnp.einsum("rwk,rw->rk", gathered, val[0],
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        return out.astype(u_full.dtype)[None]

    f_rem = jax.shard_map(
        rem_inner, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(axis))
    k = u_padded.shape[-1]
    return f_rem(rem.indices, rem.values,
                 u_padded.reshape(n_dev, per, k)).reshape(-1, k)


def _float_zeros(x):
    """Zero cotangent of one operator leaf (float0 for integer tables)."""
    if jnp.issubdtype(x.dtype, jnp.integer):
        return np.zeros(x.shape, jax.dtypes.float0)
    return jnp.zeros_like(x)


@jax.custom_vjp
def _split_spmm(A: "ShardedSpMM", u_padded):
    return (_halo_spmm(A.core, A.mesh, A.axis, u_padded)
            + _remainder_spmm(A.rem, A.mesh, A.axis, u_padded))


def _split_fwd(A, u_padded):
    return _split_spmm(A, u_padded), A


def _split_bwd(A, g):
    # A symmetric => A^T g = A g; the operator is a constant.
    return jax.tree_util.tree_map(_float_zeros, A), _split_spmm(A, g)


_split_spmm.defvjp(_split_fwd, _split_bwd)


@jax.tree_util.register_pytree_node_class
class ShardedSpMM:
    """U_sharded (n_pad, k) -> A U: the halo-banded core, plus for a
    cluster-split operator the all_gather'd remainder.

    A pytree whose operator arrays are its children, so a jitted caller
    takes them as arguments: captured by a closure they would be baked
    into the executable as constants, which a multi-GB operator (300k
    nodes) does not fit. The factories below put shard s of every array
    on device s once, so no device ever holds the whole operator and no
    call reshards it.
    """

    def __init__(self, core: ShardedBanded, rem, mesh: Mesh,
                 axis: str = "data"):
        self.core, self.rem, self.mesh, self.axis = core, rem, mesh, axis

    def tree_flatten(self):
        return (self.core, self.rem), (self.mesh, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def __call__(self, u_padded):
        if self.rem is None:
            return _halo_spmm(self.core, self.mesh, self.axis, u_padded)
        return _split_spmm(self, u_padded)


def _place(tree, mesh: Mesh, axis: str):
    """Shard every (n_dev, ...) operator array over the mesh axis."""
    return jax.device_put(tree, NamedSharding(mesh, P(axis)))


def sharded_banded_spmm(op: ShardedBanded, mesh: Mesh,
                        axis: str = "data") -> ShardedSpMM:
    """f(U_sharded (n_pad, k)) -> (A U) sharded, for a halo-banded A."""
    return ShardedSpMM(_place(op, mesh, axis), None, mesh, axis)


def sharded_split_spmm(core: ShardedBanded, rem: ShardedRemainder | None,
                       mesh: Mesh, axis: str = "data") -> ShardedSpMM:
    """f(U_sharded) -> (A_band + A_rem) U for a SYMMETRIC split operator.

    Core rides the halo path; the remainder all_gathers U (its columns
    cross clusters arbitrarily). The VJP reapplies the forward — valid
    because SplitBanded.from_scipy enforces numeric symmetry.
    """
    return ShardedSpMM(_place(core, mesh, axis), _place(rem, mesh, axis),
                       mesh, axis)


def _split_decompose(Ap, tile: int, window: int):
    """Core/remainder split of an (already ordered) CSR operator.

    Same symmetric rule as sparse/split.py:145-159: an entry stays in the
    banded core only if it fits its row's row-centered window AND its
    mirror fits the mirror row's window — keeping the core numerically
    symmetric for symmetric A. Returns (core_csr, rem_csr).
    """
    import scipy.sparse as sp

    n = Ap.shape[0]
    n_pad = _round_up(max(n, tile), tile)
    B = _round_up(min(window, n_pad), 128)
    t_ids = np.arange(n_pad // tile)
    starts = np.clip(t_ids * tile + tile // 2 - B // 2, 0,
                     max(n_pad - B, 0)).astype(np.int64)
    coo = Ap.tocoo()
    local = coo.col - starts[coo.row // tile]
    in_band = (local >= 0) & (local < B)
    local_m = coo.row - starts[coo.col // tile]
    in_band &= (local_m >= 0) & (local_m < B)
    core = sp.coo_matrix(
        (coo.data[in_band], (coo.row[in_band], coo.col[in_band])),
        shape=(n, n)).tocsr()
    rem = sp.coo_matrix(
        (coo.data[~in_band], (coo.row[~in_band], coo.col[~in_band])),
        shape=(n, n)).tocsr()
    rem.eliminate_zeros()
    return core, rem


def build_sharded_operator(A, n_dev: int, X=None, dtype=jnp.float32,
                           tile: int = 128, max_bandwidth: int = 4096,
                           window: int = 1024):
    """Canonicalize a scipy operator for an n_dev mesh.

    Tries the pure halo-banded form first; falls back to the
    cluster-split form (banded core via halo + sparse remainder via
    all_gather) when the global RCM bandwidth is too wide — the 1M-point
    cloud regime (sparse/split.py's motivation, now sharded).
    Returns (kind, (core, remainder_or_None), perm) with kind
    'banded' | 'split'; apply the perm to all node-indexed data.
    """
    try:
        op, perm = ShardedBanded.from_scipy(
            A, n_dev, dtype=dtype, tile=tile, max_bandwidth=max_bandwidth)
        return "banded", (op, None), perm
    except ValueError:
        pass

    if X is not None:
        from eigenpinns_tpu.sparse.split import spatial_cluster_order

        n = A.shape[0]
        n_clusters = max(n_dev, int(np.ceil(n / max(window * 24, 1))))
        perm = spatial_cluster_order(np.asarray(X), n_clusters, adjacency=A)
    else:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(A.tocsr(),
                                                symmetric_mode=True))
    Ap = A.tocsr()[perm][:, perm].tocsr()
    # The banded core must satisfy the one-neighbor halo invariant, so
    # its window can never exceed the per-shard row count.
    per = _round_up(-(-A.shape[0] // n_dev), tile)
    window = min(window, per)
    core_sp, rem_sp = _split_decompose(Ap, tile, window)
    core_op, _ = ShardedBanded.from_scipy(
        core_sp, n_dev, dtype=dtype, tile=tile,
        reorder=False, max_bandwidth=max_bandwidth)
    rem = (ShardedRemainder.from_scipy(rem_sp, n_dev, core_op.per,
                                       dtype=dtype)
           if rem_sp.nnz else None)
    return "split", (core_op, rem), perm
