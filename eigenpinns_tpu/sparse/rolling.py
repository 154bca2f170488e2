"""Rolling-window banded format: one uniform window per row tile.

`BandedELL` (banded.py) gives each row tile its own window start, so
consecutive windows of U overlap by B - tile rows at data-dependent
offsets. This format makes the window UNIFORM — window(t) = padded rows
[t*tile, t*tile + B) of U, with U top-padded by `pre` zero rows — and
stores the band with its columns rotated onto a ring of B' = B + tile
positions:

  * ring position of padded row p is p mod B';
  * the band's local column j maps to ring position (col + pre) mod B'
    — independent of the tile — so the rotation is applied ONCE to the
    band's columns at build time.

The SpMM un-rotates each tile's window with one gather and multiplies
the (tile, B') band block against it.

Same VJP structure as banded.py: symmetric operators reuse the band for
A^T, nonsymmetric ones carry an explicitly rotated transpose band.
Replaces the reference's torch.sparse COO SpMV hot op
(src/multigrid_model.py:306-322).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from eigenpinns_tpu.sparse.banded import _round_up
from eigenpinns_tpu.sparse.ops import operator_dot

# Device-side band assembly: above this size the host neither fills nor
# uploads the materialized dense band (4.6 GB at 300k nodes); only the
# nnz triplets (~26 MB at 300k) travel and the band is scattered on
# device.
_SCATTER_CACHE: dict = {}
_DEVICE_BUILD_MIN_BYTES = 1 << 28   # 256 MB: below this, host build is fine


def _scatter_band(shape, dtype, rows, cols, vals):
    key = (shape, str(dtype))
    fn = _SCATTER_CACHE.get(key)
    if fn is None:
        def build(r, c, v):
            z = jnp.zeros(shape, dtype)
            return z.at[r, c].set(v.astype(dtype))
        fn = _SCATTER_CACHE[key] = jax.jit(build)
    return fn(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RollingBanded:
    """Column-rotated uniform-window banded matrix.

    band: (N_pad, B') float — row i's entry for column c sits at
          band[i, (c + pre) mod B']
    pre:  top padding of U (multiple of tile): window(t) starts at
          original row t*tile - pre
    win:  B — the window height (B' = band.shape[1] = B + tile)
    n:    true row count; tile: rows per tile
    """

    band: Any
    pre: int
    win: int
    n: int
    tile: int
    transpose_rolling: Any = None   # RollingBanded | None (None = symmetric)
    # Precision of the band product (sparse.ops.operator_dot): 'highest'
    # (full f32), 'high' (Precision.HIGH, TF32 tensor cores on the H100:
    # ~1e-3 relative error, training-loss grade) or 'bf16' (band STORED
    # in bf16 — half the bytes; the operator itself is rounded to ~3
    # decimal digits, which only the training loss tolerates).
    # Rayleigh-Ritz/LOBPCG polish should see 'highest' (with_precision()).
    mxu_precision: str = "highest"

    def tree_flatten(self):
        if self.transpose_rolling is None:
            return ((self.band,), (self.pre, self.win, self.n, self.tile,
                                   False, self.mxu_precision))
        return ((self.band, self.transpose_rolling),
                (self.pre, self.win, self.n, self.tile, True,
                 self.mxu_precision))

    @classmethod
    def tree_unflatten(cls, aux, children):
        pre, win, n, tile, has_t, prec = aux
        if has_t:
            return cls(children[0], pre, win, n, tile, children[1], prec)
        return cls(children[0], pre, win, n, tile, None, prec)

    def with_precision(self, precision: str) -> "RollingBanded":
        """Same operator, different product precision. 'highest'/'high'
        share the f32 band; 'bf16' materializes a half-size bf16 band
        (a one-time device cast — keep the f32 original around for the
        solver-grade paths)."""
        t = (None if self.transpose_rolling is None
             else self.transpose_rolling.with_precision(precision))
        band = self.band
        if precision == "bf16" and band.dtype != jnp.bfloat16:
            band = band.astype(jnp.bfloat16)
        elif precision != "bf16" and band.dtype == jnp.bfloat16:
            # Solver-grade precision requested on a bf16-stored band:
            # restore f32 storage. The bf16 roundtrip already dropped
            # mantissa bits — prefer keeping the f32 original around.
            band = band.astype(jnp.float32)
        return dataclasses.replace(self, band=band,
                                   mxu_precision=precision,
                                   transpose_rolling=t)

    @property
    def bandwidth(self) -> int:
        return self.band.shape[1]

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def n_cols(self) -> int:
        return self.n

    def diagonal(self) -> jax.Array:
        """Row i's diagonal sits at band[i, (i + pre) mod B']."""
        bp = self.band.shape[1]
        rows = jnp.arange(self.band.shape[0])
        return self.band[rows, (rows + self.pre) % bp][: self.n]

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32, tile: int = 128,
                   reorder: bool = True, max_bandwidth: int = 4096,
                   with_transpose: bool = True):
        """Convert a scipy sparse matrix; returns (op, perm) like
        BandedELL.from_scipy. Raises ValueError past max_bandwidth."""
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
        coo = Ap.tocoo()
        t_of = coo.row // tile
        # pre >= t*tile - min col of tile t; post >= max col - t*tile + 1
        rel_lo = t_of * tile - coo.col        # how far cols reach LEFT
        rel_hi = coo.col - t_of * tile + 1    # ... and RIGHT
        pre = _round_up(max(int(rel_lo.max(initial=0)), 0), tile)
        post = max(int(rel_hi.max(initial=1)), tile)
        B = _round_up(pre + post, tile)
        if B > max_bandwidth:
            raise ValueError(
                f"uniform-window bandwidth {B} exceeds max_bandwidth="
                f"{max_bandwidth}; use the ELL/split path")
        bp = B + tile

        np_dtype = np.dtype(jnp.dtype(dtype).name)
        if n_pad * bp * np_dtype.itemsize >= _DEVICE_BUILD_MIN_BYTES:
            band = _scatter_band(
                (n_pad, bp), dtype,
                coo.row.astype(np.int32),
                ((coo.col + pre) % bp).astype(np.int32),
                coo.data.astype(np.float32))
        else:
            band_np = np.zeros((n_pad, bp), dtype=np_dtype)
            band_np[coo.row, (coo.col + pre) % bp] = \
                coo.data.astype(band_np.dtype)
            band = jnp.asarray(band_np, dtype=dtype)

        transpose = None
        if with_transpose:
            d = (Ap - Ap.T).tocsr()
            if d.nnz and abs(d).max() > 1e-12 * max(abs(Ap).max(), 1e-300):
                transpose = cls.from_scipy(
                    Ap.T.tocsr(), dtype=dtype, tile=tile, reorder=False,
                    max_bandwidth=max_bandwidth, with_transpose=False)[0]

        op = cls(band, pre, B, n, tile, transpose)
        return op, perm

    def pad_u(self, U: jax.Array) -> jax.Array:
        """[pre zero rows; U; zeros] so every window/delta read is valid
        (length n_pad + B')."""
        n_pad = self.band.shape[0]
        target = n_pad + self.band.shape[1]
        bottom = target - self.pre - U.shape[0]
        if bottom < 0:
            raise ValueError("U longer than padded layout")
        return jnp.pad(U, ((self.pre, bottom), (0, 0)))


def _rolling_matmul(A: RollingBanded, U: jax.Array) -> jax.Array:
    """A @ U: un-rotate each tile's window, one (tile, B') product each."""
    Up = A.pad_u(U)
    tile, bp = A.tile, A.band.shape[1]
    n_tiles = A.band.shape[0] // tile

    def one_tile(t):
        # ring position j holds padded row t*tile + ((j - t*tile) mod B')
        j = jnp.arange(bp)
        rows = t * tile + ((j - t * tile) % bp)
        window = Up[rows]
        return operator_dot(
            jax.lax.dynamic_slice_in_dim(A.band, t * tile, tile, axis=0),
            window, A.mxu_precision).astype(U.dtype)

    out = jax.vmap(one_tile)(jnp.arange(n_tiles))
    return out.reshape(-1, U.shape[1])[: A.n]


def _zero_like(A):
    # dataclasses.replace keeps EVERY aux field (notably mxu_precision) —
    # the cotangent's pytree structure must match the primal's exactly.
    dt = (None if A.transpose_rolling is None
          else _zero_like(A.transpose_rolling))
    return dataclasses.replace(A, band=jnp.zeros_like(A.band),
                               transpose_rolling=dt)


@jax.custom_vjp
def rolling_spmm(A: RollingBanded, U: jax.Array) -> jax.Array:
    """A @ U; backward applies A^T with the same product (operator is a
    constant of the optimization, zero cotangent)."""
    return _rolling_matmul(A, U)


def _fwd(A, U):
    return _rolling_matmul(A, U), A


def _bwd(A, g):
    At = A.transpose_rolling if A.transpose_rolling is not None else A
    return (_zero_like(A), _rolling_matmul(At, g))


rolling_spmm.defvjp(_fwd, _bwd)


def rolling_spmm_gram(A: RollingBanded, U: jax.Array):
    """(A @ U, U^T A U) — see banded.banded_spmm_gram."""
    W = rolling_spmm(A, U)
    G = jnp.dot(U.T, W, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32).astype(U.dtype)
    return W, G
