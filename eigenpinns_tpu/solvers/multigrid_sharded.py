"""Node-sharded multigrid corrector training — the distributed form of
the flagship production pipeline.

`MultigridTrainer.train(h, n_devices=...)` swaps its single-device scan
loop for the loss built here; preprocessing (CGC, features) and
postprocessing (extraction, Rayleigh-Ritz, polish) stay on the canonical
single-device layout — the training loop is where the epochs x FLOPs
live. The reference trains this model strictly single-device
(src/multigrid_model.py:226-279); SURVEY.md sec 2.3's "multigrid
hierarchy parallelism" row calls for sharding levels and nodes jointly,
which is exactly the layout used:

  * every level l is row-sharded over the SAME mesh "data" axis: per-l
    shard size per_l = roundup(ceil(n_l / n_dev), 128), so each device
    owns [level0 shard s | level1 shard s | ...] — levels and nodes
    jointly sharded, no device idles while any level trains;
  * per-level K/M/graph SpMMs ride the halo-banded sharded kernels
    (parallel/sharded_banded.py: two (B, k) ppermutes over ICI + a
    shard-local banded product, scatter-free VJP) with a per-level
    RCM order; levels whose post-RCM stencil cannot satisfy the
    one-neighbor halo fall back to an all_gather ELL path;
  * the GNN corrector forward is applied PER LEVEL — mathematically
    identical to the single-device concatenated-graph apply because the
    hierarchy graph is block-diagonal (edges never cross levels,
    solvers/multigrid.py _concat_edges) and the MLP is row-local;
  * cross-level projection terms (P^T U_f vs U_c) apply the padded
    prolongation transpose as a plain gather-ELL under GSPMD (XLA
    inserts the all_gather; the term is O(n_coarse) and secondary);
  * k x k Grams / Rayleigh quotients are jnp einsums over the sharded
    node axis — XLA GSPMD inserts the psums over ICI; parameters are
    replicated and the gradient all-reduce comes from the sharding
    constraints (the scaling-book recipe, same as direct_sharded.py).

Numerics match the single-device loss exactly up to summation order:
per-level means are computed over padded rows and rescaled by
n_pad_l / n_l, and corrections are masked to true rows so padded rows
carry exact zeros (asserted against the single-device trainer in
tests/test_multigrid.py::test_multigrid_sharded_matches_single_device).

Like direct_sharded.py, the sharded operator arrays are closure-captured
by the loss (hoisted to jit constants): one resident copy per
executable. The double-resident hierarchy (single-device ops for
pre/post + sharded ops for the loop) is the accepted cost of exact
parity; free h.K_ops/M_ops before train() at 300k+ if HBM is tight.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from eigenpinns_tpu.losses import (
    eigenvalue_target,
    ordering,
    rayleigh_residual_orth,
    trace_loss,
    zero_mean,
)
from eigenpinns_tpu.parallel.sharded import ShardedOperator
from eigenpinns_tpu.parallel.sharded_banded import (
    ShardedBanded,
    sharded_banded_spmm,
)
from eigenpinns_tpu.sparse import SparseELL, m_normalize_columns, spmm
from eigenpinns_tpu.sparse.banded import _round_up
from eigenpinns_tpu.sparse.ops import FunctionOperator


def _to_scipy(op):
    """Host CSR from a SparseELL/Diagonal device operator."""
    import scipy.sparse as sp

    if hasattr(op, "to_scipy"):
        return op.to_scipy()
    idx = np.asarray(op.indices)
    val = np.asarray(op.values, dtype=np.float64)
    n, w = idx.shape
    rows = np.repeat(np.arange(n), w)
    A = sp.coo_matrix((val.ravel(), (rows, idx.ravel())),
                      shape=(n, op.n_cols)).tocsr()
    A.eliminate_zeros()
    return A


def _pad_cols_csr(A, n_rows: int, n_cols: int):
    """Grow a CSR block to (n_rows, n_cols) with empty rows/cols."""
    import scipy.sparse as sp

    A = A.tocsr()
    extra_rows = n_rows - A.shape[0]
    indptr = np.concatenate(
        [A.indptr, np.full(extra_rows, A.indptr[-1])])
    return sp.csr_matrix((A.data, A.indices, indptr),
                         shape=(n_rows, n_cols))


def _ag_ell_spmm(A_csr, n_dev: int, per: int, mesh, axis: str = "data"):
    """All-gather ELL fallback for a (possibly rectangular) sharded
    operator whose stencil breaks the one-neighbor halo invariant.
    Rows must already be padded to n_dev * per."""
    ell = SparseELL.from_scipy(A_csr)
    op = ShardedOperator.from_ell(ell, n_dev)
    assert op.rows_per_dev == per, (op.rows_per_dev, per)
    idx, val = op.indices, op.values

    def inner(idx, val, u_blk):
        u_full = jax.lax.all_gather(u_blk[0], axis, tiled=True)
        gathered = u_full[idx[0]]
        out = jnp.einsum("rwk,rw->rk", gathered, val[0],
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        return out.astype(u_full.dtype)[None]

    f = jax.shard_map(inner, mesh=mesh,
                      in_specs=(P(axis), P(axis), P(axis)),
                      out_specs=P(axis))

    def apply(u_padded):
        k = u_padded.shape[-1]
        out = f(idx, val, u_padded.reshape(n_dev, -1, k))
        return out.reshape(-1, k)

    return apply


def build_sharded_multigrid_loop(h, cfg, mesh, model, feats, U_base,
                                 lam_target, graph_kind: str,
                                 max_bandwidth: int = 4096):
    """Shard the hierarchy and return (data, loss_fn) for the scan loop.

    `feats` / `U_base` are the canonical single-device concatenated
    arrays already built by MultigridTrainer.train; they are re-laid-out
    here (per-level RCM perm + padding + device placement). The returned
    loss_fn(params, epoch, data) mirrors the single-device loss term by
    term (same weights from cfg, pad-corrected means).
    """
    n_dev = int(mesh.devices.size)
    offsets = h.node_offsets
    sizes = h.actual_hierarchy
    n_levels = h.n_levels
    shard = NamedSharding(mesh, P("data"))

    levels: list[dict] = []      # static per-level sizes
    data_levels: list[dict] = []  # traced per-level arrays

    perms = []
    pers = []
    for i, (off, n_l) in enumerate(zip(offsets, sizes)):
        K_sp = h.K_scipy[i].tocsr()
        M_sp = h.M_scipy[i].tocsr()
        if graph_kind == "spectral":
            from eigenpinns_tpu.sparse.ops import gcn_normalized_adjacency

            G_sp = _to_scipy(
                gcn_normalized_adjacency(h.edge_index_list[i], n_l))
        else:
            from eigenpinns_tpu.sparse.ops import neighbor_mean_scipy

            G_sp = neighbor_mean_scipy(h.edge_index_list[i], n_l)

        # K picks the per-level RCM order; M and the graph reuse it so
        # the level's node data lives in ONE layout.
        try:
            opK, perm = ShardedBanded.from_scipy(
                K_sp, n_dev, max_bandwidth=max_bandwidth)
            spK = sharded_banded_spmm(opK, mesh)
            per = opK.per
            banded = True
        except ValueError:
            perm = np.arange(n_l)
            per = _round_up(max(-(-n_l // n_dev), 1), 128)
            spK = _ag_ell_spmm(
                _pad_cols_csr(K_sp, per * n_dev, per * n_dev),
                n_dev, per, mesh)
            banded = False
        n_pad = per * n_dev
        perms.append(perm)
        pers.append(per)

        def _same_perm_spmm(A_sp, symmetric_ok: bool):
            Ap = A_sp[perm][:, perm].tocsr()
            if banded:
                try:
                    opA, _ = ShardedBanded.from_scipy(
                        Ap, n_dev, reorder=False,
                        max_bandwidth=max_bandwidth)
                    if opA.per == per:
                        return sharded_banded_spmm(opA, mesh)
                except ValueError:
                    pass
            return _ag_ell_spmm(_pad_cols_csr(Ap, n_pad, n_pad),
                                n_dev, per, mesh)

        import scipy.sparse as sp

        if (M_sp - sp.diags(M_sp.diagonal())).nnz == 0:
            d = np.zeros(n_pad, np.float32)
            d[:n_l] = M_sp.diagonal()[perm]
            d_sh = jax.device_put((d), shard)

            def spM(u, _d=d_sh):
                return _d[:, None] * u
        else:
            spM = _same_perm_spmm(M_sp, True)
        spG = _same_perm_spmm(G_sp, False)

        dK = np.zeros(n_pad, np.float32)
        dK[:n_l] = K_sp.diagonal()[perm]
        dM = np.zeros(n_pad, np.float32)
        dM[:n_l] = M_sp.diagonal()[perm]

        levels.append({"n": n_l, "n_pad": n_pad, "per": per})

        # Re-layout this level's segment of the canonical arrays.
        f_l = np.asarray(feats[off:off + n_l])[perm]
        u_l = np.asarray(U_base[off:off + n_l])[perm]
        f_p = np.zeros((n_pad, f_l.shape[1]), f_l.dtype)
        f_p[:n_l] = f_l
        u_p = np.zeros((n_pad, u_l.shape[1]), u_l.dtype)
        u_p[:n_l] = u_l
        mask = np.zeros((n_pad, 1), np.float32)
        mask[:n_l] = 1.0
        # The operators are traced data, not closure constants: a
        # 300k-node level's band does not fit in an executable.
        data_levels.append({
            "K": FunctionOperator(spK, jax.device_put((dK),
                                                      shard)),
            "M": FunctionOperator(spM, jax.device_put((dM),
                                                      shard)),
            "G": FunctionOperator(spG, None),
            "feats": jax.device_put((f_p), shard),
            "U_base": jax.device_put((u_p), shard),
            "mask": jax.device_put((mask), shard),
        })

    # Prolongation transposes between consecutive levels, in the new
    # per-level layouts (rows: coarse perm+pad, cols: fine perm+pad).
    Pt_padded: list = [None] * n_levels
    if cfg.weight_projection > 0:
        for i in range(1, n_levels):
            Pt_sp = _to_scipy(h.Pt_ops[i - 1]).tocsr()
            Pt_p = Pt_sp[perms[i - 1]][:, perms[i]]
            Pt_padded[i] = SparseELL.from_scipy(_pad_cols_csr(
                Pt_p, pers[i - 1] * n_dev, pers[i] * n_dev))

    data = {
        "levels": tuple(data_levels),
        "Pt": tuple(Pt_padded),
        "lam_target": jnp.asarray(lam_target),
    }

    def loss_fn(params, epoch, data):
        ramp = jnp.minimum(1.0, epoch.astype(jnp.float32)
                           / float(cfg.scale_ramp_epochs))
        loss_res = 0.0
        loss_orth = 0.0
        loss_proj = 0.0
        lam_levels = []
        U_slices = []
        for i, (lv, d) in enumerate(zip(levels, data["levels"])):
            corr_raw = model.apply(params, d["feats"], d["G"])
            U_l = (d["U_base"]
                   + cfg.corrector_scale * ramp * corr_raw * d["mask"])
            if cfg.normalize_in_loss:
                U_l = m_normalize_columns(U_l, d["M"])
            U_slices.append(U_l)
            lam_l, res_l, orth_l = rayleigh_residual_orth(
                U_l, d["K"], d["M"])
            # jnp.mean ran over padded rows; correct to the true-n mean.
            res_l = res_l * (lv["n_pad"] / lv["n"])
            lam_levels.append(lam_l)
            loss_res = loss_res + res_l
            loss_orth = loss_orth + orth_l
            if cfg.weight_projection > 0 and i >= 1:
                pt_u = spmm(data["Pt"][i], U_l)
                d_prev = (pt_u - U_slices[i - 1])
                loss_proj = loss_proj + (
                    jnp.mean(d_prev**2)
                    * (levels[i - 1]["n_pad"] / levels[i - 1]["n"]))
            if cfg.w_zero_mean > 0:
                loss_res = loss_res + (cfg.w_zero_mean
                                       / cfg.weight_residual
                                       ) * zero_mean(U_l, d["M"])
        lam0 = lam_levels[0]
        loss_trace = trace_loss(lam0)
        loss_order = ordering(lam0)
        loss_eigen = eigenvalue_target(lam0, data["lam_target"])
        total = (cfg.weight_residual * loss_res
                 + cfg.weight_orthogonal * loss_orth
                 + cfg.weight_projection * loss_proj
                 + cfg.weight_trace * loss_trace
                 + cfg.w_order * loss_order
                 + cfg.w_eigen * loss_eigen)
        metrics = {
            "loss": total,
            "res": cfg.weight_residual * loss_res,
            "orth": cfg.weight_orthogonal * loss_orth,
            "proj": cfg.weight_projection * loss_proj,
            "trace": cfg.weight_trace * loss_trace,
            "order": cfg.w_order * loss_order,
            "eigen": cfg.w_eigen * loss_eigen,
            "scale": cfg.corrector_scale * ramp,
        }
        return total, metrics

    return data, loss_fn
