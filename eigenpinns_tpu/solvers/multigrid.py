"""Multigrid GNN eigen-refinement trainer — the production pipeline.

Capability parity with `MultigridGNN.train_multiresolution`
(src/multigrid_model.py:42-92) redesigned for the device:

  * the hierarchy's operators enter as padded-ELL/diagonal pytrees built
    ONCE (vs the reference's per-epoch scipy->torch conversion,
    src/multigrid_model.py:306-307);
  * coarse-grid correction, Rayleigh-Ritz, feature building, the full
    training loop and final refinement all run on device;
  * epochs are fused into jitted lax.scan chunks with on-carry early-stop
    bookkeeping (eigenpinns_tpu.train.loop) — no per-epoch host sync;
  * the projection loss (transfer_learning_downsampling.ipynb cell
    0:155-157) is actually implemented (the reference src keeps a zero
    placeholder, src/multigrid_model.py:346).

Pipeline: CGC init -> M-normalize -> physics features -> corrector
training (residual + Gram + spectral-structure losses) -> per-level
normalization -> finest-level extraction -> robust Rayleigh-Ritz.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from eigenpinns_tpu.losses import (
    eigenvalue_target,
    ordering,
    projection,
    rayleigh_residual_orth,
    trace_loss,
    zero_mean,
)
from eigenpinns_tpu.models import make_corrector
from eigenpinns_tpu.sparse import (
    gcn_normalized_adjacency,
    m_normalize_columns,
    neighbor_mean_operator,
    spmm,
)
from eigenpinns_tpu.solvers.rayleigh_ritz import (
    rayleigh_ritz,
    rayleigh_ritz_robust,
)
from eigenpinns_tpu.solvers.smoothers import coarse_grid_correction
from eigenpinns_tpu.train.loop import LoopResult, run_scan_loop
from eigenpinns_tpu.train.optim import adam_plateau


class MGState(NamedTuple):
    params: Any
    opt_state: Any
    plateau_state: Any


@dataclasses.dataclass
class MultigridResult:
    eigenvalues: np.ndarray       # (k,) refined finest-level eigenvalues
    eigenvectors: np.ndarray      # (N_finest, k) refined
    U_all: np.ndarray             # (sum N_l, k) normalized predictions
    history: dict
    epochs_run: int
    wall_time: float
    level_eigenvalues: list[np.ndarray]
    chunk_times: list
    steady_steps_per_sec: float | None = None  # cfg.timing_chunks probe


def _level_features(X, U_norm, lam, edge_index, K, M, level_idx, n_levels):
    """Physics-informed node features, parity with `_compute_level_features`
    (src/multigrid_model.py:159-201): [xyz, level indicator, normalized
    degree, diag K, diag M, residual magnitude, per-node Rayleigh, U_norm]
    -> (N, 8 + k)."""
    n = X.shape[0]
    X_t = jnp.asarray(X, dtype=U_norm.dtype)
    res_feat = jnp.full((n, 1), float(n_levels - 1 - level_idx),
                        dtype=U_norm.dtype)
    deg = np.bincount(np.asarray(edge_index[0]), minlength=n).astype(
        np.float64)
    deg_feat = jnp.asarray(deg / (deg.max() + 1e-12),
                           dtype=U_norm.dtype)[:, None]
    K_diag = K.diagonal()[:, None]
    M_diag = M.diagonal()[:, None]
    Ku = spmm(K, U_norm)
    Mu = spmm(M, U_norm)
    res_vec = Ku - Mu * lam[None, :]
    res_mag = jnp.linalg.norm(res_vec, axis=1, keepdims=True)
    res_mag = res_mag / (jnp.max(res_mag) + 1e-12)
    rayleigh = (jnp.sum(U_norm * Ku, axis=1, keepdims=True)
                / (jnp.sum(U_norm * Mu, axis=1, keepdims=True) + 1e-12))
    rayleigh = rayleigh / (jnp.max(lam) + 1e-12)
    return jnp.concatenate(
        [X_t, res_feat, deg_feat, K_diag, M_diag, res_mag, rayleigh, U_norm],
        axis=1)


class MultigridTrainer:
    """Drives corrector training over a preprocessed Hierarchy."""

    def __init__(self, config):
        self.cfg = config
        if config.model_type.lower() not in ("simple", "spectral",
                                             "adaptive"):
            raise ValueError(
                f"model_type must be 'simple', 'spectral' or 'adaptive', "
                f"got '{config.model_type}'")

    # ---- pipeline steps -------------------------------------------------

    def _init_cgc(self, h):
        """CGC on every fine level + eigenvalue estimates
        (src/multigrid_model.py:99-118)."""
        U_cgc = [h.U_list[0]]
        lam_list = []
        for i in range(1, h.n_levels):
            U_c, lam_f = coarse_grid_correction(
                h.U_list[i], h.K_ops[i], h.M_ops[i], h.K_ops[i - 1],
                h.P_ops[i - 1], h.Pt_ops[i - 1])
            U_cgc.append(U_c)
            lam_list.append(lam_f)
        lam0, _ = rayleigh_ritz(h.U_list[0], h.K_ops[0], h.M_ops[0])
        lam_list.insert(0, lam0)
        return U_cgc, lam_list

    def _build_features(self, h, U_norm_list, lam_list):
        feats = [
            _level_features(h.X_list[i], U_norm_list[i], lam_list[i],
                            h.edge_index_list[i], h.K_ops[i], h.M_ops[i],
                            i, h.n_levels)
            for i in range(h.n_levels)
        ]
        return jnp.concatenate(feats, axis=0)

    def _concat_edges(self, h):
        offs = h.node_offsets
        edges = [np.asarray(e) + offs[i]
                 for i, e in enumerate(h.edge_index_list)]
        return np.concatenate(edges, axis=1)

    # ---- training -------------------------------------------------------

    def train(self, h, log_fn=None, eval_callback=None, mesh=None,
              n_devices=None) -> MultigridResult:
        """Train the corrector over the hierarchy.

        `eval_callback(epochs_run, U_finest)` (optional) runs host-side
        after every scan chunk with the CURRENT finest-level
        M-normalized prediction (full corrector scale, same as the final
        extraction) — the hook behind mid-training subspace-error
        tracking.

        `mesh` / `n_devices` (or a nonempty `cfg.mesh_shape`) switch the
        TRAINING LOOP to the node-sharded distributed path
        (solvers/multigrid_sharded.py): every level row-sharded over the
        mesh's "data" axis, halo-banded per-level SpMMs, replicated
        parameters, GSPMD Gram psums. Preprocessing and the final
        extraction stay on the canonical single-device layout; results
        match the single-device trainer (asserted in
        tests/test_multigrid.py).
        """
        cfg = self.cfg
        k = cfg.n_modes

        U_cgc, lam_list = self._init_cgc(h)
        U_norm_list = [m_normalize_columns(U, M)
                       for U, M in zip(U_cgc, h.M_ops)]
        U_base = jnp.concatenate(U_norm_list, axis=0)
        feats = self._build_features(h, U_norm_list, lam_list)
        edges_np = self._concat_edges(h)
        n_total = feats.shape[0]

        model = make_corrector(cfg.model_type, cfg.hidden_layers, k,
                               cfg.dropout,
                               compute_dtype=(cfg.corrector_compute_dtype
                                              or None))
        if cfg.model_type.lower() == "spectral":
            graph = gcn_normalized_adjacency(edges_np, n_total)
        else:
            # Prebuilt mean-aggregation operator: scatter-free fwd AND bwd.
            # (Deliberately NOT banded: tiles spanning level-block
            # boundaries in the concatenated graph blow the window width.
            # The K/M loss operators, which dominate, stay banded per
            # level.)
            graph = neighbor_mean_operator(edges_np, n_total)

        params = model.init(jax.random.PRNGKey(cfg.seed), feats, graph)
        opt, plateau = adam_plateau(
            cfg.learning_rate, cfg.weight_decay, cfg.gradient_clipping,
            cfg.plateau_factor, cfg.plateau_patience)
        opt_state = opt.init(params)
        plateau_state = plateau.init(params)

        offsets = h.node_offsets
        sizes = h.actual_hierarchy

        # ---- distributed loop --------------------------------------
        # Resolved BEFORE the single-device loss data is built: the
        # sharded path supplies its own per-level layouts, so
        # materializing the single-device operator copies (incl. the
        # with_precision loss variants) would be pure wasted HBM at
        # 300k+ scale.
        repl_sharding = None
        if mesh is None and n_devices is None and cfg.mesh_shape:
            n_devices = int(np.prod(cfg.mesh_shape))
        sharded = mesh is not None or n_devices is not None
        if sharded:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from eigenpinns_tpu.parallel.mesh import make_mesh
            from eigenpinns_tpu.solvers.multigrid_sharded import (
                build_sharded_multigrid_loop,
            )

            if mesh is None:
                mesh = make_mesh(n_devices)
            data, loss_fn = build_sharded_multigrid_loop(
                h, cfg, mesh, model, feats, U_base, lam_list[0],
                graph_kind=cfg.model_type.lower())
            repl_sharding = NamedSharding(mesh, P())
            params = jax.device_put(params, repl_sharding)
            opt_state = jax.device_put(opt_state, repl_sharding)
            plateau_state = jax.device_put(plateau_state, repl_sharding)

        # Everything large travels as a jit ARGUMENT through the scan loop
        # (closure-captured arrays get baked into the executable: 2x HBM
        # and compile-payload blowups at scale — see train/loop docstring).
        def _loss_op(op):
            # Training-loss SpMMs tolerate cfg.loss_mxu_precision (TF32
            # or a bf16-stored operator); everything outside the loss
            # (features, RR, polish) keeps the operators' 'highest'.
            if hasattr(op, "with_precision"):
                return op.with_precision(cfg.loss_mxu_precision)
            return op

        use_fused = False
        if sharded and cfg.fuse_level_ops:
            # The sharded loss has no fused block-diagonal path — each
            # level rides its own RCM layout + halo-banded kernel, which
            # IS the sharded fusion strategy. An explicit True must not
            # be silently ignored (MIGRATION.md).
            import warnings

            warnings.warn(
                "fuse_level_ops=True: the sharded multigrid trainer has "
                "no fused block-diagonal path; training proceeds with "
                "per-level halo-banded dispatches (numerically identical "
                "loss — see MIGRATION.md)", stacklevel=2)
        if not sharded:
            data = {
                "feats": feats,
                "U_base": U_base,
                "graph": graph,
                "lam_target": lam_list[0],
                "Pt_ops": tuple(h.Pt_ops),
            }
            # ONE block-diagonal SpMM over the concatenated node axis
            # replaces n_levels per-level dispatches (fwd and VJP) — the
            # per-level loss is dispatch-bound at small/medium N, not
            # FLOP-bound (the hot op it fuses:
            # src/multigrid_model.py:306-322). Falls back to the
            # per-level path when the hierarchy cannot build the fused
            # operator (e.g. no host-side scipy matrices).
            # None = auto: fused on this (single-device) path.
            if cfg.fuse_level_ops is not False and len(h.K_ops) > 1:
                try:
                    K_blk, M_blk = h.fused_level_ops(
                        dtype=U_base.dtype)
                    data["K_blk"] = _loss_op(K_blk)
                    data["M_blk"] = _loss_op(M_blk)
                    use_fused = True
                except Exception as e:
                    import warnings

                    warnings.warn(
                        f"fuse_level_ops: fused operator build failed "
                        f"({e!r}); using per-level dispatches",
                        stacklevel=2)
            if not use_fused:
                data["K_ops"] = tuple(_loss_op(o) for o in h.K_ops)
                data["M_ops"] = tuple(_loss_op(o) for o in h.M_ops)

        def loss_fn_single(params, epoch, data):
            corr_raw = model.apply(params, data["feats"], data["graph"])
            ramp = jnp.minimum(1.0, epoch.astype(jnp.float32)
                               / float(cfg.scale_ramp_epochs))
            U_pred = data["U_base"] + cfg.corrector_scale * ramp * corr_raw
            loss_res = 0.0
            loss_orth = 0.0
            loss_proj = 0.0
            lam_levels = []
            U_slices = []
            if use_fused:
                # Two fused SpMMs for ALL levels; every per-level term
                # below is then dense slicing + k x k reductions.
                Ku_all = spmm(data["K_blk"], U_pred)
                Mu_all = spmm(data["M_blk"], U_pred)
            for i, (off, n) in enumerate(zip(offsets, sizes)):
                U_l = jax.lax.dynamic_slice_in_dim(U_pred, off, n, axis=0)
                if use_fused:
                    Ku = jax.lax.dynamic_slice_in_dim(Ku_all, off, n,
                                                      axis=0)
                    Mu = jax.lax.dynamic_slice_in_dim(Mu_all, off, n,
                                                      axis=0)
                    if cfg.normalize_in_loss:
                        # m_normalize_columns by linearity: K(U/c) =
                        # (K U)/c — no re-application of the operators.
                        c = jnp.sqrt(jnp.sum(U_l * Mu, axis=0) + 1e-12)
                        U_l, Ku, Mu = U_l / c, Ku / c, Mu / c
                    U_slices.append(U_l)
                    # Same terms as rayleigh_residual_orth, from the
                    # fused products (HIGHEST: the k x k Gram feeds the
                    # orth penalty — bf16 default would dominate it).
                    Gm = jnp.matmul(U_l.T, Mu,
                                    precision=jax.lax.Precision.HIGHEST)
                    lam_l = (jnp.sum(U_l * Ku, axis=0)
                             / (jnp.diagonal(Gm) + 1e-12))
                    res = Ku - Mu * lam_l[None, :]
                    loss_res = loss_res + jnp.mean(res**2)
                    loss_orth = loss_orth + jnp.sum(
                        (Gm - jnp.eye(k, dtype=U_l.dtype)) ** 2) / k
                    lam_levels.append(lam_l)
                    if cfg.w_zero_mean > 0:
                        # zero_mean by symmetry: (M 1)^T U = 1^T (M U).
                        moments = jnp.sum(Mu, axis=0)[1:]
                        loss_res = loss_res + (cfg.w_zero_mean
                                               / cfg.weight_residual
                                               ) * jnp.sum(moments**2)
                else:
                    K, M = data["K_ops"][i], data["M_ops"][i]
                    if cfg.normalize_in_loss:
                        U_l = m_normalize_columns(U_l, M)
                    U_slices.append(U_l)
                    lam_l, res_l, orth_l = rayleigh_residual_orth(U_l, K,
                                                                  M)
                    lam_levels.append(lam_l)
                    loss_res = loss_res + res_l
                    loss_orth = loss_orth + orth_l
                    if cfg.w_zero_mean > 0:
                        loss_res = loss_res + (cfg.w_zero_mean
                                               / cfg.weight_residual
                                               ) * zero_mean(U_l, M)
                if cfg.weight_projection > 0 and i >= 1:
                    loss_proj = loss_proj + projection(
                        U_l, data["Pt_ops"][i - 1], U_slices[i - 1])
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

        if not sharded:
            loss_fn = loss_fn_single

        def step(state: MGState, epoch, data):
            (total, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params, epoch, data)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            updates, plateau_state = plateau.update(
                updates, state.plateau_state, value=total)
            params = jax.tree_util.tree_map(
                lambda p, u: p + u, state.params, updates)
            return MGState(params, opt_state, plateau_state), metrics

        import contextlib

        from eigenpinns_tpu.utils.profiling import trace as profiler_trace

        prof = (profiler_trace(cfg.profile_dir) if cfg.profile_dir
                else contextlib.nullcontext())
        # Resume from the newest checkpoint when a checkpoint_dir is set.
        start_state = MGState(params, opt_state, plateau_state)
        ckptr = None
        epoch0 = 0
        if cfg.checkpoint_dir:
            from eigenpinns_tpu.train.checkpoint import TrainCheckpointer

            ckptr = TrainCheckpointer(cfg.checkpoint_dir)
            prev_step, prev = ckptr.restore_latest(target=start_state)
            if prev is not None:
                start_state = prev
                # Continue the epoch counter so the corrector-scale ramp
                # does not replay and the post-run checkpoint index stays
                # monotonically above the restored one.
                epoch0 = int(prev_step)
                if repl_sharding is not None:
                    # Checkpoints are mesh-shape independent (replicated
                    # pytrees); re-place the restored state on the mesh.
                    start_state = jax.device_put(start_state,
                                                 repl_sharding)

        chunk_cb = None
        if eval_callback is not None:
            off_f, n_f = offsets[-1], sizes[-1]

            # Everything large travels as jit ARGUMENTS (same rule as the
            # scan loop's `data`): closure capture would bake feats/U_base
            # and the finest M into a second multi-GB executable at 300k+.
            # Always evaluated on the canonical single-device arrays —
            # parameters are replicated in the sharded path, so the same
            # predict works for both loops.
            eval_data = {"feats": feats, "U_base": U_base, "graph": graph}

            @jax.jit
            def _predict_finest(params, data, M_f):
                corr = model.apply(params, data["feats"], data["graph"])
                U_f = (data["U_base"] + cfg.corrector_scale * corr)[
                    off_f:off_f + n_f]
                return m_normalize_columns(U_f, M_f)

            def chunk_cb(epochs_run, state):
                eval_callback(epochs_run,
                              _predict_finest(state.params, eval_data,
                                              h.M_ops[-1]))

        with prof:
            result: LoopResult = run_scan_loop(
                step, start_state,
                n_epochs=cfg.epochs, chunk=cfg.scan_chunk,
                early_stop_patience=cfg.early_stop_patience,
                log_every=cfg.log_every,
                log_fn=log_fn or (self._default_log if cfg.verbose
                                  else None),
                track_best=cfg.track_best,
                data=data,
                start_epoch=epoch0,
                chunk_callback=chunk_cb,
                timing_chunks=cfg.timing_chunks,
            )
        if ckptr is not None:
            ckptr.save(epoch0 + result.epochs_run, result.state)

        # Final predictions at full corrector scale
        # (src/multigrid_model.py:359-384); optionally from the best state.
        final_params = (result.best_state.params if cfg.track_best
                        else result.state.params)
        corr = model.apply(final_params, feats, graph)
        U_pred = U_base + cfg.corrector_scale * corr
        U_levels = []
        lam_levels = []
        for off, n, K, M in zip(offsets, sizes, h.K_ops, h.M_ops):
            U_l = m_normalize_columns(U_pred[off:off + n], M)
            U_levels.append(U_l)
            lam_levels.append(np.asarray(rayleigh_ritz(U_l, K, M)[0]))
        U_all = jnp.concatenate(U_levels, axis=0)

        # Finest-level extraction + Rayleigh-Ritz
        # (src/multigrid_model.py:452-475).
        U_finest = U_levels[-1]
        vals, U_ref = rayleigh_ritz_robust(
            U_finest, h.K_ops[-1], h.M_ops[-1])
        vals, U_ref = vals[:k], U_ref[:, :k]
        if cfg.polish_iters > 0:
            # Framework extension beyond the reference: a few LOBPCG
            # iterations warm-started from the learned subspace drive the
            # eigenpairs to solver-grade accuracy entirely on device.
            # Guard vectors pad the block: the edge mode of a LOBPCG block
            # converges far more slowly than interior modes.
            from eigenpinns_tpu.solvers.lobpcg import lobpcg

            g = int(cfg.polish_guard)
            X0 = U_ref
            if g > 0:
                extra = jax.random.normal(
                    jax.random.PRNGKey(cfg.seed + 7),
                    (U_ref.shape[0], g), U_ref.dtype)
                X0 = jnp.concatenate([U_ref, extra], axis=1)
            res = lobpcg(h.K_ops[-1], h.M_ops[-1], X0, k=k + g,
                         max_iter=cfg.polish_iters, tol=1e-7)
            vals, U_ref = res.eigenvalues[:k], res.eigenvectors[:, :k]
        vals = np.asarray(vals)
        U_ref = np.asarray(U_ref)

        return MultigridResult(
            eigenvalues=vals,
            eigenvectors=U_ref,
            U_all=np.asarray(U_all),
            history=result.history,
            epochs_run=result.epochs_run,
            wall_time=result.wall_time,
            level_eigenvalues=lam_levels,
            chunk_times=result.chunk_times,
            steady_steps_per_sec=result.steady_rate,
        )

    @staticmethod
    def _default_log(epoch, metrics):
        print(
            f"Epoch {epoch:5d}: Loss={metrics['loss']:.6f} | "
            f"Res={metrics['res']:.6f} | Orth={metrics['orth']:.6f} | "
            f"Proj={metrics['proj']:.6f} | Trace={metrics['trace']:.6f} | "
            f"Order={metrics['order']:.6f} | Eigen={metrics['eigen']:.6f} | "
            f"Scale={metrics['scale']:.4f}")
