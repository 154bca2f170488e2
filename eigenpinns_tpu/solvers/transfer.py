"""Per-level transfer-learning eigen refinement.

Capability parity with the mesh_downsampling / transfer_learning /
iterative_downsampling notebook family (SURVEY.md sec 2.2 row 5):
level-by-level training (vs the joint multigrid trainer) with

  * ONE shared corrector reused across levels (weights carry over),
  * per-level LR decay lr * decay^level,
  * layer FREEZING at finer levels (freeze the first f hidden layers,
    schedule e.g. {1: 0, 2: 1, 3: 1, 4: 2}),
  * the projection loss ||P^T U_f - U_c||^2 anchoring each level to the
    one below,
  * per-level checkpointing (level_<l> checkpoints via orbax).

Freezing is optax.multi_transform masking — frozen layers get zero
updates, so the jitted step stays a single fused program per level.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import numpy as np
import optax

from eigenpinns_tpu.losses import (
    projection,
    rayleigh_residual_orth,
)
from eigenpinns_tpu.models import SimpleCorrector
from eigenpinns_tpu.sparse import m_normalize_columns, neighbor_mean_operator
from eigenpinns_tpu.solvers.multigrid import _level_features
from eigenpinns_tpu.solvers.rayleigh_ritz import (
    rayleigh_ritz,
    rayleigh_ritz_robust,
)
from eigenpinns_tpu.train.loop import run_scan_loop


class TLState(NamedTuple):
    params: Any
    opt_state: Any


@dataclasses.dataclass
class TransferResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    level_eigenvalues: list
    histories: list


def _freeze_mask(params, n_frozen: int):
    """Label pytree: 'frozen' for the first n hidden Dense layers."""
    def label(path, _):
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        for nm in names:
            if isinstance(nm, str) and nm.startswith("hidden_"):
                idx = int(nm.split("_")[1])
                return "frozen" if idx < n_frozen else "train"
        return "train"

    return jax.tree_util.tree_map_with_path(label, params)


def train_per_level(
    h,                      # Hierarchy
    n_modes: int,
    hidden=(64, 64, 64),
    epochs_per_level: int = 1500,
    scan_chunk: int = 250,
    lr: float = 1e-3,
    lr_level_decay: float = 0.7,
    corrector_scale: float = 1.0,
    w_res: float = 100.0,
    w_orth: float = 10.0,
    w_proj: float = 1.0,
    freeze_schedule: dict | None = None,
    checkpoint_dir: str = "",
    seed: int = 0,
) -> TransferResult:
    """Refine eigenvectors level-by-level with a shared corrector."""
    freeze_schedule = freeze_schedule or {}
    model = SimpleCorrector(tuple(hidden), n_modes)

    params = None
    U_prev = h.U_list[0]
    lam_prev, _ = rayleigh_ritz(U_prev, h.K_ops[0], h.M_ops[0])
    level_lams = [np.asarray(lam_prev)]
    histories = []

    for level in range(1, h.n_levels):
        K, M = h.K_ops[level], h.M_ops[level]
        Pt = h.Pt_ops[level - 1]
        U_init = m_normalize_columns(h.U_list[level], M)
        U_coarse = m_normalize_columns(U_prev, h.M_ops[level - 1])
        feats = _level_features(
            h.X_list[level], U_init, lam_prev, h.edge_index_list[level],
            K, M, level, h.n_levels)
        edges = neighbor_mean_operator(h.edge_index_list[level],
                                        h.actual_hierarchy[level])

        if params is None:
            params = model.init(jax.random.PRNGKey(seed), feats, edges)
        # (in_dim is level-independent here: the feature builder emits
        # 8 + k features at every level, so the shared weights transfer
        # without the notebooks' partial-copy surgery.)

        n_frozen = int(freeze_schedule.get(level, 0))
        level_lr = lr * (lr_level_decay ** level)
        base_opt = optax.adam(level_lr)
        if n_frozen > 0:
            opt = optax.multi_transform(
                {"train": base_opt, "frozen": optax.set_to_zero()},
                _freeze_mask(params, n_frozen))
        else:
            opt = base_opt
        opt_state = opt.init(params)

        def loss_fn(params):
            corr = model.apply(params, feats, edges)
            U_pred = U_init + corrector_scale * corr
            lam, res, orth = rayleigh_residual_orth(U_pred, K, M)
            proj = projection(U_pred, Pt, U_coarse)
            total = w_res * res + w_orth * orth + w_proj * proj
            return total, {"loss": total, "res": res, "orth": orth,
                           "proj": proj}

        def step(state: TLState, epoch):
            (_, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = optax.apply_updates(state.params, updates)
            return TLState(params, opt_state), metrics

        result = run_scan_loop(step, TLState(params, opt_state),
                               n_epochs=epochs_per_level, chunk=scan_chunk)
        params = result.state.params
        histories.append(result.history)

        corr = model.apply(params, feats, edges)
        U_pred = m_normalize_columns(U_init + corrector_scale * corr, M)
        lam_prev, U_prev = rayleigh_ritz(U_pred, K, M)
        level_lams.append(np.asarray(lam_prev))

        if checkpoint_dir:
            from eigenpinns_tpu.train.checkpoint import save_checkpoint

            save_checkpoint(
                f"{checkpoint_dir}/level_{level}",
                {"params": params,
                 "lambda_refined": np.asarray(lam_prev)})

    vals, U = rayleigh_ritz_robust(U_prev, h.K_ops[-1], h.M_ops[-1])
    return TransferResult(
        eigenvalues=np.asarray(vals[:n_modes]),
        eigenvectors=np.asarray(U[:, :n_modes]),
        level_eigenvalues=level_lams,
        histories=histories,
    )
