"""Direct joint eigen-learning: one network predicts all k eigenfunctions.

Capability parity with the reference's direct-training notebooks:
  * penalty mode — residual + Gram-penalty orthogonality
    (scripts/simplified_loss.ipynb cell 0: loss = ||KU - diag(ray) MU|| +
    mean+max of (U^T M U - I)^2);
  * whiten mode — differentiable M-orthonormalization (Newton-Schulz, the
    stable sibling of the SVD whitening whose unguarded run diverged,
    scripts/loss_with_rigid_body.ipynb) followed by trace/ordering/
    diversity/zero-lambda spectral-structure losses.

The whole epoch is one fused jit step (model forward on all N points,
SpMM, k x k Grams); epochs run in scan chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from eigenpinns_tpu.losses import (
    diversity,
    newton_schulz_orthonormalize,
    ordering,
    rayleigh_residual_orth,
    trace_loss,
    zero_lambda,
    zero_mean,
)
from eigenpinns_tpu.models import JointEigenNet
from eigenpinns_tpu.train.loop import run_scan_loop


class DirectState(NamedTuple):
    params: Any
    opt_state: Any


@dataclasses.dataclass
class DirectResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    history: dict
    epochs_run: int
    wall_time: float
    chunk_times: list
    steady_steps_per_sec: float | None = None  # timing_chunks probe


def train_joint(
    K,
    M,
    X,
    n_modes: int,
    hidden=(64, 64, 64),
    activation: str = "silu",
    mode: str = "penalty",           # 'penalty' | 'whiten'
    epochs: int = 5000,
    scan_chunk: int = 200,
    lr_start: float = 1e-2,
    lr_end: float = 1e-4,
    w_res: float = 1.0,
    w_orth: float = 1.0,
    w_trace: float = 0.0,
    w_order: float = 0.0,
    w_zero: float = 0.0,
    w_zero_mean: float = 0.0,
    w_diversity: float = 0.0,
    min_gap: float = 0.01,
    ns_iters: int = 6,
    seed: int = 0,
    rayleigh_ritz_finish: bool = True,
    batch_nodes: int = 0,
    loss_mxu_precision: str = "high",
    mlp_compute_dtype: str | None = None,
    log_fn=None,
    log_every: int = 0,
    timing_chunks: int = 0,
) -> DirectResult:
    """Learn all n_modes eigenfunctions of K u = lam M u jointly.

    `batch_nodes > 0` enables NODE-MINIBATCHED training (the capability of
    the adaptive deflation notebook, iterative_eigenvalues cell 13): each
    step evaluates the residual on a random row block (the block's ELL
    rows reference the full U, so the stencil stays exact) and estimates
    the Gram/Rayleigh denominators on the same block scaled by N/B — an
    unbiased MC estimate. This bounds per-step cost by B instead of N,
    which is what makes million-node direct training affordable.
    Only 'penalty' mode supports minibatching (whitening needs the exact
    global Gram).
    """
    if mode not in ("penalty", "whiten"):
        raise ValueError(f"mode must be 'penalty' or 'whiten', got '{mode}'")
    if batch_nodes and mode == "whiten":
        raise ValueError("batch_nodes requires mode='penalty'")

    X = jnp.asarray(X, dtype=jnp.float32)
    model = JointEigenNet(tuple(hidden), n_modes, activation=activation,
                          compute_dtype=mlp_compute_dtype)
    params = model.init(jax.random.PRNGKey(seed), X)
    schedule = optax.exponential_decay(lr_start, epochs,
                                       lr_end / lr_start)
    opt = optax.adam(schedule)
    opt_state = opt.init(params)

    from eigenpinns_tpu.sparse import Diagonal, SparseELL, hdot

    def _block_apply(A, rows, U):
        """(A U)[rows] using only the rows' stencils."""
        if isinstance(A, Diagonal):
            return A.diag[rows, None] * U[rows]
        if isinstance(A, SparseELL):
            gathered = U[A.indices[rows]]        # (B, W, k)
            return jnp.einsum(
                "bwk,bw->bk", gathered, A.values[rows],
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32).astype(U.dtype)
        raise TypeError("minibatching needs Diagonal/SparseELL operators")

    n_nodes = X.shape[0]

    # Loss SpMMs tolerate bf16x3; the Rayleigh-Ritz/rayleigh finish below
    # keeps the original ('highest') operators.
    K_l = (K.with_precision(loss_mxu_precision)
           if hasattr(K, "with_precision") else K)
    M_l = (M.with_precision(loss_mxu_precision)
           if hasattr(M, "with_precision") else M)

    # Operators and features travel as jit ARGUMENTS through the scan
    # loop — closure capture would bake the (possibly multi-GB) band
    # into the executable: 2x HBM and compile-payload blowup on the
    # device (see train/loop.py docstring). The 'highest' and
    # bf16x3 views share one band buffer.
    data = {"K": K_l, "M": M_l, "Kh": K, "Mh": M, "X": jnp.asarray(X)}

    def loss_fn(params, key, data):
        K_l, M_l = data["K"], data["M"]
        K_, M_, X = data["Kh"], data["Mh"], data["X"]
        U_raw = model.apply(params, X)
        if batch_nodes:
            U = U_raw
            rows = jax.random.randint(key, (batch_nodes,), 0, n_nodes)
            Ku_b = _block_apply(K_, rows, U)
            Mu_b = _block_apply(M_, rows, U)
            U_b = U[rows]
            lam = (jnp.sum(U_b * Ku_b, axis=0)
                   / (jnp.sum(U_b * Mu_b, axis=0) + 1e-12))
            res = jnp.mean((Ku_b - Mu_b * lam[None, :]) ** 2)
            scale = n_nodes / batch_nodes
            G = hdot(U_b.T, Mu_b) * scale       # MC Gram estimate
            orth = jnp.sum((G - jnp.eye(n_modes, dtype=U.dtype)) ** 2) \
                / n_modes
            total = w_res * res + w_orth * orth
            metrics = {"loss": total, "res": res, "orth": orth,
                       "lam_mean": jnp.mean(lam)}
            if w_trace:
                total = total + w_trace * trace_loss(lam)
                metrics["loss"] = total
            return total, metrics
        if mode == "whiten":
            U = newton_schulz_orthonormalize(U_raw, M_l, n_iters=ns_iters)
        else:
            U = U_raw
        lam, res, orth = rayleigh_residual_orth(U, K_l, M_l)
        total = w_res * res + w_orth * orth
        if w_trace:
            total = total + w_trace * trace_loss(lam)
        if w_order:
            total = total + w_order * ordering(lam)
        if w_zero:
            total = total + w_zero * zero_lambda(
                jnp.sort(lam))
        if w_zero_mean:
            total = total + w_zero_mean * zero_mean(U, M_l)
        if w_diversity:
            total = total + w_diversity * diversity(jnp.sort(lam), min_gap)
        metrics = {"loss": total, "res": res, "orth": orth,
                   "lam_mean": jnp.mean(lam)}
        return total, metrics

    def step(state: DirectState, epoch, data):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 13), epoch)
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, key, data)
        updates, opt_state = opt.update(grads, state.opt_state)
        params = optax.apply_updates(state.params, updates)
        return DirectState(params, opt_state), metrics

    result = run_scan_loop(step, DirectState(params, opt_state),
                           n_epochs=epochs, chunk=scan_chunk,
                           log_every=log_every, log_fn=log_fn, data=data,
                           timing_chunks=timing_chunks)

    U = model.apply(result.state.params, X)
    if mode == "whiten":
        U = newton_schulz_orthonormalize(U, M, n_iters=ns_iters)
    if rayleigh_ritz_finish:
        from eigenpinns_tpu.solvers.rayleigh_ritz import rayleigh_ritz_robust

        lam, U = rayleigh_ritz_robust(U, K, M)
        lam, U = lam[:n_modes], U[:, :n_modes]
    else:
        from eigenpinns_tpu.sparse import rayleigh_quotients

        lam = rayleigh_quotients(U, K, M)
    return DirectResult(
        eigenvalues=np.asarray(lam),
        eigenvectors=np.asarray(U),
        history=result.history,
        epochs_run=result.epochs_run,
        wall_time=result.wall_time,
        chunk_times=result.chunk_times,
        steady_steps_per_sec=result.steady_rate,
    )
