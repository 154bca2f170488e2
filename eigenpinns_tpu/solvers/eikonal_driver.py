"""Delta-PINN eikonal solver: geodesic distance from spectral encodings.

Capability parity with the Laplace-PINN-coil application
(Laplace-PINN-coil.ipynb cells 1-36): a PINN maps each vertex's
Laplace-Beltrami eigenfunction coordinates (the Delta-PINN positional
encoding) to a scalar field u solving the surface eikonal equation
|grad_S u| = 1, supervised by a handful of known geodesic distances:

    loss = MSE(u(x_d), y_d)                     [n_data random vertices]
         + MSE(sqrt(u_e^T Bs_e u_e) - 1, 0)     [random element batches]

Ground truth comes from the framework's own heat-method geodesics
(geometry/geodesics.py) instead of the reference's igl.exact_geodesic.
Per-step batches are drawn inside the jitted scan step via fold_in keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from eigenpinns_tpu.models.mlp import MLP
from eigenpinns_tpu.operators.eikonal import (
    eikonal_residual,
    gradient_norm_operator,
)
from eigenpinns_tpu.train.loop import run_scan_loop


class EikState(NamedTuple):
    params: Any
    opt_state: Any
    w_u: jax.Array     # NTK weight of the data term (1.0 when disabled)
    w_r: jax.Array     # NTK weight of the residual term


@dataclasses.dataclass
class EikonalResult:
    u: np.ndarray                # predicted distance field at all vertices
    history: dict
    data_mse: float
    residual_rms: float


def solve_eikonal(
    mesh,
    encodings: np.ndarray,       # (V, n_eigs) spectral coordinates
    y_data: np.ndarray,          # (V,) ground-truth distances
    n_data: int = 50,
    hidden: Sequence[int] = (100,),
    epochs: int = 20000,
    scan_chunk: int = 500,
    element_batch: int = 512,
    lr: float = 1e-3,
    lr_decay_steps: int = 20000,
    ntk_weights: bool = False,
    ntk_every: int = 1000,
    ntk_batch: int = 128,
    seed: int = 0,
    log_fn=None,
    log_every: int = 0,
) -> EikonalResult:
    """Train the eikonal PINN; returns the full predicted field.

    ``ntk_weights=True`` enables NTK-based adaptive loss balancing —
    the jaxpinns feature the reference's driver exposes (and disables)
    at Laplace-PINN-coil.ipynb cell 23 (``ntk_weights=False``). Every
    ``ntk_every`` epochs the diagonal NTK trace of each loss term is
    estimated from per-example parameter gradients (tr K_uu over the
    supervised nodes, tr K_rr over ``ntk_batch`` random elements) and
    the terms are reweighted w_k = (tr K_uu + tr K_rr) / tr K_k
    (Wang, Yu & Perdikaris, "When and why PINNs fail to train: an NTK
    perspective"), equalizing the terms' gradient-flow rates. The
    update runs inside the scan step under `lax.cond`, so fusion is
    preserved.
    """
    enc = jnp.asarray(encodings, jnp.float32)
    faces = jnp.asarray(np.asarray(mesh.faces, np.int32))
    Bs = jnp.asarray(gradient_norm_operator(mesh.verts, mesh.faces),
                     jnp.float32)
    n_faces = faces.shape[0]
    n_verts = enc.shape[0]

    # Fixed supervised subset (the notebook's 50 random nodes, cell 7:88).
    rng = np.random.default_rng(seed)
    data_idx = jnp.asarray(rng.choice(n_verts, size=min(n_data, n_verts),
                                      replace=False))
    # Normalize targets like the notebook (sigma/mu scaling, cell 7:47).
    y_mu, y_sigma = float(np.mean(y_data)), float(np.std(y_data) + 1e-12)
    y = jnp.asarray((y_data - y_mu) / y_sigma, jnp.float32)

    model = MLP(tuple(hidden), 1, activation="tanh")
    params = model.init(jax.random.PRNGKey(seed), enc[:4])
    schedule = optax.exponential_decay(lr, lr_decay_steps, 0.1)
    opt = optax.adam(schedule)
    opt_state = opt.init(params)

    def u_full(params):
        return model.apply(params, enc)[:, 0]

    def loss_fn(params, key, w_u, w_r):
        u = u_full(params)
        loss_u = jnp.mean((u[data_idx] - y[data_idx]) ** 2)
        e_idx = jax.random.randint(key, (element_batch,), 0, n_faces)
        # Residual on the PHYSICAL field u * sigma (cell 7:47-53).
        r = eikonal_residual(u * y_sigma + y_mu, Bs[e_idx], faces[e_idx])
        loss_r = jnp.mean(r**2)
        total = w_u * loss_u + w_r * loss_r
        return total, {"loss": total, "data": loss_u, "res": loss_r}

    def ntk_traces(params, key):
        """Diagonal NTK traces of the two loss terms, in the MEAN
        convention: both losses are means over their batches, so each
        trace is the batch-mean of squared per-example parameter
        gradients (sum-convention traces would leave a residual
        n_data/element_batch imbalance in the balanced gradient-flow
        rates)."""

        def sq_sum(tree):
            return sum(jnp.sum(g**2)
                       for g in jax.tree_util.tree_leaves(tree))

        def u_i(p, x):
            return model.apply(p, x[None])[0, 0]

        g_u = jax.vmap(jax.grad(u_i), in_axes=(None, 0))(
            params, enc[data_idx])
        tr_u = sq_sum(g_u) / data_idx.shape[0]

        e_idx = jax.random.randint(key, (ntk_batch,), 0, n_faces)

        def r_e(p, f, B):
            # Bs annihilates constants (it is a surface-gradient
            # quadratic form), so the y_mu shift drops out.
            u_e = model.apply(p, enc[f])[:, 0] * y_sigma
            quad = jnp.einsum("ij,i,j->", B, u_e, u_e)
            return jnp.sqrt(jnp.clip(quad, 1e-12)) - 1.0

        g_r = jax.vmap(jax.grad(r_e), in_axes=(None, 0, 0))(
            params, faces[e_idx], Bs[e_idx])
        # ntk_batch is a COST knob: the ntk_batch-sample mean estimates
        # the batch-mean trace of the element_batch-face batch the
        # residual loss actually trains on; in the mean convention the
        # element_batch factor cancels, so shrinking ntk_batch only adds
        # estimator variance, never bias.
        tr_r = sq_sum(g_r) / ntk_batch
        return tr_u, tr_r

    def step(state: EikState, epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), epoch)
        k_batch, k_ntk = jax.random.split(key)
        w_u, w_r = state.w_u, state.w_r
        if ntk_weights:
            def update_w(_):
                tr_u, tr_r = ntk_traces(state.params, k_ntk)
                tot = tr_u + tr_r
                return tot / (tr_u + 1e-12), tot / (tr_r + 1e-12)

            w_u, w_r = jax.lax.cond(
                epoch % ntk_every == 0, update_w,
                lambda _: (w_u, w_r), None)
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, k_batch, w_u, w_r)
        updates, opt_state = opt.update(grads, state.opt_state)
        params = optax.apply_updates(state.params, updates)
        metrics["w_u"] = w_u
        metrics["w_r"] = w_r
        return EikState(params, opt_state, w_u, w_r), metrics

    one = jnp.asarray(1.0, jnp.float32)
    result = run_scan_loop(step, EikState(params, opt_state, one, one),
                           n_epochs=epochs, chunk=scan_chunk,
                           log_every=log_every, log_fn=log_fn)

    u = np.asarray(u_full(result.state.params)) * y_sigma + y_mu
    r = np.asarray(eikonal_residual(jnp.asarray(u), Bs, faces))
    data_mse = float(np.mean((u - y_data) ** 2))
    return EikonalResult(
        u=u,
        history=result.history,
        data_mse=data_mse,
        residual_rms=float(np.sqrt(np.mean(r**2))),
    )
