"""Schrodinger eigenpair solver with the parametric boundary ansatz.

BASELINE.json config 2: 1D infinite well and harmonic oscillator solved
with f(x, lambda) = g(x) * NN(x, lambda) (exact Dirichlet/decay via the
window g), a LEARNABLE eigenvalue, Monte-Carlo normalization over fresh
collocation batches each step, and sequential deflation against the
already-found modes on a fixed quadrature grid. Residuals are autodiff
second derivatives (operators/schrodinger.py) — no assembled matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from eigenpinns_tpu.models.mlp import MLP
from eigenpinns_tpu.models.nn import Module
from eigenpinns_tpu.operators.schrodinger import (
    mc_inner,
    mc_norm_sq,
    schrodinger_residual,
)
from eigenpinns_tpu.train.loop import run_scan_loop


@dataclasses.dataclass(frozen=True)
class SchrodingerMode(Module):
    """u(x) = g(x) * NN([x, lambda]) with trainable lambda >= 0."""

    hidden: Sequence[int]
    window: Callable
    lambda_init: float = 1.0
    activation: str = "tanh"

    def forward(self, scope, x):
        raw = scope.param(
            "lambda_raw",
            lambda key, shape, dtype: jnp.full(shape, self.lambda_init, dtype),
            (1,))
        lam = jnp.abs(raw)[0]
        n = x.shape[0]
        feats = jnp.concatenate(
            [x, jnp.full((n, 1), 1.0, dtype=x.dtype) * lam], axis=1)
        vals = MLP(tuple(self.hidden), 1, activation=self.activation)(
            scope, feats)
        g = jnp.reshape(self.window(x), (n, 1))
        return (g * vals)[:, 0], lam


class SchrState(NamedTuple):
    params: Any
    opt_state: Any


@dataclasses.dataclass
class SchrodingerResult:
    eigenvalues: np.ndarray
    mode_params: list            # per-mode trained params
    histories: list
    model: Any                   # the module (shared architecture)

    def eval_mode(self, i: int, x):
        u, _ = self.model.apply(self.mode_params[i], jnp.asarray(x))
        return np.asarray(u)


def solve_schrodinger(
    potential: Callable,
    window: Callable,
    domain,                        # (a, b) for 1D, or [(a1,b1), ...] for ND
    n_modes: int,
    hidden=(64, 64),
    epochs_per_mode: int = 3000,
    scan_chunk: int = 250,
    batch_size: int = 256,
    quad_points: int = 512,
    lr: float = 2e-3,
    w_res: float = 1.0,
    w_norm: float = 100.0,
    w_defl: float = 1000.0,
    w_anchor: float = 1.0,
    lambda_init: float = 1.0,
    lambda_growth: float = 1.6,
    seed: int = 0,
    log_fn=None,
    log_every: int = 0,
) -> SchrodingerResult:
    """Find the lowest n_modes eigenpairs of -1/2 Lap u + V u = lam u.

    1D domains get a regular quadrature grid; ND boxes use a fixed
    uniform Monte-Carlo quadrature set (the normalization/deflation
    integrals are MC either way).
    """
    dom = np.asarray(domain, dtype=np.float64)
    if dom.ndim == 1:
        dom = dom.reshape(1, 2)
    d = dom.shape[0]
    lo, hi = dom[:, 0], dom[:, 1]
    volume = float(np.prod(hi - lo))
    if d == 1:
        x_quad = jnp.linspace(lo[0], hi[0], quad_points,
                              dtype=jnp.float32).reshape(-1, 1)
    else:
        qr = np.random.default_rng(seed + 999)
        x_quad = jnp.asarray(
            lo + (hi - lo) * qr.uniform(size=(quad_points, d)),
            jnp.float32)

    model = SchrodingerMode(tuple(hidden), window)
    mode_params: list = []
    eigenvalues: list[float] = []
    histories = []
    prev_quad = jnp.zeros((quad_points, 0), jnp.float32)

    lam0 = lambda_init
    for m in range(n_modes):
        mode_model = SchrodingerMode(tuple(hidden), window,
                                     lambda_init=lam0)
        params = mode_model.init(jax.random.PRNGKey(seed + 31 * m),
                                 x_quad[:4])
        opt = optax.adam(lr)
        opt_state = opt.init(params)
        U_prev = prev_quad  # (Q, m) values of found modes on the grid
        have_prev = U_prev.shape[1] > 0

        def loss_fn(params, key):
            x = jnp.asarray(lo, jnp.float32) + jnp.asarray(
                hi - lo, jnp.float32) * jax.random.uniform(
                key, (batch_size, d), dtype=jnp.float32)

            def u_fn(xx):
                return mode_model.apply(params, xx)[0]

            _, lam = mode_model.apply(params, x[:1])
            r = schrodinger_residual(u_fn, potential, lam, x)
            loss = w_res * jnp.mean(r * r)
            u_q = u_fn(x_quad)
            norm = (mc_norm_sq(u_q, volume) - 1.0) ** 2
            loss = loss + w_norm * norm
            if have_prev:
                inner = jax.vmap(
                    lambda uj: mc_inner(u_q, uj, volume),
                    in_axes=1)(U_prev)
                loss = loss + w_defl * jnp.sum(inner**2)
            if w_anchor > 0:
                # Anchor the learnable lambda to the Rayleigh quotient of
                # the CURRENT function: lam_R = <1/2 u'^2 + V u^2>/<u^2>.
                # Without it lambda can park at its warm start while the
                # residual finds a nearby stationary point (the failure
                # recorded in the reference's own deflation runs).
                def u_scalar(xi):
                    return u_fn(xi.reshape(1, -1))[0]

                def grad_sq(xi):
                    g = jax.grad(u_scalar)(xi)
                    return jnp.sum(g * g)

                gsq = jax.vmap(grad_sq)(x_quad)
                num = (0.5 * jnp.mean(gsq)
                       + jnp.mean(potential(x_quad) * u_q * u_q))
                lam_R = num / (jnp.mean(u_q * u_q) + 1e-12)
                loss = loss + w_anchor * (
                    lam - jax.lax.stop_gradient(lam_R)) ** 2
            return loss, {"loss": loss, "lam": lam, "norm": norm}

        def step(state: SchrState, epoch):
            key = jax.random.fold_in(jax.random.PRNGKey(seed + 7 * m),
                                     epoch)
            (_, metrics), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params, key)
            updates, opt_state = opt.update(grads, state.opt_state)
            params = optax.apply_updates(state.params, updates)
            return SchrState(params, opt_state), metrics

        # Full-f32 matmuls: the residual is a SECOND derivative of the
        # network — with default-precision matmul rounding (TF32 or bf16) the
        # jvp-of-jvp chain is noise-floored and lambda stalls short of the
        # true eigenvalue (observed: well mode 2 at 17.6 vs 19.74).
        with jax.default_matmul_precision("highest"):
            result = run_scan_loop(step, SchrState(params, opt_state),
                                   n_epochs=epochs_per_mode,
                                   chunk=scan_chunk,
                                   log_every=log_every, log_fn=log_fn)
        params = result.state.params
        u_q, lam = mode_model.apply(params, x_quad)
        # Normalize on the quadrature grid and store for deflation.
        scale = jnp.sqrt(mc_norm_sq(u_q, volume) + 1e-12)
        prev_quad = jnp.concatenate(
            [prev_quad, (u_q / scale)[:, None]], axis=1)
        mode_params.append(params)
        eigenvalues.append(float(lam))
        histories.append(result.history)
        lam0 = float(lam) * lambda_growth + 0.5

    return SchrodingerResult(
        eigenvalues=np.asarray(eigenvalues),
        mode_params=mode_params,
        histories=histories,
        model=model,
    )
