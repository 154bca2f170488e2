"""Boundary-enforcing parametric ansatz f(x, lambda) = f_b + g(x) * NN(x, lambda).

The quantumNN-style formulation summarized in the reference README
(README.md:9-22) and named as the BASELINE.json north-star capability: the
trial function satisfies Dirichlet boundary conditions EXACTLY by
construction — g(x) vanishes on the boundary, f_b carries the boundary
values — so no boundary penalty term is needed. lambda is an input to the
network, enabling a single net to represent the whole eigen-family and
enabling deflation sweeps over lambda.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax.numpy as jnp

from eigenpinns_tpu.models.nn import Module


def dirichlet_window(a: float, b: float) -> Callable:
    """g(x) = (x - a)(b - x), zero at both ends of [a, b] (the 1D
    infinite-well Dirichlet trick)."""
    def g(x):
        return (x - a) * (b - x)
    return g


def gaussian_window(scale: float = 1.0) -> Callable:
    """g(x) = exp(-x^2 / (2 scale^2)) — decaying envelope for problems on
    the whole line (harmonic oscillator)."""
    def g(x):
        return jnp.exp(-0.5 * jnp.sum(x * x, axis=-1, keepdims=True)
                       / scale**2)
    return g


@dataclasses.dataclass(frozen=True)
class ParametricAnsatz(Module):
    """f(x, lambda) = f_b(x) + g(x) * NN([x, lambda]).

    `window` is g(x); `boundary` is f_b(x) (defaults to zero).
    x: (N, d); lam: scalar or (n_lam,). Output: (N, n_lam) — the shared
    parametric family evaluated at each lambda. All lambdas are evaluated
    in ONE batched net call (lambda tiled into the batch axis), so the
    device sees a single (N * n_lam, d+1) matmul instead of n_lam small ones.
    """

    hidden: Sequence[int]
    window: Callable
    boundary: Callable | None = None
    activation: str = "tanh"

    def forward(self, scope, x, lam):
        from eigenpinns_tpu.models.mlp import MLP

        lam = jnp.atleast_1d(jnp.asarray(lam, dtype=x.dtype))
        n, d = x.shape
        n_lam = lam.shape[0]
        x_tiled = jnp.broadcast_to(x[None], (n_lam, n, d))
        lam_tiled = jnp.broadcast_to(lam[:, None, None], (n_lam, n, 1))
        feats = jnp.concatenate([x_tiled, lam_tiled], axis=2)
        net = MLP(tuple(self.hidden), 1, activation=self.activation)
        vals = net(scope, feats.reshape(n_lam * n, d + 1)).reshape(
            n_lam, n).T
        g = jnp.reshape(self.window(x), (n, 1))
        out = g * vals
        if self.boundary is not None:
            out = out + jnp.reshape(self.boundary(x), (n, 1))
        return out
