"""Eigenfunction networks: joint-k nets and lambda-conditioned nets.

Covers the reference's two direct-learning model families:
  * JointEigenNet — MLP(x) -> (N, k): all k eigenfunctions at once
    (scripts/simplified_loss.ipynb cell 0:90-104, 3x64 SiLU, k=128);
  * LambdaEigenNet — one eigenfunction with a LEARNABLE eigenvalue that is
    broadcast and concatenated into EVERY hidden layer (the f(x, lambda)
    parametric-input trick of the iterative deflation PINN,
    iterative_eigenvalues_on_cloud.ipynb cell 1:20-67: bias-free 1x1
    linear on a constant input, abs() to keep lambda >= 0, Sin act).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp

from eigenpinns_tpu.models.nn import Module, dense


@dataclasses.dataclass(frozen=True)
class JointEigenNet(Module):
    """MLP mapping coordinates to k eigenfunction values."""

    hidden: Sequence[int]
    n_modes: int
    activation: str = "silu"
    compute_dtype: str | None = None  # see MLP.compute_dtype

    def forward(self, scope, x):
        from eigenpinns_tpu.models.mlp import MLP

        return MLP(tuple(self.hidden), self.n_modes,
                   activation=self.activation,
                   compute_dtype=self.compute_dtype)(scope, x)


@dataclasses.dataclass(frozen=True)
class LambdaEigenNet(Module):
    """Single eigenfunction u(x) with learnable eigenvalue lambda.

    Returns (u: (N, 1), lam: scalar). lambda enters every layer so the
    network represents the parametric family f(x, lambda) — warm-started
    deflation can reuse weights for the next mode.
    """

    hidden: Sequence[int]
    lambda_init: float = 0.1
    activation: str = "sin"

    def forward(self, scope, x):
        from eigenpinns_tpu.models.mlp import ACTIVATIONS

        act = ACTIVATIONS[self.activation]
        # |w| on a constant input == learnable nonnegative eigenvalue
        # (cell 1:29-35 of the deflation notebook, reimagined as a param).
        raw = scope.param(
            "lambda_raw",
            lambda key, shape, dtype: jnp.full(shape, self.lambda_init, dtype),
            (1,))
        lam = jnp.abs(raw)[0]
        n = x.shape[0]
        lam_col = jnp.full((n, 1), 1.0) * lam
        h = jnp.concatenate([x, lam_col], axis=1)
        for i, width in enumerate(self.hidden):
            h = dense(scope, h, width, name=f"hidden_{i}")
            h = act(h)
            h = jnp.concatenate([h, lam_col], axis=1)
        u = dense(scope, h, 1, name="out")
        return u, lam
