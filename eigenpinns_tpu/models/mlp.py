"""MLP building blocks.

Activations cover the reference model zoo: ReLU correctors
(src/corrector_model.py), SiLU joint eigen-nets
(scripts/simplified_loss.ipynb cell 0:90-104) and Sin-activated
lambda-conditioned nets (iterative_eigenvalues_on_cloud.ipynb cell 1:20-67).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from eigenpinns_tpu.models.nn import Module, dense, dropout, lecun_normal

ACTIVATIONS: dict[str, Callable] = {
    "relu": jax.nn.relu,
    "silu": jax.nn.silu,
    "gelu": jax.nn.gelu,
    "tanh": jnp.tanh,
    "sin": jnp.sin,
}


def small_init(std: float = 0.01):
    """N(0, std^2) kernel init — the reference's "escape the do-nothing
    minimum" output-layer init (src/multigrid_model.py:211-214)."""
    def init(key, shape, dtype=jnp.float32):
        return std * jax.random.normal(key, shape, dtype)
    return init


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    """Plain MLP: hidden layers + linear head.

    `small_output_init` reproduces the reference's small-std output-layer
    initialization; `dropout` matches the correctorGNN config knob
    (src/parameters.yml:22).
    """

    hidden: Sequence[int]
    out_dim: int
    activation: str = "relu"
    dropout: float = 0.0
    small_output_init: bool = False
    first_layer_omega: float = 1.0  # SIREN-style input scaling for sin nets
    # Matmul/activation compute dtype (params stay f32). 'bfloat16' runs
    # the hidden layers on the bf16 tensor cores; the f32 output head is
    # restored by the final cast.
    compute_dtype: str | None = None

    def forward(self, scope, x, deterministic: bool = True):
        act = ACTIVATIONS[self.activation]
        dt = jnp.dtype(self.compute_dtype) if self.compute_dtype else None
        in_dtype = x.dtype
        if dt is not None:
            x = x.astype(dt)
        for i, h in enumerate(self.hidden):
            x = dense(scope, x, h, name=f"hidden_{i}", dtype=dt)
            x = act(self.first_layer_omega * x) if (
                i == 0 and self.activation == "sin") else act(x)
            x = dropout(scope, x, self.dropout, deterministic)
        kernel_init = (small_init() if self.small_output_init
                       else lecun_normal())
        out = dense(scope, x, self.out_dim, name="out",
                    kernel_init=kernel_init, dtype=dt)
        return out.astype(in_dtype)
