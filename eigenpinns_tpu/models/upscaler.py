"""Hierarchical neural upscaler: coarse eigenvector -> fine eigenvector.

Capability parity with `HierarchicalUpscaler`
(downsampling_toy_example.ipynb cell 0:104-124): a per-eigenpair MLP
mapping the coarse-level eigenvector (n_coarse values) to the fine-level
one (n_fine values), with a trainable eigenvalue refined jointly. Used by
the matrix-only multigrid driver (`eigenpinns_tpu.solvers.upscale`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp

from eigenpinns_tpu.models.nn import Module


@dataclasses.dataclass(frozen=True)
class HierarchicalUpscaler(Module):
    """u_fine = base + MLP(u_coarse); lam = trainable, init from coarse.

    `base` (typically an interpolation prolongation of u_coarse) anchors
    the output: with a small-init MLP head the upscaler starts AT the
    interpolated guess instead of at noise, which prevents the
    collapse-to-zero failure mode once the (decaying) normalization weight
    fades — the instability visible in the reference notebook's rough
    results.
    """

    hidden: Sequence[int]
    n_fine: int
    lambda_init: float = 0.0

    def forward(self, scope, u_coarse, base=None):
        from eigenpinns_tpu.models.mlp import MLP

        h = jnp.reshape(u_coarse, (1, -1))
        u_fine = MLP(tuple(self.hidden), self.n_fine,
                     activation="tanh", small_output_init=True)(scope, h)[0]
        if base is not None:
            u_fine = base + u_fine
        lam = scope.param(
            "lam",
            lambda key, shape, dtype: jnp.full(shape, self.lambda_init, dtype),
            ())
        return u_fine, lam
