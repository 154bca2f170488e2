"""GNN correctors predicting per-node corrections for all k modes.

Capability parity with `src/corrector_model.py`:
  * SimpleCorrector — GraphSAGE-mean: agg = mean over in-neighbors,
    MLP(concat(x, agg))                       (src/corrector_model.py:9-31)
  * SpectralCorrector — one GCN step agg = A_norm @ x, MLP(concat)
    (src/corrector_model.py:39-82)
  * AdaptiveCorrector — learnable per-mode output scales (init 0.01),
    the refine_fixed notebook variant
    (multigrid_gnn_refine_fixed.ipynb cell 4:602-640)

Neighbor aggregation is a segment-sum (no scatter index_add_ loop) or an
ELL SpMM; both fuse into the MLP matmuls under jit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp

from eigenpinns_tpu.models.mlp import MLP
from eigenpinns_tpu.models.nn import Module
from eigenpinns_tpu.sparse import BandedELL, SparseELL, neighbor_mean, spmm
from eigenpinns_tpu.sparse.ops import FunctionOperator


@dataclasses.dataclass(frozen=True)
class SimpleCorrector(Module):
    """Neighbor-mean aggregation + MLP."""

    hidden: Sequence[int]
    out_dim: int
    dropout: float = 0.0
    compute_dtype: str | None = None  # e.g. 'bfloat16' matmuls; params
                                      # and outputs stay f32 (models/mlp.py)

    def forward(self, scope, x, graph, deterministic: bool = True):
        # graph: (2, E) edge_index OR a prebuilt mean-aggregation operator
        # (SparseELL / BandedELL from neighbor_mean_operator, or a
        # FunctionOperator wrapping a sharded SpMM) — operators keep both
        # the forward and the backward scatter-free.
        if isinstance(graph, (SparseELL, BandedELL, FunctionOperator)):
            agg = spmm(graph, x)
        else:
            agg = neighbor_mean(graph, x)
        h = jnp.concatenate([x, agg], axis=1)
        return MLP(self.hidden, self.out_dim, activation="relu",
                   dropout=self.dropout, small_output_init=True,
                   compute_dtype=self.compute_dtype)(
                       scope, h, deterministic=deterministic)


@dataclasses.dataclass(frozen=True)
class SpectralCorrector(Module):
    """One pre-normalized GCN aggregation (A_norm @ x) + MLP."""

    hidden: Sequence[int]
    out_dim: int
    dropout: float = 0.0
    compute_dtype: str | None = None

    def forward(self, scope, x, a_norm, deterministic: bool = True):
        agg = spmm(a_norm, x)
        h = jnp.concatenate([x, agg], axis=1)
        return MLP(self.hidden, self.out_dim, activation="relu",
                   dropout=self.dropout, small_output_init=True,
                   compute_dtype=self.compute_dtype)(
                       scope, h, deterministic=deterministic)


@dataclasses.dataclass(frozen=True)
class AdaptiveCorrector(Module):
    """SimpleCorrector + learnable per-mode output scales (init 0.01)."""

    hidden: Sequence[int]
    out_dim: int
    dropout: float = 0.0
    scale_init: float = 0.01
    compute_dtype: str | None = None

    def forward(self, scope, x, graph, deterministic: bool = True):
        corr = SimpleCorrector(self.hidden, self.out_dim, self.dropout,
                               self.compute_dtype)(
            scope, x, graph, deterministic=deterministic)
        scales = scope.param(
            "mode_scales",
            lambda key, shape, dtype: jnp.full(shape, self.scale_init,
                                               dtype),
            (self.out_dim,),
        )
        return corr * scales[None, :]


def make_corrector(model_type: str, hidden: Sequence[int], out_dim: int,
                   dropout: float = 0.0, compute_dtype: str | None = None):
    """Factory mirroring the reference's model_type switch
    (src/multigrid_model.py:203-216 + 'adaptive' notebook variant).
    `compute_dtype` casts the MLP matmuls (e.g. 'bfloat16'); parameters
    and outputs stay f32."""
    model_type = model_type.lower()
    if model_type == "simple":
        return SimpleCorrector(tuple(hidden), out_dim, dropout,
                               compute_dtype)
    if model_type == "spectral":
        return SpectralCorrector(tuple(hidden), out_dim, dropout,
                                 compute_dtype)
    if model_type == "adaptive":
        return AdaptiveCorrector(tuple(hidden), out_dim, dropout,
                                 compute_dtype=compute_dtype)
    raise ValueError(
        f"model_type must be 'simple', 'spectral' or 'adaptive', "
        f"got '{model_type}'")
