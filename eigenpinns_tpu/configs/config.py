"""Config system: sectioned YAML -> one flat dataclass.

Parity with the reference's `PINNConfig` (src/config.py:5-50): the YAML is
organized in sections (config / sampler / utils / correctorGNN /
multigridGNN / runner) whose keys are merged into a single flat namespace.
Extends the reference's 30 parameters with framework knobs (dtype,
device mesh shape, coarse solver choice) — all defaulted so reference
YAML files load unchanged. PyYAML is needed only by `from_yaml`.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Config:
    # --- config section (src/parameters.yml:1-7) ---
    mesh_file: str = "./resources/bunny.obj"
    coarse_mesh_files: list = dataclasses.field(default_factory=list)
    diagnostics_viz: str = "./outputs/diagnostics.png"
    vtu_file: str = "./outputs/bunny_model.vtu"
    verbose: bool = False
    do_extensive_visuals: bool = False

    # --- sampler section (:9-11) ---
    sampler_type: str = "farthest_point"
    edge_computation_type: str = "knn_based"

    # --- utils section (:13-16) ---
    normalization_eps: float = 1e-9
    prolongation_neighbors: int = 21
    knn_graph_neighbors: int = 21

    # --- correctorGNN section (:18-22) ---
    model_type: str = "simple"
    hidden_layers: list = dataclasses.field(
        default_factory=lambda: [256] * 6)
    dropout: float = 0.0

    # --- multigridGNN section (:24-36) ---
    epochs: int = 10000
    learning_rate: float = 1e-3
    corrector_scale: float = 10.0
    weight_residual: float = 1000.0
    weight_orthogonal: float = 10.0
    weight_projection: float = 0.0
    weight_trace: float = 0.0
    w_order: float = 0.0
    w_eigen: float = 0.0
    gradient_clipping: float = 10.0
    weight_decay: float = 1e-5
    log_every: int = 1000

    # --- runner section (:38-40) ---
    n_modes: int = 64
    hierarchy: list = dataclasses.field(
        default_factory=lambda: [256, 512, 1024])
    k_neighbors: int = 21

    # --- framework extensions (not in the reference) ---
    dtype: str = "float32"
    coarse_solver: str = "eigsh"          # 'eigsh' (host) | 'lobpcg' (device)
    operator_format: str = "ell"           # 'ell' | 'banded' | 'auto'
    pc_neighbors: int = 30                 # point-cloud Laplacian kNN
    scan_chunk: int = 100                  # epochs fused per jitted scan
    timing_chunks: int = 0                 # post-training chained-dispatch
                                           # throughput probe (see
                                           # train/loop.py run_scan_loop)
    early_stop_patience: int = 5000        # src/multigrid_model.py:234
    scale_ramp_epochs: int = 5000          # adaptive corr ramp (:243)
    plateau_patience: int = 2000           # ReduceLROnPlateau (:221-223)
    plateau_factor: float = 0.5
    seed: int = 0
    polish_iters: int = 0   # post-training LOBPCG polish (0 = reference parity)
    polish_guard: int = 3   # extra guard vectors in the polish block (the
                            # edge mode of a LOBPCG block converges poorly)
    normalize_in_loss: bool = False  # per-level M-normalize inside the loss
                                     # (the voxel notebook's 'critical fix',
                                     # cell 0:440-447)
    w_zero_mean: float = 0.0         # (1^T M u_j)^2 for j>=1 (cell 0:459-468)
    track_best: bool = False         # best-state restore (refine_fixed)
    checkpoint_dir: str = ""
    mesh_shape: list = dataclasses.field(default_factory=list)  # device mesh
    profile_dir: str = ""
    corrector_compute_dtype: str = ""  # '' = f32; 'bfloat16' runs the
                                       # corrector MLP matmuls in bf16
                                       # (params/outputs stay f32) — the
                                       # MLP dominates small-N step FLOPs
    fuse_level_ops: bool | None = None  # multigrid loss: ONE block-diagonal
                                 # SpMM over all levels instead of per-level
                                 # dispatches. None = auto: fused on the
                                 # single-device path, per-level on the
                                 # sharded path (which has no fused kernel —
                                 # its per-level halo layouts are the
                                 # fusion). Explicit True on a sharded run
                                 # warns loudly; falls back per-level when
                                 # the fused operator cannot be built.
    loss_mxu_precision: str = "high"  # operator products INSIDE the loss
                                      # (sparse.ops.operator_dot):
                                      # 'high' = Precision.HIGH (TF32 on
                                      # the H100, ~1e-3 rel err),
                                      # 'highest' = f32, 'bf16' = operator
                                      # STORED bf16 (half the bytes,
                                      # ~1e-3 operator rounding — pair
                                      # with polish). Rayleigh-Ritz /
                                      # LOBPCG polish always run 'highest'.

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        """Load a sectioned YAML, merging every section flat
        (src/config.py:41-50)."""
        import yaml

        with open(path, "r") as fh:
            raw = yaml.safe_load(fh) or {}
        merged: dict[str, Any] = {}
        for section in raw.values():
            if isinstance(section, dict):
                merged.update(section)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(merged) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**merged)

    def override(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
