"""300k-point cloud, 20 modes, banded device operators (stretch config).

    python examples/large_scale_cloud.py

Set EIGENPINNS_SMOKE=1 to run a seconds-scale miniature (CI smoke mode).
"""
import os

import numpy as np

SMOKE = bool(int(os.environ.get("EIGENPINNS_SMOKE", "0")))

from eigenpinns_tpu.configs import Config
from eigenpinns_tpu.geometry import TriMesh
from eigenpinns_tpu.sampling import build_hierarchy
from eigenpinns_tpu.solvers.multigrid import MultigridTrainer
from eigenpinns_tpu.solvers.oracle import eigsh_smallest

rng = np.random.default_rng(0)
n = 3_000 if SMOKE else 300_000
theta = rng.uniform(0, 2 * np.pi, n)
phi = np.arccos(rng.uniform(-1, 1, n))
r = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
X = r[:, None] * np.stack([np.sin(phi) * np.cos(theta),
                           np.sin(phi) * np.sin(theta), np.cos(phi)], 1)
mesh = TriMesh(X, np.zeros((1, 3), np.int32))

levels = [256, 1024] if SMOKE else [1024, 16384, 65536]
h = build_hierarchy(mesh, levels, n_modes=20,
                    pc_neighbors=15, prolongation_neighbors=8,
                    k_neighbors=8, operator_format="auto")
cfg = Config(n_modes=20, hierarchy=levels,
             loss_mxu_precision="bf16",  # large-N config: the polish
                                         # restores full accuracy
             hidden_layers=[64] * 2 if SMOKE else [256] * 4,
             epochs=20 if SMOKE else 400,
             scan_chunk=10 if SMOKE else 100,
             corrector_scale=1.0, scale_ramp_epochs=200,
             plateau_patience=10**9,
             polish_iters=10 if SMOKE else 100)
res = MultigridTrainer(cfg).train(h)
vals, _ = eigsh_smallest(h.K_scipy[-1], h.M_scipy[-1], 20)
rel = np.abs(res.eigenvalues[1:] - vals[1:]) / np.abs(vals[1:])
print("max rel err vs eigsh:", float(rel.max()))

# 1M-vertex / 50-mode variant (BASELINE stretch config 5):
#
#     EIGENPINNS_1M=1 python examples/large_scale_cloud.py
#
# runs solvers/spectral_basis.py: native C++ point-cloud Laplacian,
# 65k voxel-coarse eigsh warm start + kNN prolongation, cluster-ordered
# SplitBanded operator, blocked deflated LOBPCG (sweeps of 16 + 4 guard
# vectors, each sweep M-orthogonally deflated against all converged
# modes). Solve time and accuracy on the H100: not measured.
if bool(int(os.environ.get("EIGENPINNS_1M", "0"))):
    from eigenpinns_tpu.solvers import spectral_basis

    n1 = 30_000 if SMOKE else 1_000_000
    theta = rng.uniform(0, 2 * np.pi, n1)
    phi = np.arccos(rng.uniform(-1, 1, n1))
    r1 = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
    X1 = r1[:, None] * np.stack([np.sin(phi) * np.cos(theta),
                                 np.sin(phi) * np.sin(theta),
                                 np.cos(phi)], 1)
    res1 = spectral_basis(X1, k=10 if SMOKE else 50,
                          coarse_n=2048 if SMOKE else 65536,
                          operator_format="split")  # one-shot: see docstring
    print("1M timings:", res1.timings)
    print("lam[:8]:", np.round(res1.eigenvalues[:8], 5))
