"""Iterative deflation PINN on the bunny cloud: one eigenpair at a time.

    python examples/deflation_bunny.py

Reproduces the reference's iterative-eigenvalue experiment
(delta_pinns_validation/iterative_eigenvalues_on_cloud.ipynb): a
lambda-conditioned Sin-MLP finds the lowest modes of the point-cloud
Laplacian sequentially, deflating each new mode against the converged
ones via M-orthogonality penalties. Two drivers are compared:

  * sequential (`solve_deflation`, notebook cell 1): fresh network per
    mode, learnable lambda warm-started at lambda_prev + 0.15, EMA-slope
    early stopping. The notebook's recorded run landed
    lam = [0, .151, .302, .453, .600] against the exact
    [0, .160, .425, .438, .538] — modes 2-4 off by 15-30%.
  * adaptive (`solve_deflation_adaptive`, notebook cell 13): ONE shared
    network, minibatched collocation with point perturbation, and
    convergence-gated in-loop reinitialization — the notebook's fix for
    stalled modes.

Both finish with an optional LOBPCG polish (the device-side step the
notebook lacked) that takes whichever subspace was found to
solver-grade accuracy.

Set EIGENPINNS_SMOKE=1 for a seconds-scale miniature (CI smoke mode).
"""
import os

import numpy as np

SMOKE = bool(int(os.environ.get("EIGENPINNS_SMOKE", "0")))
BUNNY = os.environ.get(
    "EIGENPINNS_BUNNY", "/root/reference/resources/bunny.obj")

from eigenpinns_tpu.geometry import load_mesh, point_cloud_laplacian
from eigenpinns_tpu.solvers.deflation import (
    solve_deflation,
    solve_deflation_adaptive,
)
from eigenpinns_tpu.solvers.oracle import eigsh_smallest
from eigenpinns_tpu.sparse import as_operator

mesh = load_mesh(BUNNY, normalize=True)
X = np.asarray(mesh.verts, np.float32)
if SMOKE:
    X = X[np.random.default_rng(0).choice(len(X), 400, replace=False)]
L, M = point_cloud_laplacian(X, n_neighbors=30)
k = 3 if SMOKE else 5

vals_exact, _ = eigsh_smallest(L, M, k)
print("exact lam:", np.round(vals_exact, 4))

Kop, Mop = as_operator(L), as_operator(M)
common = dict(hidden=(24, 24) if SMOKE else (64, 64, 64),
              polish_iters=0 if SMOKE else 100, seed=0)

res_seq = solve_deflation(
    Kop, Mop, X, n_modes=k,
    epochs_per_mode=300 if SMOKE else 6000,
    scan_chunk=100, lambda_delta=0.15,
    early_stop_patience=None if SMOKE else 1500,
    **common)
rel_seq = (np.abs(res_seq.eigenvalues[1:] - vals_exact[1:])
           / np.abs(vals_exact[1:]))
print(f"sequential lam: {np.round(res_seq.eigenvalues, 4)} "
      f"(max rel err {rel_seq.max():.2%}, "
      f"epochs {res_seq.epochs_per_mode})")

adaptive_pace = (dict(warmup_epochs=200, plateau_epochs=150,
                      min_epochs_between=100, lr=2e-3) if SMOKE else {})
res_ad = solve_deflation_adaptive(
    Kop, Mop, X, n_modes=k,
    epochs=6000 if SMOKE else 25000,
    scan_chunk=100, minibatch=128 if SMOKE else 1024,
    perturb_factor=0.002, **adaptive_pace, **common)
assert len(res_ad.eigenvalues) == k, (
    f"adaptive driver stored {len(res_ad.eigenvalues)}/{k} modes — "
    "raise epochs or lower the plateau gates")
rel_ad = (np.abs(res_ad.eigenvalues[1:] - vals_exact[1:])
          / np.abs(vals_exact[1:]))
print(f"adaptive lam:   {np.round(res_ad.eigenvalues, 4)} "
      f"(max rel err {rel_ad.max():.2%})")
