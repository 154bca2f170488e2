"""eigenpinns_tpu — a physics-informed eigensolver framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the `eigen-pinns`
research reference (see SURVEY.md): lowest eigenpairs of generalized
eigenproblems K u = lambda M u (Laplace-Beltrami on triangle meshes and
point clouds, 1D Schrodinger with parametric boundary ansatz) via neural
networks with composite physics losses, multigrid coarse-to-fine
hierarchies, and classical-solver oracles.

Subpackages
-----------
geometry     mesh IO, P1-FEM operator assembly, point-cloud Laplacian
io           VTU (VTK XML) export/import matching the reference layout
sparse       padded-ELL, banded, rolling-band and strip-BSR operator
             formats with scatter-free VJPs and fused SpMM+Gram
sampling     FPS / voxel / decimation samplers, kNN graphs, prolongation
operators    problem definitions (Laplace-Beltrami, Schrodinger, eikonal)
models       MLPs, GNN correctors, lambda-conditioned eigenfunction nets
losses       Rayleigh residual, M-orthogonality, deflation, whitening
solvers      LOBPCG, Rayleigh-Ritz, Jacobi, CGC, multigrid trainer
train        optax optimizers/schedules, scan-based loops, checkpointing
parallel     jax.sharding meshes, node-sharded SpMM, psum'd Gram/grads
diagnostics  Hungarian alignment, Procrustes, spectra reports, plots
configs      YAML config system mirroring the reference's parameters.yml
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compile cache. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# when it is unset the cache lives at a fixed path inside the checkout, so
# every process of one checkout (tests, CLI, bench, chip_smoke.py) shares
# it. Setting the path only writes the config: no backend is started.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
