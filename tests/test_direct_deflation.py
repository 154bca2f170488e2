"""Direct joint training and iterative deflation driver tests."""

import numpy as np
import pytest
import scipy.sparse as sp

from eigenpinns_tpu.sparse import as_operator
from eigenpinns_tpu.solvers import (
    eigsh_smallest,
    solve_deflation,
    train_joint,
)


@pytest.fixture(scope="module")
def sphere_problem():
    from eigenpinns_tpu.geometry import point_cloud_laplacian

    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    vals, vecs = eigsh_smallest(L, M, 6)
    return X, as_operator(L), as_operator(M), L, M, vals, vecs


@pytest.mark.slow
def test_train_joint_penalty(sphere_problem):
    X, Kop, Mop, L, M, vals, _ = sphere_problem
    res = train_joint(Kop, Mop, X, n_modes=5, hidden=(64, 64),
                      mode="penalty", epochs=3000, w_res=1.0, w_orth=10.0,
                      lr_start=5e-3, lr_end=1e-4, seed=0)
    assert res.history["loss"][-1] < res.history["loss"][0]
    # Rayleigh-Ritz finish: eigenvalues near the oracle for low modes
    # (sphere spectrum: 0, then 2,2,2).
    rel = np.abs(res.eigenvalues[1:4] - vals[1:4]) / vals[1:4]
    assert rel.max() < 0.1, (res.eigenvalues, vals)


def test_train_joint_whiten(sphere_problem):
    X, Kop, Mop, L, M, vals, _ = sphere_problem
    res = train_joint(Kop, Mop, X, n_modes=4, hidden=(64, 64),
                      mode="whiten", epochs=2000, w_res=1.0, w_orth=1.0,
                      w_trace=0.5, lr_start=3e-3, seed=0)
    # Whitened output: near-M-orthonormal before any finish.
    U = res.eigenvectors
    G = U.T @ (M @ U)
    assert np.abs(np.diag(G) - 1).max() < 0.05
    assert np.isfinite(res.eigenvalues).all()


def test_train_joint_validates(sphere_problem):
    X, Kop, Mop, *_ = sphere_problem
    with pytest.raises(ValueError):
        train_joint(Kop, Mop, X, 3, mode="bogus", epochs=1)


@pytest.mark.slow
def test_deflation_sequential_modes(sphere_problem):
    X, Kop, Mop, L, M, vals, _ = sphere_problem
    # NB the learnable lambda converges near its warm start (the
    # reference's recorded runs show the same: every reported lambda is
    # lam_prev + 0.15), so the warm-start delta must be informed.
    res = solve_deflation(Kop, Mop, X, n_modes=2, hidden=(48, 48),
                          epochs_per_mode=5000, lr=2e-3, seed=0,
                          lambda_delta=1.8, w_defl=300.0)
    # Mode 0: constant, lambda ~ 0.
    assert abs(res.eigenvalues[0]) < 0.05, res.eigenvalues
    # Mode 1 near the first sphere harmonic (lambda ~ 1.93). Raw-PINN
    # accuracy (no polish) measures 7.4% on this fixture — bound at 1.5x
    # that so a 2x regression fails. (Solver-grade accuracy is asserted
    # by test_deflation_with_polish: <1% with LOBPCG polish. The
    # reference's recorded raw runs show 30-60% errors on modes 2+.)
    assert abs(res.eigenvalues[1] - vals[1]) / vals[1] < 0.11, \
        (res.eigenvalues, vals)
    # Deflation worked: found modes are M-orthogonal.
    U = res.eigenvectors
    g01 = abs(float(U[:, 0] @ (M @ U[:, 1])))
    assert g01 < 0.05


@pytest.mark.slow
def test_train_joint_family_batched(rng):
    """vmap-batched training over a family of sphere clouds: every mesh's
    low modes land near its own oracle."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.solvers import train_joint_family

    K_list, M_list, X_list, oracles = [], [], [], []
    for f in range(3):
        r = np.random.default_rng(10 + f)
        X = r.normal(size=(150 + 20 * f, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        X *= (1.0 + 0.2 * f)  # different radii -> different spectra
        L, M = point_cloud_laplacian(X, n_neighbors=12)
        K_list.append(L)
        M_list.append(M)
        X_list.append(X)
        from eigenpinns_tpu.solvers import eigsh_smallest

        oracles.append(eigsh_smallest(L, M, 3)[0])
    res = train_joint_family(K_list, M_list, X_list, n_modes=3,
                             hidden=(48, 48), epochs=2500, seed=0,
                             polish_iters=150)
    assert res.eigenvalues.shape == (3, 3)
    for f in range(3):
        # Per-mesh LOBPCG polish from the learned subspace: solver-grade.
        rel = abs(res.eigenvalues[f][1] - oracles[f][1]) / oracles[f][1]
        assert rel < 0.01, (f, res.eigenvalues[f], oracles[f])
    # Different radii produce different lambda_1.
    assert res.eigenvalues[0][1] > res.eigenvalues[2][1]


@pytest.mark.slow
def test_deflation_with_polish(sphere_problem):
    """Per-mode LOBPCG polish makes the driver warm-start-insensitive:
    solver-grade eigenvalues with the naive default delta."""
    X, Kop, Mop, L, M, vals, _ = sphere_problem
    res = solve_deflation(Kop, Mop, X, n_modes=3, hidden=(32, 32),
                          epochs_per_mode=500, lr=2e-3, seed=0,
                          polish_iters=200)
    rel = np.abs(res.eigenvalues[1:] - vals[1:3]) / vals[1:3]
    assert rel.max() < 0.01, (res.eigenvalues, vals[:3])


def test_train_joint_minibatched(sphere_problem):
    """Node-minibatched direct training (the million-node path) reaches
    the same low modes as full-batch on the sphere."""
    X, Kop, Mop, L, M, vals, _ = sphere_problem
    res = train_joint(Kop, Mop, X, n_modes=4, hidden=(64, 64),
                      mode="penalty", epochs=4000, w_res=1.0, w_orth=10.0,
                      lr_start=5e-3, lr_end=1e-4, seed=0, batch_nodes=64)
    rel = np.abs(res.eigenvalues[1:3] - vals[1:3]) / vals[1:3]
    assert rel.max() < 0.15, (res.eigenvalues, vals)
    # whiten mode rejects minibatching
    import pytest as _pt

    with _pt.raises(ValueError):
        train_joint(Kop, Mop, X, 3, mode="whiten", batch_nodes=8, epochs=1)


def test_deflation_perturbation_and_early_stop(sphere_problem):
    X, Kop, Mop, *_ = sphere_problem
    res = solve_deflation(Kop, Mop, X, n_modes=1, hidden=(16, 16),
                          epochs_per_mode=2000, lr=2e-3, seed=0,
                          perturb_sigma=0.01, early_stop_patience=100)
    assert np.isfinite(res.eigenvalues).all()
    assert res.epochs_per_mode[0] <= 2000


@pytest.mark.slow
def test_deflation_adaptive_recovers_modes(sphere_problem):
    """The adaptive single-network variant (minibatched collocation +
    convergence-gated in-loop reinitialization, iterative_eigenvalues
    cell 13:148-271) recovers multiple modes within ONE epoch budget,
    reinitializing the shared network after each convergence."""
    from eigenpinns_tpu.solvers import solve_deflation_adaptive

    X, Kop, Mop, L, M, vals, _ = sphere_problem
    res = solve_deflation_adaptive(
        Kop, Mop, X, n_modes=3, hidden=(48, 48),
        epochs=15000, scan_chunk=200, lr=2e-3, minibatch=128,
        plateau_epochs=250, warmup_epochs=400, min_epochs_between=300,
        polish_iters=100, seed=0)
    assert len(res.eigenvalues) == 3
    # Each reinit event happened at a strictly later epoch.
    assert all(a < b for a, b in zip(res.epochs_per_mode,
                                     res.epochs_per_mode[1:]))
    # Early stop: the budget was not exhausted once all modes landed.
    assert res.histories[0]["epochs_run"] < 15000
    # LOBPCG polish snaps the found block onto true eigenpairs: every
    # polished eigenvalue matches some oracle eigenvalue to 1%.
    for lam in res.eigenvalues:
        rel = np.abs(vals - lam) / np.maximum(np.abs(vals), 1e-3)
        assert rel.min() < 0.01, (lam, vals)


def test_deflation_adaptive_triggers(sphere_problem):
    """Mechanism checks on a tiny budget: the plateau trigger fires and
    stores a mode in-loop; the literal reference ema_slope trigger
    compiles and runs (it needs a smooth full-batch loss to ever fire,
    see the driver docstring)."""
    from eigenpinns_tpu.solvers import solve_deflation_adaptive

    X, Kop, Mop, *_ = sphere_problem
    res = solve_deflation_adaptive(
        Kop, Mop, X, n_modes=1, hidden=(16, 16),
        epochs=2500, scan_chunk=100, lr=2e-3, minibatch=None,
        plateau_epochs=60, plateau_rtol=1e-2, warmup_epochs=100,
        min_epochs_between=50, seed=0)
    assert len(res.eigenvalues) == 1
    h = res.histories[0]
    found_epoch = res.epochs_per_mode[0]
    # The smoothed-loss flat counter drove the store (it reports its
    # pre-reset value at the firing epoch) and resets after the reinit.
    assert h["flat"][found_epoch] >= 60
    assert h["flat"][found_epoch + 1] == 0
    assert h["found"][found_epoch] == 1
    res2 = solve_deflation_adaptive(
        Kop, Mop, X, n_modes=1, hidden=(16, 16),
        epochs=300, scan_chunk=100, lr=2e-3,
        trigger="ema_slope", reinit_threshold=1e2, warmup_epochs=50,
        min_epochs_between=10, seed=0)
    # A huge threshold makes the reference detector fire immediately.
    assert len(res2.eigenvalues) == 1
    assert res2.histories[0]["epochs_run"] < 300


def test_deflation_ema_slope_monitor(sphere_problem):
    """The EMA must seed from the first loss (not stay inf) and the slope
    monitor must be finite and drive early stopping."""
    X, Kop, Mop, *_ = sphere_problem
    res = solve_deflation(Kop, Mop, X, n_modes=1, hidden=(16, 16),
                          epochs_per_mode=2000, scan_chunk=50,
                          early_stop_patience=25, ema_decay=0.9,
                          ema_slope_tol=1e2, seed=0)
    slope = res.histories[0]["ema_slope"]
    assert np.isinf(slope[0])           # unseeded first step only
    assert np.isfinite(slope[1:]).all()
    # a huge tol makes the flat-slope counter fire almost immediately
    assert res.epochs_per_mode[0] < 2000


def test_lobpcg_blocked_checkpoint_resume(rng, tmp_path):
    """Interrupted blocked sweeps resume from the last converged block
    with IDENTICAL results: kill after block 1,
    restart, compare to an uninterrupted run."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.solvers.lobpcg import lobpcg_blocked
    from eigenpinns_tpu.sparse import as_operator

    n = 400
    K = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                  np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr()
    M = sp.eye(n).tocsr()
    Kop, Mop = as_operator(K), as_operator(M)
    kw = dict(block=3, guard=2, max_iter=300, tol=1e-8)

    vals_ref, vecs_ref, _ = lobpcg_blocked(Kop, Mop, 9, **kw)

    # "Die" after the first block: a log_fn that raises.
    ckdir = str(tmp_path / "lb")

    class _Die(Exception):
        pass

    def killer(b0, keep, res):
        # log_fn runs before the block's checkpoint save: die at the
        # START of block 2's completion so block 1 is already on disk.
        if b0 >= 3:
            raise _Die

    try:
        lobpcg_blocked(Kop, Mop, 9, checkpoint_dir=ckdir, log_fn=killer,
                       **kw)
        raise AssertionError("killer did not fire")
    except _Die:
        pass
    import os

    assert os.path.exists(os.path.join(ckdir, "lobpcg_blocked.npz"))

    # Resume: must reproduce the uninterrupted run exactly (the restored
    # PRNG key stream replays the remaining block inits bit-for-bit).
    vals2, vecs2, _ = lobpcg_blocked(Kop, Mop, 9, checkpoint_dir=ckdir,
                                     **kw)
    assert np.abs(vals2 - vals_ref).max() < 1e-9, (vals2, vals_ref)
    sign = np.sign(np.sum(vecs_ref * vecs2, axis=0))
    assert np.abs(vecs2 * sign - vecs_ref).max() < 1e-6
