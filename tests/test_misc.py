"""Projection, Poisson solves, profiling/debug utils, visualizations."""

import numpy as np
import pytest

from eigenpinns_tpu.geometry import (
    TriMesh,
    project_points,
    project_points_device,
)
from eigenpinns_tpu.solvers import (
    solve_laplace_dirichlet,
    solve_laplace_dirichlet_device,
)
from eigenpinns_tpu.utils import (
    PhaseTimer,
    assert_finite,
    debug_nans,
    deterministic_mode,
)


def square_mesh(n=10):
    """Unit-square grid mesh in the z=0 plane."""
    xs = np.linspace(0, 1, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(n * n)], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + n, a + 1])
            faces.append([a + 1, a + n, a + n + 1])
    return TriMesh(verts, np.asarray(faces, np.int32))


def test_project_points_onto_plane():
    mesh = square_mesh(8)
    q = np.array([[0.33, 0.41, 0.7], [0.9, 0.1, -0.2], [-0.5, 0.5, 0.1]])
    proj, fidx, bary = project_points(mesh, q)
    # Interior points project straight down; outside points clamp to edge.
    assert np.allclose(proj[0], [0.33, 0.41, 0.0], atol=1e-9)
    assert np.allclose(proj[1], [0.9, 0.1, 0.0], atol=1e-9)
    assert np.allclose(proj[2], [0.0, 0.5, 0.0], atol=1e-9)
    assert np.allclose(bary.sum(axis=1), 1.0, atol=1e-9)
    # Device variant agrees.
    proj_d, _ = project_points_device(mesh.verts, mesh.faces, q)
    assert np.abs(np.asarray(proj_d) - proj).max() < 1e-5


def test_laplace_dirichlet_linear_solution():
    """Harmonic on the square with u = x on the boundary -> u = x."""
    from eigenpinns_tpu.geometry import assemble_stiffness_mass

    mesh = square_mesh(9)
    K, _ = assemble_stiffness_mass(mesh)
    v = mesh.verts
    boundary = np.where(
        (np.abs(v[:, 0]) < 1e-12) | (np.abs(v[:, 0] - 1) < 1e-12)
        | (np.abs(v[:, 1]) < 1e-12) | (np.abs(v[:, 1] - 1) < 1e-12))[0]
    u = solve_laplace_dirichlet(K, boundary, v[boundary, 0])
    assert np.abs(u - v[:, 0]).max() < 1e-8

    # Device CG path agrees.
    import jax.numpy as jnp

    from eigenpinns_tpu.sparse import as_operator

    mask = np.zeros(mesh.n_verts, bool)
    mask[boundary] = True
    vals = np.zeros(mesh.n_verts)
    vals[boundary] = v[boundary, 0]
    u_d = solve_laplace_dirichlet_device(
        as_operator(K), jnp.asarray(mask), jnp.asarray(vals,
                                                       jnp.float32),
        cg_iters=300)
    assert np.abs(np.asarray(u_d) - v[:, 0]).max() < 1e-3


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    rep = t.report()
    assert "a" in rep and "TOTAL" in rep
    assert t.counts["a"] == 2


def test_debug_utils():
    key = deterministic_mode(3)
    assert key is not None
    assert_finite({"x": np.ones(3)})
    with pytest.raises(FloatingPointError):
        assert_finite({"x": np.array([1.0, np.nan])})
    import jax
    import jax.numpy as jnp

    with debug_nans():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()


def test_visualizations(tmp_path, coarse1_mesh):
    from eigenpinns_tpu.diagnostics import (
        plot_eigenfunctions,
        plot_loss_history,
        plot_mesh,
    )

    plot_mesh(coarse1_mesh, str(tmp_path / "mesh.png"),
              highlight_indices=[0, 5, 10])
    U = np.random.default_rng(0).normal(size=(coarse1_mesh.n_verts, 4))
    plot_eigenfunctions(coarse1_mesh, U, str(tmp_path / "modes.png"),
                        modes=(0, 1))
    plot_loss_history({"loss": np.geomspace(1, 1e-3, 50)},
                      str(tmp_path / "hist.png"))
    for f in ("mesh.png", "modes.png", "hist.png"):
        assert (tmp_path / f).stat().st_size > 1000


def test_fps_jax_matches_numpy():
    import numpy as np

    from eigenpinns_tpu.sampling import farthest_point_indices, fps_jax

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3))
    # Same start -> same selection (distances are unambiguous here).
    from eigenpinns_tpu.geometry import native

    host = (native.fps_native(pts, 20, start=0) if native.available()
            else None)
    dev = np.asarray(fps_jax(pts.astype(np.float32), 20, start=0))
    if host is not None:
        assert np.array_equal(np.sort(host), np.sort(dev)), (host, dev)
    # Coverage property regardless.
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pts[dev]).query(pts, k=1)
    assert d.max() < np.linalg.norm(pts.max(0) - pts.min(0)) / 2


def test_leverage_score_levels():
    from eigenpinns_tpu.utils import generate_test_matrices
    from eigenpinns_tpu.sampling import leverage_score_levels

    K, _ = generate_test_matrices(80, "random_spd")
    levels = leverage_score_levels(K, [10, 30], seed=0)
    assert [len(l) for l in levels] == [10, 30, 80]
    assert set(levels[0]) <= set(levels[1])


def test_optimizer_stacks():
    import jax.numpy as jnp
    import optax

    from eigenpinns_tpu.train import adam_exp_decay, adamw_cosine_restarts

    params = {"w": jnp.ones((3,))}
    for opt, sched in (adamw_cosine_restarts(1e-3, 100),
                       adam_exp_decay()):
        state = opt.init(params)
        g = {"w": jnp.ones((3,))}
        up, state = opt.update(g, state, params)
        p2 = optax.apply_updates(params, up)
        assert np.isfinite(np.asarray(p2["w"])).all()
    # SGDR schedule restarts: lr jumps back up after the first cycle.
    _, sched = adamw_cosine_restarts(1.0, 10, n_cycles=3)
    assert float(sched(9)) < 0.1 < float(sched(11))


def test_scan_loop_start_epoch_and_below_tol():
    """start_epoch offsets the epoch step_fn sees (checkpoint-resume
    ramps continue); below_tol mode stops once the metric stays under
    tol for `patience` epochs."""
    import jax.numpy as jnp

    from eigenpinns_tpu.train.loop import run_scan_loop

    def step(state, epoch):
        return state + 1, {"loss": jnp.float32(1.0),
                           "epoch": epoch.astype(jnp.float32)}

    res = run_scan_loop(step, jnp.int32(0), n_epochs=10, chunk=4,
                        start_epoch=100)
    assert res.history["epoch"].tolist() == [float(e) for e in
                                             range(100, 110)]

    # below_tol: metric drops under tol at epoch 5 -> counter starts,
    # stop fires when it exceeds patience=3 (epoch 8, end of chunk 9).
    def step2(state, epoch):
        m = jnp.where(epoch >= 5, 1e-9, 1.0).astype(jnp.float32)
        return state, {"loss": m, "m": m}

    res2 = run_scan_loop(step2, jnp.int32(0), n_epochs=100, chunk=5,
                         early_stop_patience=3, early_stop_metric="m",
                         early_stop_mode="below_tol", early_stop_tol=1e-6)
    assert res2.stopped_early
    assert res2.epochs_run <= 15


def test_device_side_band_assembly_matches_host():
    """The device-scatter build path (used above the transfer threshold)
    produces bit-identical operators to the host-numpy build."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import bsr, rolling

    rng = np.random.default_rng(3)
    n = 500
    A = sp.random(n, n, density=0.02, random_state=1).tocsr()
    A = (A + A.T).tocsr()

    old = rolling._DEVICE_BUILD_MIN_BYTES
    try:
        rolling._DEVICE_BUILD_MIN_BYTES = 0
        op_dev, p1 = rolling.RollingBanded.from_scipy(A)
        bsr_dev, p3 = bsr.BSRTile.from_scipy(A)
    finally:
        rolling._DEVICE_BUILD_MIN_BYTES = old
    op_host, p2 = rolling.RollingBanded.from_scipy(A)
    bsr_host, p4 = bsr.BSRTile.from_scipy(A)
    assert np.array_equal(p1, p2)
    assert np.array_equal(np.asarray(op_dev.band),
                          np.asarray(op_host.band))
    assert np.array_equal(np.asarray(bsr_dev.data),
                          np.asarray(bsr_host.data))
    del jnp, rng
