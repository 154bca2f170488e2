"""Sharding tests on the 8-device virtual CPU mesh: sharded results must
match single-device results (the distributed test strategy SURVEY.md
section 4 calls for)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from eigenpinns_tpu.parallel import (
    ShardedOperator,
    all_gather_spmm,
    halo_spmm,
    make_dp_train_step,
    make_mesh,
    pad_rows,
    psum_gram,
    shard_array,
)
from eigenpinns_tpu.sparse import SparseELL, as_operator, spmm
from jax.sharding import PartitionSpec as P


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return make_mesh(8)


def banded_operator(n, width=2):
    diags = [np.full(n - abs(o), -1.0 / (1 + abs(o)))
             for o in range(-width, width + 1)]
    A = sp.diags(diags, list(range(-width, width + 1))).tocsr()
    return A


def test_all_gather_spmm_matches_dense(mesh8, rng):
    n, k = 203, 6
    A = sp.random(n, n, density=0.05,
                  random_state=np.random.RandomState(1)).tocsr()
    A = (A + A.T).tocsr()
    ell = SparseELL.from_scipy(A)
    op = ShardedOperator.from_ell(ell, 8)
    f = all_gather_spmm(op, mesh8)
    U = rng.normal(size=(n, k)).astype(np.float32)
    Up, _ = pad_rows(jnp.asarray(U), 8 * op.rows_per_dev // op.rows_per_dev)
    Up = jnp.pad(jnp.asarray(U), ((0, op.n_dev * op.rows_per_dev - n),
                                  (0, 0)))
    Us = shard_array(Up, mesh8, P("data"))
    out = np.asarray(f(Us))[:n]
    ref = A @ U.astype(np.float64)
    assert np.abs(out - ref).max() < 1e-4


def test_halo_spmm_matches_dense(mesh8, rng):
    n, k = 240, 4
    A = banded_operator(n, width=3)  # bandwidth 3 << rows_per_dev = 30
    ell = SparseELL.from_scipy(A)
    op = ShardedOperator.from_ell(ell, 8)
    f = halo_spmm(op, mesh8)
    U = rng.normal(size=(n, k)).astype(np.float32)
    Up = jnp.pad(jnp.asarray(U), ((0, op.n_dev * op.rows_per_dev - n),
                                  (0, 0)))
    Us = shard_array(Up, mesh8, P("data"))
    out = np.asarray(f(Us))[:n]
    ref = A @ U.astype(np.float64)
    assert np.abs(out - ref).max() < 1e-4


def test_halo_spmm_rejects_wide_stencil(mesh8):
    n = 64
    A = sp.random(n, n, density=0.3,
                  random_state=np.random.RandomState(0)).tocsr()
    op = ShardedOperator.from_ell(SparseELL.from_scipy(A), 8)
    with pytest.raises(ValueError):
        halo_spmm(op, mesh8)


def test_psum_gram_matches_dense(mesh8, rng):
    n, k = 160, 5
    U = rng.normal(size=(n, k)).astype(np.float32)
    V = rng.normal(size=(n, k)).astype(np.float32)
    g = psum_gram(mesh8)
    Us = shard_array(jnp.asarray(U), mesh8, P("data"))
    Vs = shard_array(jnp.asarray(V), mesh8, P("data"))
    out = np.asarray(g(Us, Vs))
    assert np.abs(out - U.T @ V).max() < 1e-3


def test_dp_train_step_matches_single_device(rng):
    """One DP step on 8 devices == the same step on 1 device."""
    import optax

    from eigenpinns_tpu.models import JointEigenNet

    n, k = 64, 3
    X = rng.normal(size=(n, 3)).astype(np.float32)
    model = JointEigenNet((16,), n_modes=k)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(X))
    opt = optax.sgd(1e-2)

    def loss_fn(params, batch):
        U = model.apply(params, batch)
        return jnp.mean(U**2) + jnp.mean(batch)

    results = {}
    for ndev in (1, 8):
        mesh = make_mesh(ndev)
        step = make_dp_train_step(loss_fn, opt, mesh)
        p, o, l = step(params, opt.init(params), jnp.asarray(X))
        results[ndev] = (jax.tree_util.tree_leaves(p), float(l))
    for a, b in zip(results[1][0], results[8][0]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-5
    assert abs(results[1][1] - results[8][1]) < 1e-5


@pytest.mark.slow
def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


# ---- ShardedBanded: halo-banded distributed SpMM on REAL operators ------


@pytest.fixture(scope="module")
def bunny_fem(bunny_mesh):
    from eigenpinns_tpu.geometry import assemble_stiffness_mass

    return assemble_stiffness_mass(bunny_mesh)


def test_sharded_banded_spmm_real_operator(mesh8, bunny_fem, rng):
    """Halo-banded sharded SpMM (fwd + VJP) is exact on the bunny FEM
    stiffness — a real mesh operator, not a synthetic tridiagonal."""
    from eigenpinns_tpu.parallel import ShardedBanded, sharded_banded_spmm

    K, _ = bunny_fem
    n = K.shape[0]
    op, perm = ShardedBanded.from_scipy(K, 8)
    f = sharded_banded_spmm(op, mesh8)
    U = np.zeros((op.n_pad, 4), np.float32)
    U[:n] = rng.normal(size=(n, 4)).astype(np.float32)
    Us = shard_array(jnp.asarray(U), mesh8, P("data"))
    Kp = K.tocsr()[perm][:, perm]
    ref = Kp @ np.asarray(U[:n], np.float64)
    out = np.asarray(jax.jit(f)(Us))[:n]
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    g = np.asarray(jax.jit(jax.grad(lambda u: jnp.sum(f(u) ** 2)))(Us))[:n]
    gref = 2 * Kp.T @ (Kp @ np.asarray(U[:n], np.float64))
    assert np.abs(g - gref).max() / np.abs(gref).max() < 1e-5
    assert np.abs(np.asarray(op.diagonal()) - Kp.diagonal()).max() < 1e-5


@pytest.mark.parametrize("split", [False, True])
def test_sharded_spmm_places_one_shard_per_device(mesh8, rng, split):
    """The sharded SpMM factories put shard s of every operator array
    on device s, so no device holds the whole operator."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.parallel import (
        build_sharded_operator,
        sharded_banded_spmm,
        sharded_split_spmm,
    )

    from eigenpinns_tpu.utils import laplacian_1d

    if split:
        X = rng.normal(size=(2000, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        L, _ = point_cloud_laplacian(X, n_neighbors=14)
        kind, (core, rem), _ = build_sharded_operator(
            L, 8, X=X, max_bandwidth=128, window=128)
    else:
        kind, (core, rem), _ = build_sharded_operator(laplacian_1d(2048), 8)
    assert kind == ("split" if split else "banded")
    f = (sharded_split_spmm(core, rem, mesh8) if split
         else sharded_banded_spmm(core, mesh8))
    leaves = jax.tree_util.tree_leaves(f)
    assert len(leaves) == (6 if split else 4)
    for leaf in leaves:
        assert leaf.sharding.spec == P("data")
        shards = leaf.addressable_shards
        assert len({s.device for s in shards}) == 8
        assert all(s.data.shape[0] == 1 for s in shards)


def test_sharded_banded_rejects_crossing_stencil(mesh8):
    """A mesh too small for 8 shards (bandwidth > rows/shard) must be
    rejected so callers fall back to all_gather — the stencil-check
    failure path on a real operator."""
    from eigenpinns_tpu.geometry import assemble_stiffness_mass, load_mesh
    from eigenpinns_tpu.parallel import ShardedBanded

    m = load_mesh("/root/reference/resources/coarse_1.obj")
    K, _ = assemble_stiffness_mass(m)
    with pytest.raises(ValueError, match="stencil|bandwidth"):
        ShardedBanded.from_scipy(K, 8)


def test_sharded_split_spmm_real_cloud(mesh8, rng):
    """Cluster-split sharded SpMM (banded core via halo + remainder via
    all_gather) is exact on a real point-cloud Laplacian."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.parallel import (
        build_sharded_operator,
        sharded_split_spmm,
    )

    X = rng.normal(size=(2000, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=14)
    kind, (core, rem), perm = build_sharded_operator(
        L, 8, X=X, max_bandwidth=128, window=128)
    assert kind == "split" and rem is not None
    f = sharded_split_spmm(core, rem, mesh8)
    n = L.shape[0]
    U = np.zeros((core.n_pad, 4), np.float32)
    U[:n] = rng.normal(size=(n, 4)).astype(np.float32)
    Us = shard_array(jnp.asarray(U), mesh8, P("data"))
    Lp = L.tocsr()[perm][:, perm]
    ref = Lp @ np.asarray(U[:n], np.float64)
    out = np.asarray(jax.jit(f)(Us))[:n]
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    g = np.asarray(jax.jit(jax.grad(lambda u: jnp.sum(f(u) ** 2)))(Us))[:n]
    gref = 2 * Lp.T @ (Lp @ np.asarray(U[:n], np.float64))
    assert np.abs(g - gref).max() / np.abs(gref).max() < 1e-5


def test_halo_spmm_real_mesh_operator(bunny_fem, rng):
    """The ELL ring-halo SpMM works on a real RCM-ordered FEM stiffness
    (not just the synthetic tridiagonal)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    K, _ = bunny_fem
    perm = np.asarray(reverse_cuthill_mckee(K.tocsr(), symmetric_mode=True))
    Kp = K.tocsr()[perm][:, perm].tocsr()
    mesh4 = make_mesh(4)   # bunny RCM bandwidth 384 < 2503/4 rows/shard
    op = ShardedOperator.from_ell(SparseELL.from_scipy(Kp), 4)
    f = halo_spmm(op, mesh4)
    n = K.shape[0]
    U = rng.normal(size=(n, 4)).astype(np.float32)
    Up = jnp.pad(jnp.asarray(U), ((0, op.n_dev * op.rows_per_dev - n),
                                  (0, 0)))
    out = np.asarray(f(shard_array(Up, mesh4, P("data"))))[:n]
    ref = Kp @ U.astype(np.float64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.slow
def test_train_joint_sharded_matches_single_device(rng):
    """The distributed production trainer reproduces the single-device
    trainer: same loss trajectory and the same eigenvalues."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.solvers import train_joint, train_joint_sharded

    X = rng.normal(size=(1200, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    kw = dict(n_modes=4, hidden=(32, 32), epochs=400, scan_chunk=100,
              lr_start=3e-3, lr_end=1e-3, w_res=1.0, w_orth=10.0, seed=0)
    r1 = train_joint(as_operator(L), as_operator(M), X, **kw)
    r8 = train_joint_sharded(L, M, X, n_devices=8, **kw)
    d = np.abs(r1.history["loss"] - r8.history["loss"]) / np.maximum(
        np.abs(r1.history["loss"]), 1e-9)
    assert d.max() < 1e-3
    lam_d = np.abs(r1.eigenvalues - r8.eigenvalues) / np.maximum(
        np.abs(r1.eigenvalues), 1e-6)
    assert lam_d.max() < 1e-4
    # Returned eigenvectors are in the caller's vertex order and must
    # MATCH the single-device ones mode by mode (up to sign) — the real
    # invariant of this test, replacing the old residual<1.0 non-check.
    U1, U8 = r1.eigenvectors, r8.eigenvectors
    sign = np.sign(np.sum(U1 * U8, axis=0))
    d_vec = np.abs(U8 * sign[None, :] - U1).max() / np.abs(U1).max()
    assert d_vec < 1e-3, d_vec
    # And the per-mode scaled residuals (vs the ORIGINAL operators —
    # order round-trip check) agree with the single-device trainer's:
    # the sharded path may not degrade the solution it distributes.
    def scaled_resid(res):
        U, lam = res.eigenvectors, res.eigenvalues
        r = np.linalg.norm(L @ U - (M @ U) * lam[None, :], axis=0)
        s = (np.linalg.norm(L @ U, axis=0)
             + np.abs(lam) * np.linalg.norm(M @ U, axis=0))
        return r / s

    s1, s8 = scaled_resid(r1), scaled_resid(r8)
    assert np.abs(s8 - s1).max() < 0.01, (s1, s8)


@pytest.mark.slow
def test_lobpcg_sharded_matches_eigsh(rng):
    """Node-sharded LOBPCG (FunctionOperator over the halo SpMM) on an
    8-device mesh reproduces eigsh — single blocks and deflated sweeps."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.solvers import eigsh_smallest
    from eigenpinns_tpu.solvers.lobpcg_sharded import lobpcg_sharded

    X = rng.normal(size=(1500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=14)
    vals_ref, _ = eigsh_smallest(L, M, 8)

    vals, vecs, resids = lobpcg_sharded(L, M, k=8, n_devices=8, X=X,
                                        max_iter=400, tol=1e-7)
    rel = np.abs(vals[1:] - vals_ref[1:]) / np.abs(vals_ref[1:])
    assert rel.max() < 1e-3, (vals, vals_ref)
    # Eigenvectors in the CALLER's order: residuals vs the original ops.
    R = L @ vecs - (M @ vecs) * vals[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(vecs) < 1e-2

    # Blocked deflated sweeps, sharded: global M-orthonormality across
    # blocks.
    vals_b, vecs_b, _ = lobpcg_sharded(L, M, k=8, n_devices=8, X=X,
                                       block=3, guard=2, max_iter=400,
                                       tol=1e-7)
    rel_b = np.abs(vals_b[1:] - vals_ref[1:]) / np.abs(vals_ref[1:])
    assert rel_b.max() < 1e-3, (vals_b, vals_ref)
    G = vecs_b.T @ (M @ vecs_b)
    assert np.abs(G - np.eye(8)).max() < 1e-3


@pytest.mark.slow
def test_spectral_basis_sharded(rng):
    """spectral_basis(n_devices=8): the large-scale driver end-to-end on
    the mesh — warm start, sharded blocked LOBPCG, caller vertex order."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.solvers import eigsh_smallest, spectral_basis

    X = rng.normal(size=(1500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=14)
    vals_ref, _ = eigsh_smallest(L, M, 6)

    res = spectral_basis(X, k=6, n_neighbors=14, coarse_n=400,
                         n_devices=8, block=3, guard=2, max_iter=300,
                         tol=1e-6, log_fn=None)
    rel = np.abs(res.eigenvalues[1:] - vals_ref[1:]) / np.abs(vals_ref[1:])
    assert rel.max() < 1e-3, (res.eigenvalues, vals_ref)
    U = res.eigenvectors
    num = np.sum(U * (L @ U), axis=0)
    den = np.sum(U * (M @ U), axis=0)
    assert np.allclose(num / den, res.eigenvalues, rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_train_joint_sharded_checkpoint_resume(rng, tmp_path):
    """Sharded trainer checkpoints (replicated pytrees, mesh-shape
    independent) and resumes with the epoch offset intact."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.solvers import train_joint_sharded

    X = rng.normal(size=(600, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=12)
    kw = dict(n_modes=3, hidden=(16, 16), scan_chunk=20, lr_start=2e-3,
              lr_end=1e-3, w_res=1.0, w_orth=10.0, seed=0,
              checkpoint_dir=str(tmp_path / "ck"))
    r1 = train_joint_sharded(L, M, X, n_devices=8, epochs=40, **kw)
    # Resume: 40 more epochs continue from step 40.
    r2 = train_joint_sharded(L, M, X, n_devices=8, epochs=40, **kw)
    assert r2.history["loss"][0] < r1.history["loss"][0] * 1.5
    import os

    steps = sorted(os.listdir(tmp_path / "ck"))
    assert "step_40" in steps and "step_80" in steps, steps


def test_two_axis_mesh_halo_spmm_and_gram(rng):
    """Product meshes (data x model): the halo ring and the Gram psum
    must address ONLY their named axis, so a second mesh axis (with the
    operands replicated along it) changes nothing (collective
    correctness under a non-1D mesh)."""
    mesh = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    n, k = 512, 5
    A = banded_operator(n, width=3)
    op = ShardedOperator.from_ell(SparseELL.from_scipy(A), 4)
    f = halo_spmm(op, mesh, axis="data")
    U = rng.normal(size=(n, k)).astype(np.float32)
    Up = jnp.pad(jnp.asarray(U),
                 ((0, op.n_dev * op.rows_per_dev - n), (0, 0)))
    out = np.asarray(f(shard_array(Up, mesh, P("data"))))[:n]
    ref = A @ U.astype(np.float64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5

    g = psum_gram(mesh, axis="data")
    G = np.asarray(g(Up, Up))
    ref_g = U.astype(np.float64).T @ U.astype(np.float64)
    assert np.abs(G - ref_g).max() / np.abs(ref_g).max() < 1e-5
