"""Sampler / hierarchy tests."""

import numpy as np
import pytest

from eigenpinns_tpu.sampling import (
    build_hierarchy,
    decimate,
    farthest_point_levels,
    knn_graph,
    knn_graph_device,
    prolongation_matrix,
    random_levels,
    voxel_levels,
)


def sphere_cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_fps_levels_nested_sorted():
    pts = sphere_cloud(500)
    levels = farthest_point_levels(pts, [50, 100, 200])
    assert [len(l) for l in levels] == [50, 100, 200, 500]
    for a, b in zip(levels[:-1], levels[1:]):
        assert set(a) <= set(b)          # nested
        assert np.all(np.diff(a) > 0)    # sorted unique


def test_fps_covers_space():
    pts = sphere_cloud(1000)
    idx = farthest_point_levels(pts, [100])[0]
    # FPS spreads samples: every point has a sample within a small radius.
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pts[idx]).query(pts, k=1)
    assert d.max() < 0.5


def test_voxel_levels_counts():
    pts = sphere_cloud(2000)
    levels = voxel_levels(pts, [100, 400])
    assert len(levels) == 3
    assert levels[2].size == 2000
    # Voxel search targets are approximate; accept a generous band.
    assert 50 <= levels[0].size <= 100
    assert 200 <= levels[1].size <= 400
    for l in levels[:-1]:
        assert np.all(np.diff(l) > 0)


def test_random_levels_nested():
    pts = sphere_cloud(300)
    levels = random_levels(pts, [30, 90])
    assert set(levels[0]) <= set(levels[1])


def test_knn_graph():
    pts = sphere_cloud(100)
    e = knn_graph(pts, 5)
    assert e.shape == (2, 500)
    assert not np.any(e[0] == e[1])  # no self loops
    # Each node appears exactly k times as source.
    assert np.all(np.bincount(e[0]) == 5)


def test_knn_graph_device_matches_host():
    pts = sphere_cloud(64).astype(np.float32)
    eh = knn_graph(pts, 4)
    ed = np.asarray(knn_graph_device(pts, 4))
    # Same neighbor sets per node (order may differ).
    for i in range(64):
        assert set(eh[1][eh[0] == i]) == set(ed[1][ed[0] == i])


def test_prolongation_rows_sum_to_one():
    Xc, Xf = sphere_cloud(50), sphere_cloud(200, seed=1)
    P = prolongation_matrix(Xc, Xf, 5).tocsr()
    assert P.shape == (200, 50)
    assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0, atol=1e-9)
    # Interpolation reproduces constants.
    assert np.allclose(P @ np.ones(50), 1.0, atol=1e-9)


def test_decimate_bunny(coarse1_mesh):
    out = decimate(coarse1_mesh, 90)
    assert out.n_verts <= 95
    assert out.n_faces > 50
    # Geometry preserved: bounding box within 20% of original.
    bb_in = coarse1_mesh.verts.max(0) - coarse1_mesh.verts.min(0)
    bb_out = out.verts.max(0) - out.verts.min(0)
    assert np.all(np.abs(bb_out - bb_in) / bb_in < 0.2)
    # Surface area roughly preserved.
    assert abs(out.face_areas().sum() - coarse1_mesh.face_areas().sum()) \
        / coarse1_mesh.face_areas().sum() < 0.2


@pytest.mark.parametrize("sampler_type", ["farthest_point", "random"])
def test_build_hierarchy_point_cloud(coarse1_mesh, sampler_type):
    h = build_hierarchy(coarse1_mesh, [64, 120], n_modes=5,
                        sampler_type=sampler_type, pc_neighbors=15)
    assert h.n_levels == 3
    assert h.actual_hierarchy == [64, 120, 187]
    assert h.node_offsets == [0, 64, 184]
    assert len(h.P_ops) == 2 and len(h.U_list) == 3
    # Coarse eigenvalues: lambda_0 ~ 0, increasing.
    assert abs(h.coarse_eigenvalues[0]) < 1e-6
    assert np.all(np.diff(h.coarse_eigenvalues) > -1e-9)
    # Initial guesses have sane norms (smoothed prolongations).
    for U in h.U_list:
        assert np.isfinite(np.asarray(U)).all()


def test_build_hierarchy_graph_coarsening(coarse1_mesh):
    h = build_hierarchy(coarse1_mesh, [100], n_modes=4,
                        sampler_type="graph_coarsening",
                        edge_computation_type="connectivity_based")
    assert h.n_levels == 2
    assert h.actual_hierarchy[-1] == 187
    assert abs(h.coarse_eigenvalues[0]) < 1e-6


def test_build_hierarchy_validates():
    import pytest as _pt

    with _pt.raises(ValueError):
        build_hierarchy(None, [10], 2, sampler_type="bogus")


def test_build_hierarchy_lobpcg_coarse_solver(coarse1_mesh):
    """On-device coarse solve option produces the same coarse spectrum as
    the ARPACK oracle."""
    h1 = build_hierarchy(coarse1_mesh, [64], n_modes=4, pc_neighbors=15,
                         coarse_solver="eigsh")
    h2 = build_hierarchy(coarse1_mesh, [64], n_modes=4, pc_neighbors=15,
                         coarse_solver="lobpcg")
    rel = np.abs(h2.coarse_eigenvalues[1:] - h1.coarse_eigenvalues[1:]) \
        / h1.coarse_eigenvalues[1:]
    assert rel.max() < 0.02, (h1.coarse_eigenvalues, h2.coarse_eigenvalues)


def test_hierarchy_save_load_roundtrip(coarse1_mesh, tmp_path):
    """Cached hierarchies reload and train identically."""
    h = build_hierarchy(coarse1_mesh, [64, 120], n_modes=4,
                        sampler_type="farthest_point", pc_neighbors=15,
                        operator_format="auto")
    from eigenpinns_tpu.sampling import Hierarchy

    h.save(str(tmp_path / "h"))
    h2 = Hierarchy.load(str(tmp_path / "h"), operator_format="auto")
    assert h2.actual_hierarchy == h.actual_hierarchy
    assert np.allclose(h2.coarse_eigenvalues, h.coarse_eigenvalues)
    assert np.allclose(np.asarray(h2.U_list[1]), np.asarray(h.U_list[1]))
    assert (h2.perms is not None) == (h.perms is not None)
    assert np.array_equal(h2.perms[-1], h.perms[-1])
    # Operators reproduce SpMM results.
    import jax.numpy as jnp

    from eigenpinns_tpu.sparse import spmm

    U = jnp.asarray(np.random.default_rng(0).normal(
        size=(h.actual_hierarchy[-1], 3)).astype(np.float32))
    a = np.asarray(spmm(h.K_ops[-1], U))
    b = np.asarray(spmm(h2.K_ops[-1], U))
    assert np.abs(a - b).max() < 1e-6
    # A trainer runs off the loaded hierarchy.
    from eigenpinns_tpu.configs import Config
    from eigenpinns_tpu.solvers.multigrid import MultigridTrainer

    cfg = Config(n_modes=4, hierarchy=[64, 120], hidden_layers=[16],
                 epochs=20, scan_chunk=20, corrector_scale=1.0,
                 scale_ramp_epochs=10, plateau_patience=10**9)
    res = MultigridTrainer(cfg).train(h2)
    assert np.isfinite(res.eigenvalues).all()


def test_banded_connectivity_edges_follow_permutation(coarse1_mesh):
    """With banded operators the node data is RCM-permuted per level;
    connectivity edges must be remapped into the same numbering."""
    kw = dict(hierarchy=[100], n_modes=4,
              sampler_type="graph_coarsening",
              edge_computation_type="connectivity_based")
    h_ell = build_hierarchy(coarse1_mesh, operator_format="ell", **kw)
    h_band = build_hierarchy(coarse1_mesh, operator_format="banded",
                             max_bandwidth=4096, **kw)
    assert h_band.perms is not None
    for lvl in range(h_band.n_levels):
        perm = h_band.perms[lvl]
        inv = np.empty(len(perm), dtype=np.int64)
        inv[perm] = np.arange(len(perm))
        expect = np.sort(inv[h_ell.edge_index_list[lvl]], axis=1)
        got = np.sort(np.asarray(h_band.edge_index_list[lvl]), axis=1)
        # Same undirected edge set in the permuted numbering.
        assert {tuple(e) for e in expect.T.tolist()} == \
               {tuple(e) for e in got.T.tolist()}
        # And each edge joins vertices at identical coordinates.
        X = h_band.X_list[lvl]
        e = np.asarray(h_band.edge_index_list[lvl])
        X_ell = h_ell.X_list[lvl]
        e_ell = np.asarray(h_ell.edge_index_list[lvl])
        d_band = np.linalg.norm(X[e[0]] - X[e[1]], axis=1)
        d_ell = np.linalg.norm(X_ell[e_ell[0]] - X_ell[e_ell[1]], axis=1)
        assert np.isclose(np.sort(d_band), np.sort(d_ell)).all()
