"""Sparse format and op tests against scipy dense references."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from eigenpinns_tpu.sparse import (
    Diagonal,
    SparseELL,
    as_operator,
    block_diag_ell,
    gcn_normalized_adjacency,
    m_gram,
    m_normalize_columns,
    neighbor_mean,
    rayleigh_quotients,
    spmm,
)


def random_sparse(rng, n, m, density=0.05):
    A = sp.random(n, m, density=density, random_state=np.random.RandomState(0))
    return A.tocsr()


def test_ell_roundtrip(rng):
    A = random_sparse(rng, 40, 40)
    E = SparseELL.from_scipy(A)
    assert abs(E.to_scipy() - A).max() < 1e-7


def test_spmm_matches_scipy(rng):
    A = random_sparse(rng, 50, 30)
    E = SparseELL.from_scipy(A)
    U = rng.normal(size=(30, 7)).astype(np.float32)
    out = np.asarray(spmm(E, jnp.asarray(U)))
    ref = A @ U
    assert np.abs(out - ref).max() < 1e-5


def test_diagonal_op(rng):
    d = rng.uniform(1, 2, size=20)
    D = as_operator(sp.diags(d))
    assert isinstance(D, Diagonal)
    U = rng.normal(size=(20, 3)).astype(np.float32)
    assert np.allclose(np.asarray(spmm(D, jnp.asarray(U))), d[:, None] * U,
                       rtol=1e-6)


def test_gram_and_normalize(rng):
    n, k = 30, 4
    M = sp.diags(rng.uniform(0.5, 2, size=n)).tocsr()
    Mop = as_operator(M)
    U = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32))
    G = np.asarray(m_gram(U, Mop))
    ref = np.asarray(U).T @ (M @ np.asarray(U))
    assert np.abs(G - ref).max() < 1e-4
    Un = m_normalize_columns(U, Mop)
    Gn = np.asarray(m_gram(Un, Mop))
    assert np.allclose(np.diag(Gn), 1.0, atol=1e-5)


def test_rayleigh_quotients(rng):
    n = 25
    A = random_sparse(rng, n, n)
    K = (A + A.T).tocsr()
    M = sp.diags(rng.uniform(0.5, 2, size=n)).tocsr()
    U = rng.normal(size=(n, 3)).astype(np.float32)
    lam = np.asarray(
        rayleigh_quotients(jnp.asarray(U), as_operator(K), as_operator(M)))
    Un = np.asarray(U, dtype=np.float64)
    ref = np.diag(Un.T @ (K @ Un)) / np.diag(Un.T @ (M @ Un))
    assert np.abs(lam - ref).max() < 1e-4


def test_block_diag(rng):
    A1 = random_sparse(rng, 10, 10)
    A2 = sp.diags(rng.uniform(1, 2, size=6)).tocsr()
    B = block_diag_ell([as_operator(A1), as_operator(A2)])
    ref = sp.block_diag([A1, A2]).tocsr()
    U = rng.normal(size=(16, 3)).astype(np.float32)
    out = np.asarray(spmm(B, jnp.asarray(U)))
    assert np.abs(out - ref @ U).max() < 1e-5


def test_gcn_adjacency(rng):
    edges = np.array([[0, 1, 1, 2, 2, 0], [1, 0, 2, 1, 0, 2]])
    A = gcn_normalized_adjacency(edges, 4)
    dense = A.to_scipy().toarray()
    # Row/col symmetric, self loops present, isolated node 3 has only itself.
    assert np.allclose(dense, dense.T, atol=1e-6)
    assert dense[3, 3] > 0
    # Known normalization: fully-connected triangle + self loops -> 1/3.
    assert np.allclose(dense[:3, :3], 1 / 3, atol=1e-6)


def test_neighbor_mean(rng):
    # Graph: 0->{1,2}, 1->{0}, node 2 no out-edges (degree clamp).
    edge_index = jnp.asarray(np.array([[0, 0, 1], [1, 2, 0]]))
    x = jnp.asarray(np.array([[1.0], [2.0], [4.0]], dtype=np.float32))
    agg = np.asarray(neighbor_mean(edge_index, x))
    assert np.allclose(agg[:, 0], [3.0, 1.0, 0.0], atol=1e-6)


def test_banded_format_and_spmm(rng):
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BandedELL, banded_spmm

    n = 300
    K = sp.diags([-1.0, -0.5, 2.9, -0.5, -1.0], [-2, -1, 0, 1, 2],
                 shape=(n, n)).tocsr()
    op, perm = BandedELL.from_scipy(K)
    Kp = K[perm][:, perm]
    U = rng.normal(size=(n, 8)).astype(np.float32)
    out = np.asarray(banded_spmm(op, jnp.asarray(U)))
    ref = Kp @ U.astype(np.float64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_banded_spmm_gradient(rng):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BandedELL, banded_spmm

    n = 150
    K = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    op, perm = BandedELL.from_scipy(K)
    Kp = (K[perm][:, perm]).toarray()
    U = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))

    def f(U):
        return jnp.sum(banded_spmm(op, U) ** 2)

    g = np.asarray(jax.grad(f)(U))
    # Analytic: d/dU ||A U||^2 = 2 A^T A U (A symmetric).
    ref = 2 * Kp.T @ (Kp @ np.asarray(U, np.float64))
    assert np.abs(g - ref).max() / np.abs(ref).max() < 1e-4


def test_banded_bandwidth_guard(rng):
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BandedELL

    # A random matrix has O(n) bandwidth even after RCM.
    A = sp.random(600, 600, density=0.02,
                  random_state=np.random.RandomState(0))
    A = (A + A.T).tocsr()
    with pytest.raises(ValueError):
        BandedELL.from_scipy(A, max_bandwidth=64)


def test_banded_nonsymmetric_gradient(rng):
    """Nonsymmetric banded operators backprop through the banded transpose."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BandedELL, banded_spmm

    n = 160
    A = sp.diags([-0.3, 2.0, -1.2], [-1, 0, 1], shape=(n, n)).tocsr()
    op, perm = BandedELL.from_scipy(A, reorder=False)
    assert op.transpose_banded is not None
    Ad = A.toarray()
    U = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))
    out = np.asarray(banded_spmm(op, U))
    assert np.abs(out - Ad @ np.asarray(U, np.float64)).max() < 1e-5

    def f(U):
        return jnp.sum(banded_spmm(op, U) ** 2)

    g = np.asarray(jax.grad(f)(U))
    ref = 2 * Ad.T @ (Ad @ np.asarray(U, np.float64))
    assert np.abs(g - ref).max() / np.abs(ref).max() < 1e-4


def test_split_banded_decomposition():
    """Split operator = banded core + remainder reproduces A exactly and
    differentiates scatter-free."""
    import jax
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import SplitBanded, spmm

    rng = np.random.default_rng(42)
    X = rng.normal(size=(600, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    op, perm = SplitBanded.from_scipy(L, X=X, window=256, n_clusters=6)
    Lp = L.tocsr()[perm][:, perm]
    assert op.remainder is not None
    assert op.remainder_nnz_fraction < 0.5  # clustering keeps it small
    U = jnp.asarray(rng.normal(size=(600, 5)).astype(np.float32))
    out = np.asarray(spmm(op, U))
    ref = Lp @ np.asarray(U, np.float64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    # diagonal agrees
    assert np.abs(np.asarray(op.diagonal()) - Lp.diagonal()).max() < 1e-4
    # gradient: symmetric L -> d||Lu||^2/du = 2 L^T L u
    g = np.asarray(jax.grad(lambda u: jnp.sum(spmm(op, u) ** 2))(U))
    gref = 2 * Lp.T @ (Lp @ np.asarray(U, np.float64))
    assert np.abs(g - gref).max() / np.abs(gref).max() < 1e-4


def test_split_banded_rejects_nonsymmetric():
    """The split path's VJP assumes numeric symmetry — reject anything
    else at build time."""
    import pytest as _pt
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import SplitBanded

    n = 300
    A = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                  np.full(n - 1, -0.5)], [-1, 0, 1]).tocsr()
    with _pt.raises(ValueError, match="symmetric"):
        SplitBanded.from_scipy(A)


def test_banded_spmm_gram_fused(rng):
    """(A@U, U^T A U) matches the dense two-pass form, and its VJP matches
    the analytic gradient."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BandedELL, banded_spmm_gram

    n, k = 300, 8
    K = sp.diags([-1.0, -0.5, 2.9, -0.5, -1.0], [-2, -1, 0, 1, 2],
                 shape=(n, n)).tocsr()
    op, perm = BandedELL.from_scipy(K)
    Kp = (K[perm][:, perm]).toarray()
    U = rng.normal(size=(n, k)).astype(np.float32)
    W_ref = Kp @ np.asarray(U, np.float64)
    G_ref = np.asarray(U, np.float64).T @ W_ref

    W, G = banded_spmm_gram(op, jnp.asarray(U))
    assert np.abs(np.asarray(W) - W_ref).max() / np.abs(W_ref).max() < 1e-5
    assert np.abs(np.asarray(G) - G_ref).max() / np.abs(G_ref).max() < 1e-5

    # VJP: f = sum(W^2) + sum(G^2); df/dU = 2 A^T A U
    #      + 2 [A U G^T + A^T U G]  (A symmetric here).
    def f(U):
        W, G = banded_spmm_gram(op, U)
        return jnp.sum(W**2) + jnp.sum(G**2)

    g = np.asarray(jax.grad(f)(jnp.asarray(U)))
    Uf = np.asarray(U, np.float64)
    ref = 2 * Kp.T @ (Kp @ Uf) + 2 * (Kp @ Uf @ G_ref.T + Kp.T @ Uf @ G_ref)
    assert np.abs(g - ref).max() / np.abs(ref).max() < 1e-4


def test_split_spmm_gram_fused():
    """SplitBanded fused gram (core fused + remainder correction) matches
    the dense two-pass form on a real point-cloud operator."""
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import SplitBanded, split_spmm_gram

    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    op, perm = SplitBanded.from_scipy(L, X=X, window=256, n_clusters=6)
    assert op.remainder is not None  # the test must exercise both parts
    Lp = (L[perm][:, perm]).toarray()
    U = rng.normal(size=(600, 6)).astype(np.float32)
    W_ref = Lp @ np.asarray(U, np.float64)
    G_ref = np.asarray(U, np.float64).T @ W_ref

    W, G = split_spmm_gram(op, jnp.asarray(U))
    assert np.abs(np.asarray(W) - W_ref).max() / np.abs(W_ref).max() < 1e-5
    assert np.abs(np.asarray(G) - G_ref).max() / np.abs(G_ref).max() < 2e-5


def test_rayleigh_residual_orth_matches_two_pass(rng):
    """The fused loss helper agrees with the separate loss terms."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.losses import (
        gram_orthogonality,
        rayleigh_and_residual,
        rayleigh_residual_orth,
    )
    from eigenpinns_tpu.sparse import BandedELL, Diagonal

    n, k = 256, 5
    Ks = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    K, _ = BandedELL.from_scipy(Ks, reorder=False)
    M = Diagonal(jnp.asarray(1.0 + rng.random(n).astype(np.float32)))
    U = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32))

    lam, res = rayleigh_and_residual(U, K, M)
    orth = gram_orthogonality(U, M)
    lam2, res2, orth2 = rayleigh_residual_orth(U, K, M)
    assert np.allclose(np.asarray(lam), np.asarray(lam2), rtol=1e-5)
    assert np.allclose(float(res), float(res2), rtol=1e-5)
    assert np.allclose(float(orth), float(orth2), rtol=1e-5)


def test_rolling_banded_spmm_and_gram(rng):
    """Rolling-window format: SpMM, Gram and diagonal all agree with
    dense; VJP matches the analytic gradient."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import (
        RollingBanded,
        rolling_spmm,
        rolling_spmm_gram,
    )

    n, k = 333, 7   # deliberately not multiples of the tile
    K = sp.diags([-1.0, -0.5, 2.9, -0.5, -1.0], [-2, -1, 0, 1, 2],
                 shape=(n, n)).tocsr()
    op, perm = RollingBanded.from_scipy(K)
    Kp = (K[perm][:, perm]).toarray()
    U = rng.normal(size=(n, k)).astype(np.float32)
    W_ref = Kp @ np.asarray(U, np.float64)
    G_ref = np.asarray(U, np.float64).T @ W_ref

    W = np.asarray(rolling_spmm(op, jnp.asarray(U)))
    assert np.abs(W - W_ref).max() / np.abs(W_ref).max() < 1e-5
    assert np.allclose(np.asarray(op.diagonal()), np.diag(Kp), atol=1e-6)

    Wg, Gg = rolling_spmm_gram(op, jnp.asarray(U))
    assert np.abs(np.asarray(Wg) - W_ref).max() / np.abs(W_ref).max() < 1e-5
    assert np.abs(np.asarray(Gg) - G_ref).max() / np.abs(G_ref).max() < 1e-5

    def f(U):
        W, G = rolling_spmm_gram(op, U)
        return jnp.sum(W**2) + jnp.sum(G**2)

    g = np.asarray(jax.grad(f)(jnp.asarray(U)))
    Uf = np.asarray(U, np.float64)
    ref = 2 * Kp.T @ (Kp @ Uf) + 2 * (Kp @ Uf @ G_ref.T + Kp.T @ Uf @ G_ref)
    assert np.abs(g - ref).max() / np.abs(ref).max() < 1e-4


def test_rolling_banded_nonsymmetric(rng):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import RollingBanded, rolling_spmm

    n = 260
    A = sp.diags([-0.3, 2.0, -1.2], [-1, 0, 1], shape=(n, n)).tocsr()
    op, _ = RollingBanded.from_scipy(A, reorder=False)
    assert op.transpose_rolling is not None
    Ad = A.toarray()
    U = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))
    out = np.asarray(rolling_spmm(op, U))
    assert np.abs(out - Ad @ np.asarray(U, np.float64)).max() < 1e-5

    def f(U):
        return jnp.sum(rolling_spmm(op, U) ** 2)

    g = np.asarray(jax.grad(f)(U))
    ref = 2 * Ad.T @ (Ad @ np.asarray(U, np.float64))
    assert np.abs(g - ref).max() / np.abs(ref).max() < 1e-4


def test_rolling_banded_real_operator(rng):
    """On a real point-cloud Laplacian (RCM-reordered), rolling == dense."""
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import RollingBanded, rolling_spmm_gram

    r2 = np.random.default_rng(7)
    X = r2.normal(size=(500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    op, perm = RollingBanded.from_scipy(L)
    Lp = (L[perm][:, perm]).toarray()
    U = r2.normal(size=(500, 6)).astype(np.float32)
    W_ref = Lp @ np.asarray(U, np.float64)
    G_ref = np.asarray(U, np.float64).T @ W_ref
    W, G = rolling_spmm_gram(op, jnp.asarray(U))
    assert np.abs(np.asarray(W) - W_ref).max() / np.abs(W_ref).max() < 2e-5
    assert np.abs(np.asarray(G) - G_ref).max() / np.abs(G_ref).max() < 2e-5


def test_bsr_strip_spmm_and_gram(rng):
    """Strip-BSR == dense on a random symmetric operator, plus VJP."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BSRTile, bsr_spmm, bsr_spmm_gram

    n = 700
    A = sp.random(n, n, density=0.01, random_state=1, format="csr")
    A = A + A.T + sp.diags(np.ones(n) * 2.0)
    op, perm = BSRTile.from_scipy(A)
    Ap = A.tocsr()[perm][:, perm]
    U = jnp.asarray(np.random.default_rng(0).normal(
        size=(n, 5)).astype(np.float32))
    W_ref = Ap @ np.asarray(U, np.float64)

    W, G = jax.jit(bsr_spmm_gram)(op, U)
    assert np.abs(np.asarray(W) - W_ref).max() < 1e-4
    assert (np.abs(np.asarray(G) - np.asarray(U, np.float64).T @ W_ref).max()
            < 5e-3)
    # Symmetric VJP: d/dU sum(sin(A U)) = A^T cos(A U).
    g = jax.grad(lambda u: jnp.sum(jnp.sin(bsr_spmm(op, u))))(U)
    assert np.abs(np.asarray(g) - Ap.T @ np.cos(W_ref)).max() < 1e-4
    assert np.abs(np.asarray(op.diagonal()) - Ap.diagonal()).max() < 1e-6


def test_bsr_nonsymmetric_transpose(rng):
    """Nonsymmetric operators carry an explicit transpose for the VJP."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from eigenpinns_tpu.sparse import BSRTile, bsr_spmm

    n = 500
    B = (sp.random(n, n, density=0.01, random_state=2, format="csr")
         + sp.diags(np.ones(n)))
    op, perm = BSRTile.from_scipy(B)
    assert op.transpose_bsr is not None
    Bp = B.tocsr()[perm][:, perm]
    U = jnp.asarray(np.random.default_rng(1).normal(
        size=(n, 4)).astype(np.float32))
    W = bsr_spmm(op, U)
    assert np.abs(np.asarray(W) - Bp @ np.asarray(U)).max() < 1e-4
    g = jax.grad(lambda u: jnp.sum(jnp.sin(bsr_spmm(op, u))))(U)
    g_ref = Bp.T @ np.cos(Bp @ np.asarray(U))
    assert np.abs(np.asarray(g) - g_ref).max() < 1e-4


def test_bsr_real_operator_matches_rolling(rng):
    """On a real point-cloud Laplacian the BSR and rolling formats agree
    (cross-format check in the ORIGINAL vertex order)."""
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import (BSRTile, RollingBanded, bsr_spmm,
                                       rolling_spmm)

    r2 = np.random.default_rng(7)
    X = r2.normal(size=(500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    U = r2.normal(size=(500, 6)).astype(np.float32)
    opb, pb = BSRTile.from_scipy(L)
    opr, pr = RollingBanded.from_scipy(L)
    invb = np.argsort(pb)
    invr = np.argsort(pr)
    Wb = np.asarray(bsr_spmm(opb, jnp.asarray(U[pb])))[invb]
    Wr = np.asarray(rolling_spmm(opr, jnp.asarray(U[pr])))[invr]
    assert np.abs(Wb - Wr).max() / np.abs(Wr).max() < 2e-5


def test_bf16_stored_operator_mode(rng):
    """with_precision('bf16') matmuls a bf16-ROUNDED operator exactly
    (training-loss-only precision: half the band bytes)."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import BSRTile, RollingBanded, spmm

    r2 = np.random.default_rng(3)
    X = r2.normal(size=(600, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    U = jnp.asarray(r2.normal(size=(600, 5)).astype(np.float32))
    for cls in (RollingBanded, BSRTile):
        op, p = cls.from_scipy(L)
        Lp = L.tocsr()[p][:, p]
        Lb = Lp.copy()
        Lb.data = Lb.data.astype(ml_dtypes.bfloat16).astype(np.float64)
        ref = Lb @ np.asarray(U, np.float64)
        opb = op.with_precision("bf16")
        W = np.asarray(spmm(opb, U))
        assert np.abs(W - ref).max() / np.abs(ref).max() < 2e-3
        g = jax.grad(lambda u: jnp.sum(jnp.sin(spmm(opb, u))))(U)
        gref = Lb.T @ np.cos(ref)
        assert np.abs(np.asarray(g) - gref).max() / np.abs(gref).max() < 2e-3
        # Rounding is bounded: vs the EXACT operator the product is
        # within bf16 mantissa error.
        exact = Lp @ np.asarray(U, np.float64)
        assert np.abs(W - exact).max() / np.abs(exact).max() < 2e-2


def test_precision_roundtrip_upcasts_band(rng):
    """with_precision('highest') on a bf16-STORED operator restores f32
    storage (the values keep their bf16 rounding; keeping the f32
    original around is still the documented solver-grade pattern)."""
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import BSRTile, RollingBanded, spmm

    r2 = np.random.default_rng(5)
    X = r2.normal(size=(400, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    U = jnp.asarray(r2.normal(size=(400, 4)).astype(np.float32))
    for cls in (RollingBanded, BSRTile):
        op, p = cls.from_scipy(L)
        opb = op.with_precision("bf16")
        oph = opb.with_precision("highest")
        stored = oph.band if cls is RollingBanded else oph.data
        assert stored.dtype == jnp.float32
        # And the product equals the bf16-rounded operator's (the
        # upcast cannot recover dropped mantissa bits, only the dtype).
        Wb = np.asarray(spmm(opb, U))
        Wh = np.asarray(spmm(oph, U))
        assert np.abs(Wb - Wh).max() / np.abs(Wb).max() < 2e-3


def test_function_operator_dispatch(rng):
    """FunctionOperator routes any callable through spmm()/diagonal() —
    the hook that lets sharded SpMM closures flow into solver code."""
    import jax.numpy as jnp

    from eigenpinns_tpu.sparse import spmm, spmv
    from eigenpinns_tpu.sparse.ops import FunctionOperator

    d = jnp.asarray(rng.uniform(1, 2, size=16).astype(np.float32))
    op = FunctionOperator(lambda U: 3.0 * U, d)
    U = jnp.asarray(rng.normal(size=(16, 4)).astype(np.float32))
    assert np.allclose(np.asarray(spmm(op, U)), 3.0 * np.asarray(U))
    assert np.allclose(np.asarray(spmv(op, U[:, 0])),
                       3.0 * np.asarray(U[:, 0]))
    assert np.allclose(np.asarray(op.diagonal()), np.asarray(d))
    assert op.shape == (16, 16)
    # Pytree round-trip: diag is the traced leaf, fn rides the treedef.
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(op)
    assert len(leaves) == 1
    op2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert np.allclose(np.asarray(spmm(op2, U)), 3.0 * np.asarray(U))


def test_hilbert_order_locality_and_validity(rng):
    """hilbert_order is a valid permutation whose kNN index spread is far
    tighter than the input ordering's on a surface cloud — the property
    the split-banded training operator's small-window core relies on."""
    from eigenpinns_tpu.sampling import knn_graph
    from eigenpinns_tpu.sparse import hilbert_order

    n = 4000
    X = rng.normal(size=(n, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    perm = hilbert_order(X)
    assert sorted(perm.tolist()) == list(range(n))  # valid permutation

    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rows, cols = knn_graph(X, 8)
    spread_before = np.abs(cols - rows)
    spread_after = np.abs(inv[cols] - inv[rows])
    assert np.median(spread_after) < np.median(spread_before) / 10
    assert np.median(spread_after) < 64


def test_split_banded_hilbert_and_explicit_order():
    """order='hilbert' and an explicit permutation reproduce A exactly,
    and hilbert's remainder stays a small fraction of the nnz at a small
    window. (A locally seeded rng: with the session-shared fixture the
    draw depended on test order, and the old hilbert-vs-cluster near-tie
    comparison failed for some draws. Exactness and the
    explicit-order round-trip are the valuable assertions; the
    comparative one was a property of the draw, not of the code.)"""
    import jax.numpy as jnp

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import SplitBanded, hilbert_order, spmm

    rng = np.random.default_rng(20240818)
    X = rng.normal(size=(900, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    U = rng.normal(size=(900, 5)).astype(np.float32)

    op_h, perm_h = SplitBanded.from_scipy(L, X=X, window=128,
                                          order="hilbert")
    Lp = L.tocsr()[perm_h][:, perm_h]
    ref = Lp @ np.asarray(U, np.float64)
    out = np.asarray(spmm(op_h, jnp.asarray(U)))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5

    # explicit permutation array round-trips identically
    op_e, perm_e = SplitBanded.from_scipy(L, X=X, window=128,
                                          order=hilbert_order(X))
    assert np.array_equal(perm_h, perm_e)
    out_e = np.asarray(spmm(op_e, jnp.asarray(U)))
    assert np.array_equal(out, out_e)

    # Hilbert ordering keeps most of the nnz inside the small window —
    # an absolute bound, not a near-tie comparison against another
    # ordering (that comparison was draw-dependent).
    assert op_h.remainder_nnz_fraction < 0.5

    import pytest as _pt
    with _pt.raises(ValueError, match="unknown order"):
        SplitBanded.from_scipy(L, X=X, order="zorder")
    with _pt.raises(ValueError, match="explicit order"):
        SplitBanded.from_scipy(L, X=X, order=np.arange(10))


def test_split_banded_bf16_core_f32_remainder(rng):
    """dtype=bfloat16 stores only the core band in bf16 (the remainder
    stays f32), and spmm matches the mixed-precision reference."""
    import jax.numpy as jnp
    import ml_dtypes

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import SplitBanded, spmm

    X = rng.normal(size=(700, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    op, perm = SplitBanded.from_scipy(L, X=X, window=128, order="hilbert",
                                      dtype=jnp.bfloat16)
    assert op.core.band.dtype == jnp.bfloat16
    assert op.remainder is not None
    assert op.remainder.values.dtype == jnp.float32

    # Mixed reference built from the op itself: densify the bf16 core
    # band (rounded values) + the f32 remainder.
    n = op.n
    band = np.asarray(op.core.band, np.float64)[:n]
    starts = np.asarray(op.core.starts)
    dense = np.zeros((n, n))
    for i in range(n):
        s = int(starts[i // op.core.tile])
        w = min(band.shape[1], n - s)
        dense[i, s:s + w] = band[i, :w]
    rem = op.remainder.to_scipy().toarray().astype(np.float64)
    U = rng.normal(size=(700, 5)).astype(np.float32)
    out = np.asarray(spmm(op, jnp.asarray(U)), np.float64)
    ref = (dense + rem) @ np.asarray(U, np.float64)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() / scale < 2e-3
    # and the mixed op is itself close to the exact operator
    Lp = L.tocsr()[perm][:, perm].toarray()
    assert np.abs(dense + rem - Lp).max() / np.abs(Lp).max() < 1e-2


def _format_problem(symmetric: bool):
    """A 600-point cloud Laplacian; the nonsymmetric variant adds an
    asymmetric tridiagonal perturbation inside the same locality."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian

    r = np.random.default_rng(11)
    X = r.normal(size=(600, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = point_cloud_laplacian(X, n_neighbors=12)
    A = L.tocsr()
    if not symmetric:
        n = A.shape[0]
        A = (A + sp.diags([np.full(n - 1, 0.3), np.full(n - 1, -0.7)],
                          [-1, 1])).tocsr()
    return A, X


def _build_format(fmt: str, A, X):
    from eigenpinns_tpu.sparse import (BandedELL, BSRTile, RollingBanded,
                                       SplitBanded)

    if fmt == "ell":
        return SparseELL.from_scipy(A), np.arange(A.shape[0])
    if fmt == "banded":
        return BandedELL.from_scipy(A)
    if fmt == "rolling":
        return RollingBanded.from_scipy(A)
    if fmt == "bsr":
        return BSRTile.from_scipy(A)
    return SplitBanded.from_scipy(A, X=X, window=256, n_clusters=6)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("k", [1, 20, 128])
@pytest.mark.parametrize("fmt", ["ell", "banded", "rolling", "bsr", "split"])
def test_format_products_match_scipy(fmt, k, symmetric):
    """Every operator format's forward A@U, VJP A^T g and Gram U^T A U
    against scipy in float64 (the split format rejects nonsymmetric
    operators at build time)."""
    import jax

    from eigenpinns_tpu.sparse import spmm_gram

    A, X = _format_problem(symmetric)
    if fmt == "split" and not symmetric:
        with pytest.raises(ValueError, match="symmetric"):
            _build_format(fmt, A, X)
        return
    op, perm = _build_format(fmt, A, X)
    Ap = A[perm][:, perm].tocsr()
    r = np.random.default_rng(k)
    U = r.normal(size=(A.shape[0], k)).astype(np.float32)
    G = r.normal(size=(A.shape[0], k)).astype(np.float32)

    @jax.jit
    def products(op, U, G):
        (W, gram), vjp = jax.vjp(lambda u: spmm_gram(op, u), U)
        return W, gram, vjp((G, jnp.zeros((k, k), U.dtype)))[0]

    W, gram, dU = products(op, jnp.asarray(U), jnp.asarray(G))
    U64, G64 = U.astype(np.float64), G.astype(np.float64)
    W_ref = Ap @ U64
    for got, ref in ((W, W_ref), (gram, U64.T @ W_ref), (dU, Ap.T @ G64)):
        got = np.asarray(got, np.float64)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_operator_dot_precision_names(precision):
    """Each precision name multiplies in f32 (on the CPU every name is
    full f32 arithmetic; 'bf16' differs only by its stored operand)."""
    from eigenpinns_tpu.sparse import operator_dot

    r = np.random.default_rng(0)
    a = r.normal(size=(64, 96)).astype(np.float32)
    b = r.normal(size=(96, 8)).astype(np.float32)
    a_stored = (jnp.asarray(a, jnp.bfloat16) if precision == "bf16"
                else jnp.asarray(a))
    out = operator_dot(a_stored, jnp.asarray(b), precision)
    assert out.dtype == jnp.float32
    ref = np.asarray(a_stored, np.float64) @ b.astype(np.float64)
    assert np.abs(np.asarray(out) - ref).max() / np.abs(ref).max() < 1e-6


def test_operator_dot_rejects_unknown_precision():
    from eigenpinns_tpu.sparse import operator_dot

    with pytest.raises(KeyError):
        operator_dot(jnp.ones((2, 2)), jnp.ones((2, 2)), "bf16x3")


def test_bsr_spmm_hbm_bytes_counts_strips_gathers_and_result():
    from eigenpinns_tpu.sparse import BSRTile
    from eigenpinns_tpu.sparse.bsr import bsr_spmm_hbm_bytes

    A, _ = _format_problem(True)
    op, _ = BSRTile.from_scipy(A, chunk=4)
    k = 20
    expect = (op.data.size * 4 + op.n_chunks * 4 * 128 * k * 4
              + A.shape[0] * k * 4)
    assert bsr_spmm_hbm_bytes(op, k) == expect
    assert bsr_spmm_hbm_bytes(op, k, rhs_itemsize=2) < expect
