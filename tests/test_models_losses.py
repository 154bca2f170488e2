"""Model and loss tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from eigenpinns_tpu.losses import (
    deflation,
    diversity,
    gram_orthogonality,
    newton_schulz_inv_sqrt,
    newton_schulz_orthonormalize,
    normalization,
    ordering,
    projection,
    rayleigh_and_residual,
    smoothness,
    spectral_orthonormalize,
    zero_lambda,
    zero_mean,
)
from eigenpinns_tpu.models import (
    AdaptiveCorrector,
    JointEigenNet,
    LambdaEigenNet,
    ParametricAnsatz,
    SimpleCorrector,
    SpectralCorrector,
    dirichlet_window,
    make_corrector,
)
from eigenpinns_tpu.sparse import as_operator, gcn_normalized_adjacency


def _operators(rng, n=40):
    A = sp.random(n, n, density=0.2,
                  random_state=np.random.RandomState(0))
    K = (A + A.T + 2 * sp.eye(n)).tocsr()
    M = sp.diags(rng.uniform(0.5, 2.0, size=n)).tocsr()
    return as_operator(K), as_operator(M), K, M


def test_simple_corrector_shapes(rng):
    n, k, f = 30, 4, 10
    model = SimpleCorrector((16, 16), k)
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    e = jnp.asarray(np.stack([rng.integers(0, n, 100),
                              rng.integers(0, n, 100)]))
    params = model.init(jax.random.PRNGKey(0), x, e)
    out = model.apply(params, x, e)
    assert out.shape == (n, k)
    # Small output init: corrections start tiny.
    assert float(jnp.abs(out).max()) < 1.0


def test_spectral_corrector(rng):
    n, k, f = 20, 3, 6
    edges = np.stack([rng.integers(0, n, 60), rng.integers(0, n, 60)])
    a_norm = gcn_normalized_adjacency(edges, n)
    model = SpectralCorrector((8,), k)
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), x, a_norm)
    assert model.apply(params, x, a_norm).shape == (n, k)


def test_adaptive_corrector_scales_gradients(rng):
    n, k, f = 15, 2, 4
    model = AdaptiveCorrector((8,), k)
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    e = jnp.asarray(np.stack([rng.integers(0, n, 30),
                              rng.integers(0, n, 30)]))
    params = model.init(jax.random.PRNGKey(0), x, e)
    flat = jax.tree_util.tree_leaves(
        params["params"].get("mode_scales", None)) or [
        params["params"]["mode_scales"]]
    assert np.allclose(np.asarray(flat[0]), 0.01)


def test_make_corrector_validates():
    import pytest

    with pytest.raises(ValueError):
        make_corrector("bogus", [8], 2)


def test_lambda_eigennet(rng):
    model = LambdaEigenNet((16, 16), lambda_init=0.3)
    x = jnp.asarray(rng.normal(size=(25, 3)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(1), x)
    u, lam = model.apply(params, x)
    assert u.shape == (25, 1)
    assert abs(float(lam) - 0.3) < 1e-6
    # lambda is trainable: gradient flows into lambda_raw.
    def loss(p):
        u, lam = model.apply(p, x)
        return (lam - 1.0) ** 2 + jnp.sum(u**2)
    g = jax.grad(loss)(params)
    assert abs(float(g["params"]["lambda_raw"][0])) > 0


def test_parametric_ansatz_boundary_exact(rng):
    model = ParametricAnsatz((8, 8), window=dirichlet_window(0.0, 1.0))
    x = jnp.asarray(np.linspace(0, 1, 11)[:, None].astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), x, 0.5)
    out = model.apply(params, x, jnp.asarray([0.5, 1.5]))
    assert out.shape == (11, 2)
    # Exact Dirichlet: endpoints are zero regardless of weights.
    assert np.allclose(np.asarray(out[0]), 0.0, atol=1e-7)
    assert np.allclose(np.asarray(out[-1]), 0.0, atol=1e-7)


def test_joint_eigennet(rng):
    model = JointEigenNet((16,), n_modes=5)
    x = jnp.asarray(rng.normal(size=(12, 3)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), x)
    assert model.apply(params, x).shape == (12, 5)


def test_losses_reference_semantics(rng):
    Kop, Mop, K, M = _operators(rng)
    n = K.shape[0]
    U = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    lam, res = rayleigh_and_residual(U, Kop, Mop)
    Ud = np.asarray(U, dtype=np.float64)
    lam_ref = np.diag(Ud.T @ K @ Ud) / np.diag(Ud.T @ M @ Ud)
    assert np.allclose(np.asarray(lam), lam_ref, rtol=1e-4)
    res_ref = np.mean((K @ Ud - (M @ Ud) * lam_ref[None, :]) ** 2)
    assert np.isclose(float(res), res_ref, rtol=1e-3)

    G_ref = Ud.T @ M @ Ud
    orth_ref = np.sum((G_ref - np.eye(3)) ** 2) / 3
    assert np.isclose(float(gram_orthogonality(U, Mop)), orth_ref, rtol=1e-3)

    lam_t = jnp.asarray([3.0, 1.0, 2.0])
    assert float(ordering(lam_t)) == 2.0
    assert float(zero_lambda(lam_t)) == 9.0
    assert np.isclose(float(diversity(jnp.asarray([0., 0.1, 0.5]), 0.2)), 0.1,
                      atol=1e-6)


def test_deflation_and_normalization(rng):
    Kop, Mop, K, M = _operators(rng)
    n = K.shape[0]
    u = rng.normal(size=n).astype(np.float32)
    U_prev = rng.normal(size=(n, 2)).astype(np.float32)
    d = float(deflation(jnp.asarray(u), Mop, jnp.asarray(U_prev)))
    d_ref = sum(float(u @ M @ U_prev[:, j]) ** 2 for j in range(2))
    assert np.isclose(d, d_ref, rtol=1e-3)
    nrm = float(normalization(jnp.asarray(u), Mop))
    assert np.isclose(nrm, (u @ M @ u - 1) ** 2, rtol=1e-3)


def test_zero_mean_constant_mode(rng):
    Kop, Mop, K, M = _operators(rng)
    n = K.shape[0]
    U = np.ones((n, 2), dtype=np.float32)
    U[:, 1] = rng.normal(size=n)
    val = float(zero_mean(jnp.asarray(U), Mop))
    ref = float(np.ones(n) @ M @ U[:, 1]) ** 2
    assert np.isclose(val, ref, rtol=1e-3)


def test_newton_schulz_inv_sqrt(rng):
    k = 6
    A = rng.normal(size=(k, k))
    G = (A @ A.T + k * np.eye(k)).astype(np.float32)
    G /= np.linalg.norm(G)  # well-conditioned scale
    Z = np.asarray(newton_schulz_inv_sqrt(jnp.asarray(G), n_iters=12))
    assert np.abs(Z @ G @ Z - np.eye(k)).max() < 1e-2


def test_orthonormalizers_produce_identity_gram(rng):
    Kop, Mop, K, M = _operators(rng)
    n = K.shape[0]
    U = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))
    for fn in (lambda u: newton_schulz_orthonormalize(u, Mop, n_iters=12),
               lambda u: spectral_orthonormalize(u, Mop)):
        Uo = np.asarray(fn(U), dtype=np.float64)
        G = Uo.T @ M @ Uo
        assert np.abs(G - np.eye(4)).max() < 5e-2, fn


def test_whitening_differentiable(rng):
    Kop, Mop, _, _ = _operators(rng)
    U = jnp.asarray(rng.normal(size=(40, 3)).astype(np.float32))

    def f(U):
        return jnp.sum(newton_schulz_orthonormalize(U, Mop) ** 2)

    g = jax.grad(f)(U)
    assert np.isfinite(np.asarray(g)).all()


def test_partial_weight_copy(rng):
    """Re-instantiating a model with a wider input keeps the overlapping
    weights (transfer-learning notebook parity)."""
    import jax

    from eigenpinns_tpu.models import MLP, partial_weight_copy

    old = MLP((8,), 2).init(jax.random.PRNGKey(0), jnp.ones((1, 4)))
    new = MLP((8,), 2).init(jax.random.PRNGKey(1), jnp.ones((1, 6)))
    merged = partial_weight_copy(old, new)
    k_old = np.asarray(old["params"]["hidden_0"]["kernel"])
    k_m = np.asarray(merged["params"]["hidden_0"]["kernel"])
    k_new = np.asarray(new["params"]["hidden_0"]["kernel"])
    assert np.allclose(k_m[:4], k_old)          # overlap copied
    assert np.allclose(k_m[4:], k_new[4:])      # fresh rows retained
    assert np.allclose(np.asarray(merged["params"]["out"]["kernel"]),
                       np.asarray(old["params"]["out"]["kernel"]))


@pytest.mark.slow
def test_mlp_bf16_compute_dtype(rng):
    """compute_dtype='bfloat16' keeps params f32 and output f32, shares
    the param pytree with the f32 model, and stays within bf16 rounding
    of the f32 forward (the 300k training step's matmul lever)."""
    import jax

    from eigenpinns_tpu.models import MLP

    X = jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))
    m32 = MLP((32, 32), 4)
    m16 = MLP((32, 32), 4, compute_dtype="bfloat16")
    params = m32.init(jax.random.PRNGKey(0), X)
    # identical param structure: bf16 model applies f32 params directly
    y32 = m32.apply(params, X)
    y16 = m16.apply(params, X)
    assert y16.dtype == jnp.float32
    assert jax.tree.map(lambda p: p.dtype,
                        m16.init(jax.random.PRNGKey(0), X)) == \
        jax.tree.map(lambda p: p.dtype, params)
    scale = float(jnp.abs(y32).max())
    assert float(jnp.abs(y16 - y32).max()) / scale < 0.05
    # gradients flow (bf16 bwd) and are finite, close in direction
    def loss(m):
        return lambda p: jnp.sum(m.apply(p, X) ** 2)
    g32 = jax.grad(loss(m32))(params)
    g16 = jax.grad(loss(m16))(params)
    flat32 = jnp.concatenate([a.ravel() for a in jax.tree.leaves(g32)])
    flat16 = jnp.concatenate([a.ravel() for a in jax.tree.leaves(g16)])
    cos = jnp.vdot(flat32, flat16) / (
        jnp.linalg.norm(flat32) * jnp.linalg.norm(flat16))
    assert float(cos) > 0.99


def _act(name):
    from eigenpinns_tpu.models import ACTIVATIONS

    return ACTIVATIONS[name]


@pytest.mark.parametrize("activation", ["relu", "silu", "tanh", "sin"])
def test_mlp_apply_is_the_explicit_matmul_chain(activation):
    """models.nn layers: MLP.apply equals x @ W + b per layer with the
    activation between (first-layer omega for sin nets)."""
    from eigenpinns_tpu.models import MLP

    x = jnp.asarray(np.random.default_rng(0).normal(size=(9, 5)),
                    jnp.float32)
    m = MLP((7, 6), 3, activation=activation, first_layer_omega=2.0)
    p = m.init(jax.random.PRNGKey(1), x)["params"]
    h = np.asarray(x, np.float64)
    for i, name in enumerate(["hidden_0", "hidden_1"]):
        h = h @ np.asarray(p[name]["kernel"]) + np.asarray(p[name]["bias"])
        scale = 2.0 if (i == 0 and activation == "sin") else 1.0
        h = np.asarray(_act(activation)(jnp.asarray(scale * h)), np.float64)
    ref = h @ np.asarray(p["out"]["kernel"]) + np.asarray(p["out"]["bias"])
    out = np.asarray(m.apply({"params": p}, x), np.float64)
    assert np.abs(out - ref).max() < 1e-5


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_dense_follows_default_matmul_precision(precision):
    """Dense layers take JAX's default matmul precision (TF32 on the
    H100 unless a caller asks for 'highest'), as the traced HLO shows."""
    from eigenpinns_tpu.models import MLP

    x = jnp.ones((4, 3))
    m = MLP((8,), 2)
    p = m.init(jax.random.PRNGKey(0), x)
    with jax.default_matmul_precision(precision):
        text = jax.jit(m.apply).lower(p, x).as_text()
    assert text.count("dot_general") == 2
    assert ("HIGHEST" in text) == (precision == "highest")


def test_module_parameter_tree_layout():
    """Parameter trees keep flax's layout: Dense leaves kernel (in, out) +
    bias (out,), auto-named children `<Class>_<i>`, explicit names for
    the layers; lecun-normal kernels and zero biases."""
    from eigenpinns_tpu.models import HierarchicalUpscaler

    x = jnp.ones((4, 3))
    e = jnp.asarray(np.array([[0, 1, 2], [1, 2, 3]]))
    p = make_corrector("adaptive", [8, 8], 2).init(
        jax.random.PRNGKey(0), x, e)["params"]
    assert list(p) == ["SimpleCorrector_0", "mode_scales"]
    mlp = p["SimpleCorrector_0"]["MLP_0"]
    assert list(mlp) == ["hidden_0", "hidden_1", "out"]
    assert mlp["hidden_0"]["kernel"].shape == (6, 8)    # concat(x, agg)
    assert mlp["hidden_0"]["bias"].shape == (8,)
    assert not np.any(np.asarray(mlp["hidden_1"]["bias"]))
    assert list(LambdaEigenNet((4,)).init(jax.random.PRNGKey(0), x)[
        "params"]) == ["lambda_raw", "hidden_0", "out"]
    assert list(HierarchicalUpscaler((4,), 6).init(
        jax.random.PRNGKey(0), x[:, 0])["params"]) == ["MLP_0", "lam"]
    from eigenpinns_tpu.models import MLP

    k = MLP((512,), 2).init(jax.random.PRNGKey(3), jnp.ones((1, 400)))[
        "params"]["hidden_0"]["kernel"]
    assert abs(float(jnp.std(k)) - (1 / 400) ** 0.5) < 0.1 * (1 / 400) ** 0.5


def test_module_init_is_deterministic_per_path():
    """Same key -> same parameters; each layer draws its own values."""
    from eigenpinns_tpu.models import MLP

    m = MLP((8, 8), 2)
    a = m.init(jax.random.PRNGKey(0), jnp.ones((1, 8)))["params"]
    b = m.init(jax.random.PRNGKey(0), jnp.ones((1, 8)))["params"]
    assert np.array_equal(a["hidden_1"]["kernel"], b["hidden_1"]["kernel"])
    assert not np.allclose(a["hidden_0"]["kernel"], a["hidden_1"]["kernel"])


def test_dropout_needs_a_key_only_when_active():
    from eigenpinns_tpu.models import MLP

    x = jnp.ones((50, 4))
    m = MLP((64,), 2, dropout=0.5)
    p = m.init(jax.random.PRNGKey(0), x)
    assert np.array_equal(m.apply(p, x), m.apply(p, x, deterministic=True))
    with pytest.raises(ValueError, match="rngs"):
        m.apply(p, x, deterministic=False)
    y1 = m.apply(p, x, deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(1)})
    assert not np.allclose(y1, m.apply(p, x))
