"""Batched eigen-learning over a mesh family (vmap over operators).

The BASELINE.json stretch configuration calls for a spectral basis
"batched over a mesh family". In JAX that is a vmap: stack the
family's operators (padded to a common ELL shape), hold one set of
network parameters PER MESH, and train every mesh simultaneously in a
single fused program — the device sees one batched matmul instead of F
sequential small ones.

Constraints: diagonal (lumped) mass matrices; meshes padded to the
largest member (padded rows carry zero stiffness / unit mass and decay
to zero under the normalization losses — keep family sizes within ~2x
for efficiency).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from eigenpinns_tpu.models import JointEigenNet
from eigenpinns_tpu.train.loop import run_scan_loop


@dataclasses.dataclass
class BatchedResult:
    eigenvalues: np.ndarray   # (F, k)
    eigenvectors: np.ndarray  # (F, N_pad, k) — rows beyond each mesh's n
                              # are padding
    sizes: list
    history: dict


def _pack_family(K_list, M_list, X_list, dtype=np.float32):
    """Stack scipy operators into common-shape ELL arrays."""
    sizes = [K.shape[0] for K in K_list]
    N = max(sizes)
    W = 0
    packed = []
    for K in K_list:
        K = K.tocsr()
        K.sum_duplicates()
        W = max(W, int(np.diff(K.indptr).max()))
        packed.append(K)
    W = ((W + 7) // 8) * 8
    F = len(K_list)
    idx = np.zeros((F, N, W), np.int32)
    val = np.zeros((F, N, W), dtype)
    mdiag = np.ones((F, N), dtype)          # unit mass on padding
    mask = np.zeros((F, N), dtype)
    X = np.zeros((F, N, X_list[0].shape[1]), dtype)
    for f, (K, M, Xf) in enumerate(zip(packed, M_list, X_list)):
        n = K.shape[0]
        mask[f, :n] = 1.0
        deg = np.diff(K.indptr)
        rows = np.repeat(np.arange(n), deg)
        pos = np.arange(K.nnz) - np.repeat(K.indptr[:-1], deg)
        idx[f, rows, pos] = K.indices
        val[f, rows, pos] = K.data
        mdiag[f, :n] = M.diagonal()
        X[f, :n] = Xf
    return (jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mdiag),
            jnp.asarray(mask), jnp.asarray(X), sizes)


def train_joint_family(
    K_list,
    M_list,
    X_list,
    n_modes: int,
    hidden=(64, 64, 64),
    epochs: int = 3000,
    scan_chunk: int = 200,
    lr_start: float = 5e-3,
    lr_end: float = 1e-4,
    w_res: float = 1.0,
    w_orth: float = 10.0,
    w_trace: float = 0.5,   # pulls the learned subspace to the BOTTOM of
                            # the spectrum - without it the residual loss
                            # is satisfied by ANY eigenvectors
    seed: int = 0,
    rayleigh_ritz_finish: bool = True,
    polish_iters: int = 0,
    polish_tol: float = 1e-6,
) -> BatchedResult:
    """Jointly learn the lowest n_modes of every mesh in the family."""
    idx, val, mdiag, mask, X, sizes = _pack_family(K_list, M_list, X_list)
    F, N, W = idx.shape
    k = n_modes

    model = JointEigenNet(tuple(hidden), k)
    keys = jax.random.split(jax.random.PRNGKey(seed), F)
    params = jax.vmap(model.init)(keys, X)   # stacked per-mesh params
    schedule = optax.exponential_decay(lr_start, epochs, lr_end / lr_start)
    opt = optax.adam(schedule)
    opt_state = opt.init(params)

    def loss_single(p, idx, val, mdiag, mask, X):
        # Padded rows are masked out of U entirely: they contribute
        # nothing to residual, Rayleigh quotients or the Gram.
        U = model.apply(p, X) * mask[:, None]
        Ku = jnp.einsum("nwk,nw->nk", U[idx], val,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32).astype(U.dtype)
        Mu = mdiag[:, None] * U
        lam = jnp.sum(U * Ku, axis=0) / (jnp.sum(U * Mu, axis=0) + 1e-12)
        res = jnp.mean((Ku - Mu * lam[None, :]) ** 2)
        G = jnp.dot(U.T, Mu, precision=jax.lax.Precision.HIGHEST)
        orth = jnp.sum((G - jnp.eye(k)) ** 2) / k
        return w_res * res + w_orth * orth + w_trace * jnp.mean(lam)

    def loss_fn(params, data):
        idx, val, mdiag, mask, X = data
        per_mesh = jax.vmap(loss_single)(params, idx, val, mdiag, mask, X)
        return jnp.sum(per_mesh), per_mesh

    def step(state, epoch, data):
        params, opt_state = state
        (total, per_mesh), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, data)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), {"loss": total,
                                     "loss_max_mesh": jnp.max(per_mesh)}

    result = run_scan_loop(step, (params, opt_state), n_epochs=epochs,
                           chunk=scan_chunk,
                           data=(idx, val, mdiag, mask, X))
    params = result.state[0]

    U = jax.vmap(model.apply)(params, X)     # (F, N, k)
    lam_out = np.zeros((F, k))
    U_out = np.array(U)  # writable copy
    if rayleigh_ritz_finish:
        from eigenpinns_tpu.solvers.rayleigh_ritz import rayleigh_ritz_robust
        from eigenpinns_tpu.sparse import as_operator

        for f in range(F):
            n = sizes[f]
            w, Uf = rayleigh_ritz_robust(
                jnp.asarray(U_out[f, :n]), as_operator(K_list[f]),
                as_operator(M_list[f]))
            lam_out[f] = np.asarray(w[:k])
            U_out[f, :n] = np.asarray(Uf[:, :k])
    if polish_iters:
        # Per-mesh LOBPCG polish from the learned subspace — the same
        # solver-grade finish the single-mesh drivers use
        # (solvers/multigrid.py polish_iters). One compile per distinct
        # mesh size.
        from eigenpinns_tpu.solvers.lobpcg import lobpcg
        from eigenpinns_tpu.sparse import as_operator

        for f in range(F):
            n = sizes[f]
            res_f = lobpcg(as_operator(K_list[f]), as_operator(M_list[f]),
                           jnp.asarray(U_out[f, :n]), k=k,
                           max_iter=polish_iters, tol=polish_tol)
            lam_out[f] = np.asarray(res_f.eigenvalues)
            U_out[f, :n] = np.asarray(res_f.eigenvectors)
    return BatchedResult(lam_out, U_out, sizes, result.history)
