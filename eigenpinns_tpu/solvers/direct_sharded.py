"""Node-sharded direct joint eigen-learning — the distributed production
driver.

The single-device `train_joint` (solvers/direct.py) scaled by N on one
chip; this trainer is its multi-chip form, the north-star training mode
of BASELINE.json: collocation points, eigenvector blocks and the sparse
operators are row-sharded over a `jax.sharding.Mesh`'s "data" axis,
model parameters are replicated, and each training step is ONE jitted
program in which

  * the model forward is embarrassingly row-parallel (GSPMD keeps it
    local to each shard),
  * K U / M U ride the halo-banded sharded SpMM (two (B, k) ppermutes
    between devices + per-shard banded products — parallel/sharded_banded.py),
    with the cluster-split all_gather remainder at 1M-cloud scale,
  * every k x k reduction (Rayleigh numerators/denominators, the
    M-Gram) is a jnp einsum over the sharded node axis that XLA GSPMD
    turns into local partial matmuls + psum over ICI,
  * the loss/grad all-reduce for the replicated parameters is inserted
    by GSPMD from the sharding constraints (no hand-written collectives
    outside the SpMM's ppermutes).

Semantics match `train_joint(mode='penalty')` exactly — the equality is
asserted on an 8-device mesh in tests/test_parallel.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from eigenpinns_tpu.models import JointEigenNet
from eigenpinns_tpu.parallel.mesh import make_mesh
from eigenpinns_tpu.parallel.sharded_banded import (
    ShardedBanded,
    ShardedRemainder,
    _split_decompose,
    build_sharded_operator,
    sharded_banded_spmm,
    sharded_split_spmm,
)
from eigenpinns_tpu.sparse import hdot
from eigenpinns_tpu.train.loop import run_scan_loop


class _State(NamedTuple):
    params: Any
    opt_state: Any


@dataclasses.dataclass
class ShardedDirectResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray      # (n, k) in the CALLER's vertex order
    history: dict
    epochs_run: int
    wall_time: float
    chunk_times: list
    perm: np.ndarray              # internal ordering (diagnostic)
    steady_steps_per_sec: float | None = None  # timing_chunks probe


@dataclasses.dataclass
class ShardedProblem:
    """Host-side preprocessing product: operators sharded and ordered."""

    spmm_K: Any                   # f(U_padded sharded) -> K U
    spmm_M: Any
    m_diag: Any                   # (n_pad,) mass diagonal | None
    mesh: Any
    perm: np.ndarray
    n: int
    n_pad: int
    kind: str                     # 'banded' | 'split'


def _is_diagonal(M) -> bool:
    import scipy.sparse as sp

    M = M.tocsr()
    return (M - sp.diags(M.diagonal())).nnz == 0


def _scale_rows(d, u):
    return d[:, None] * u


def prepare_sharded_problem(K, M, X=None, mesh=None, n_devices=None,
                            dtype=jnp.float32, tile: int = 128,
                            max_bandwidth: int = 4096,
                            window: int = 1024) -> ShardedProblem:
    """Order + shard K and M consistently for an n-device mesh.

    K picks the ordering (RCM if its stencil fits a one-neighbor halo,
    spatial cluster order otherwise); M reuses it so node data lives in
    ONE layout. Diagonal (lumped) mass stays a sharded vector.
    """
    mesh = mesh if mesh is not None else make_mesh(n_devices)
    n_dev = int(mesh.devices.size)
    kind, (coreK, remK), perm = build_sharded_operator(
        K, n_dev, X=X, dtype=dtype, tile=tile,
        max_bandwidth=max_bandwidth, window=window)
    spmm_K = (sharded_banded_spmm(coreK, mesh) if kind == "banded"
              else sharded_split_spmm(coreK, remK, mesh))
    n, n_pad, per = coreK.n, coreK.n_pad, coreK.per

    m_diag = None
    Mp = M.tocsr()[perm][:, perm].tocsr()
    if _is_diagonal(M):
        d = np.zeros(n_pad, dtype=np.float32)
        d[:n] = Mp.diagonal()
        m_diag = d
        spmm_M = None
    elif kind == "banded":
        coreM, _ = ShardedBanded.from_scipy(
            Mp, n_dev, dtype=dtype, tile=tile, reorder=False,
            max_bandwidth=max_bandwidth)
        spmm_M = sharded_banded_spmm(coreM, mesh)
    else:
        core_sp, rem_sp = _split_decompose(Mp, tile, window)
        coreM, _ = ShardedBanded.from_scipy(
            core_sp, n_dev, dtype=dtype, tile=tile, reorder=False,
            max_bandwidth=max_bandwidth)
        remM = (ShardedRemainder.from_scipy(rem_sp, n_dev, per, dtype=dtype)
                if rem_sp.nnz else None)
        spmm_M = sharded_split_spmm(coreM, remM, mesh)

    if spmm_M is None:
        # lumped-mass fast path; a Partial keeps m_diag a traced leaf
        m_diag = jax.device_put(m_diag, NamedSharding(mesh, P("data")))
        spmm_M = jax.tree_util.Partial(_scale_rows, m_diag)

    return ShardedProblem(spmm_K=spmm_K, spmm_M=spmm_M, m_diag=m_diag,
                          mesh=mesh, perm=perm, n=n, n_pad=n_pad, kind=kind)


def train_joint_sharded(
    K,
    M,
    X,
    n_modes: int,
    mesh=None,
    n_devices: int | None = None,
    hidden=(64, 64, 64),
    activation: str = "silu",
    epochs: int = 5000,
    scan_chunk: int = 200,
    lr_start: float = 1e-2,
    lr_end: float = 1e-4,
    w_res: float = 1.0,
    w_orth: float = 1.0,
    w_trace: float = 0.0,
    max_bandwidth: int = 4096,
    window: int = 1024,
    seed: int = 0,
    rayleigh_ritz_finish: bool = True,
    mlp_compute_dtype: str | None = None,
    timing_chunks: int = 0,
    problem: ShardedProblem | None = None,
    checkpoint_dir: str = "",
    checkpoint_every_chunks: int = 10,
    log_fn=None,
    log_every: int = 0,
) -> ShardedDirectResult:
    """Distributed `train_joint(mode='penalty')`: same math, N sharded.

    K, M: scipy sparse (symmetric); X: (n, d) coordinates in the SAME
    row order. Pass a prebuilt `problem` to reuse preprocessing.
    """
    prob = problem if problem is not None else prepare_sharded_problem(
        K, M, X=X, mesh=mesh, n_devices=n_devices,
        max_bandwidth=max_bandwidth, window=window)
    mesh = prob.mesh
    n, n_pad, perm = prob.n, prob.n_pad, prob.perm
    k = n_modes

    X_p = np.zeros((n_pad, np.shape(X)[1]), dtype=np.float32)
    X_p[:n] = np.asarray(X, dtype=np.float32)[perm]
    mask_p = np.zeros((n_pad, 1), dtype=np.float32)
    mask_p[:n] = 1.0

    shard = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    # The operators travel as jit arguments (pytree callables), never as
    # closure constants: a 300k-node band does not fit in an executable.
    data = {
        "X": jax.device_put(jnp.asarray(X_p), shard),
        "mask": jax.device_put(jnp.asarray(mask_p), shard),
        "K": prob.spmm_K,
        "M": prob.spmm_M,
    }

    model = JointEigenNet(tuple(hidden), n_modes, activation=activation,
                          compute_dtype=mlp_compute_dtype)
    params = jax.device_put(
        model.init(jax.random.PRNGKey(seed), jnp.asarray(X_p[:8])), repl)
    schedule = optax.exponential_decay(lr_start, epochs, lr_end / lr_start)
    opt = optax.adam(schedule)
    opt_state = jax.device_put(opt.init(params), repl)

    def predict(params, data):
        U = model.apply(params, data["X"])
        return U * data["mask"]          # zero padded rows everywhere

    def loss_fn(params, data):
        U = predict(params, data)
        Ku = data["K"](U)
        Mu = data["M"](U)
        # GSPMD: the sums over the sharded node axis become local
        # partials + psum between devices.
        lam = jnp.sum(U * Ku, axis=0) / (jnp.sum(U * Mu, axis=0) + 1e-12)
        res = jnp.sum((Ku - Mu * lam[None, :]) ** 2) / (n * k)
        G = hdot(U.T, Mu)
        orth = jnp.sum((G - jnp.eye(k, dtype=U.dtype)) ** 2) / k
        total = w_res * res + w_orth * orth
        if w_trace:
            total = total + w_trace * jnp.mean(lam)
        return total, {"loss": total, "res": res, "orth": orth,
                       "lam_mean": jnp.mean(lam)}

    def step(state: _State, epoch, data):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, data)
        updates, opt_state = opt.update(grads, state.opt_state)
        params = optax.apply_updates(state.params, updates)
        return _State(params, opt_state), metrics

    # Checkpoint/resume: params + opt state (replicated pytrees — the
    # checkpoint is mesh-shape-independent); schedules continue from the
    # restored epoch (same contract as MultigridTrainer).
    ckptr = None
    epoch0 = 0
    if checkpoint_dir:
        from eigenpinns_tpu.train.checkpoint import TrainCheckpointer

        ckptr = TrainCheckpointer(checkpoint_dir)
        prev_step, restored = ckptr.restore_latest(
            target={"params": params, "opt_state": opt_state})
        if restored is not None:
            params = jax.device_put(restored["params"], repl)
            opt_state = jax.device_put(restored["opt_state"], repl)
            epoch0 = int(prev_step)

    # Periodic mid-run checkpoints (multi-hour 300k+ workloads must
    # survive preemption, not just a clean finish): save every
    # `checkpoint_every_chunks` scan chunks from the chunk callback.
    chunk_cb = None
    if ckptr is not None and checkpoint_every_chunks:
        n_chunks_seen = [0]

        def chunk_cb(epochs_run, state):
            n_chunks_seen[0] += 1
            if n_chunks_seen[0] % checkpoint_every_chunks == 0:
                ckptr.save(epoch0 + epochs_run,
                           {"params": state.params,
                            "opt_state": state.opt_state})

    result = run_scan_loop(step, _State(params, opt_state),
                           n_epochs=epochs, chunk=scan_chunk,
                           log_every=log_every, log_fn=log_fn, data=data,
                           start_epoch=epoch0, chunk_callback=chunk_cb,
                           timing_chunks=timing_chunks)
    if ckptr is not None:
        ckptr.save(epoch0 + result.epochs_run,
                   {"params": result.state.params,
                    "opt_state": result.state.opt_state})

    # Finish: Rayleigh-Ritz in the learned subspace, all reductions
    # sharded, only the k x k solve dense.
    U = jax.jit(predict)(result.state.params, data)
    if rayleigh_ritz_finish:
        from eigenpinns_tpu.solvers.rayleigh_ritz import eigh_generalized

        Ku, Mu = prob.spmm_K(U), prob.spmm_M(U)
        A, B = hdot(U.T, Ku), hdot(U.T, Mu)
        w, C = eigh_generalized(0.5 * (A + A.T), 0.5 * (B + B.T),
                                jitter=1e-9)
        lam, U = w[:k], hdot(U, C[:, :k])
    else:
        Ku, Mu = prob.spmm_K(U), prob.spmm_M(U)
        lam = jnp.sum(U * Ku, axis=0) / (jnp.sum(U * Mu, axis=0) + 1e-12)

    U_host = np.asarray(U)[:n]
    out = np.empty_like(U_host)
    out[perm] = U_host                   # back to caller vertex order
    return ShardedDirectResult(
        eigenvalues=np.asarray(lam),
        eigenvectors=out,
        history=result.history,
        epochs_run=result.epochs_run,
        wall_time=result.wall_time,
        chunk_times=result.chunk_times,
        perm=perm,
        steady_steps_per_sec=result.steady_rate,
    )
