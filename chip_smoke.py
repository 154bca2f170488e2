"""Smoke test of eigenpinns on an NVIDIA GPU, at real sizes, in one process.

    python chip_smoke.py            # one card: phases 1-3
    python chip_smoke.py --multi    # four cards: phase 4 only

Phases (each raises on the first failed check; nothing is caught):

  1. The main path through the CLI (`eigenpinns_tpu.main.cli`) at bunny
     width: a seeded bumpy icosphere (2,562 vertices), the bench's
     multigrid configuration, for operator_format 'ell' and 'auto'. The
     eigenvalues of the exported eigenvectors are checked against host
     eigsh in float64.
  2. Every operator format on a 300k-point seeded cloud at k=20 and
     k=128: forward A@U, VJP A^T g and Gram U^T A U against scipy CSR in
     float64, per precision name.
  3. `train_joint` on the 300k cloud at the bench's width, then one LOBPCG
     polish at Precision.HIGHEST, refereed on the host in float64.
  4. (--multi) `train_joint_sharded`, `lobpcg_sharded` and the sharded
     `MultigridTrainer` on a flat 4-device mesh at the 300k size, each
     against its single-device run.

Without a GPU the script exits non-zero and prints no result. The last
line of stdout is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The phase functions take their sizes as arguments so the CPU tests can
rehearse them small (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

from bench import card_line, make_cloud

# Phase 1: the polish runs in f32 at HIGHEST; 1e-3 allows for the TF32
# training loss on the card without hiding a broken path (a wrong
# operator, ordering or export is off by O(1)).
EIG_TOL = 1e-3
# Phase 2, relative Frobenius error against scipy float64:
OP_TOL = {
    # full f32 products: f32 rounding of the result and the summation.
    "highest": 1e-5,
    # Precision.HIGH runs on the TF32 tensor cores (10-bit mantissa,
    # ~1e-3 relative per product).
    "high": 2e-3,
    # operator stored in bf16 (8-bit mantissa, 2^-9 relative rounding of
    # every entry) times a TF32 product.
    "bf16": 2e-2,
}
# Phase 3: a polished block is M-orthonormal to f32 Gram accuracy.
ORTH_TOL = 1e-4
# Phase 4, sharded against single-device: both runs take the same steps
# from the same seed, but their reductions run in a different order and
# the MLP matmuls round (TF32), so the trajectories drift apart by
# rounding. A wrong shard, halo or psum is off by O(1).
TRAJ_TOL = 5e-2      # relative loss difference, every epoch
EIGVAL_TOL = 1e-2    # relative eigenvalue difference, modes 1+
# The multigrid comparison runs both trainers in full f32 and compares
# the first 20 epochs. Its ReLU corrector under Adam amplifies rounding
# by orders of magnitude from one epoch to the next once training gets
# going: on four CPU devices at 50k nodes in f32 the two runs agree to
# 1.2e-7 in loss for 35 epochs, then part by 0.17 by epoch 49; with TF32
# matmuls they part sooner. Within 20 epochs at full f32 a wrong shard,
# halo or psum is the only way to miss the tight bounds below.
MG_PRECISION = "highest"
MG_TRAJ_TOL = 1e-3   # relative loss difference, every epoch

# The bench's bunny multigrid configuration (bench.py phase_bunny).
BENCH_MG = {"n_modes": 10, "hierarchy": [128, 512, 1024],
            "hidden_layers": [256] * 6, "epochs": 2000, "scan_chunk": 500,
            "corrector_scale": 10.0, "weight_residual": 1000.0,
            "weight_orthogonal": 10.0, "log_every": 0,
            "early_stop_patience": 10 ** 9, "plateau_patience": 2000,
            "polish_iters": 100}


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"smoke check failed: {what}")


def rel_frob(x, ref) -> float:
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def peak_bytes(device) -> int:
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", 0))


def fmt(a) -> str:
    return np.array2string(np.asarray(a), max_line_width=10 ** 4,
                           formatter={"float_kind": lambda v: f"{v:.3e}"})


def rayleigh(U, K, M) -> np.ndarray:
    U = np.asarray(U, np.float64)
    return np.sum(U * (K @ U), 0) / np.sum(U * (M @ U), 0)


def bumpy_sphere(subdivisions: int):
    """Icosphere displaced radially by 1 + 0.3 sin(3 theta) sin(2 phi),
    the surface bench.make_cloud samples."""
    from eigenpinns_tpu.geometry.mesh import TriMesh
    from eigenpinns_tpu.utils import icosphere

    v, f = icosphere(subdivisions)
    theta = np.arctan2(v[:, 1], v[:, 0])
    phi = np.arccos(np.clip(v[:, 2], -1.0, 1.0))
    r = 1.0 + 0.3 * np.sin(3 * theta) * np.sin(2 * phi)
    return TriMesh(v * r[:, None], f)


def cloud_problem(n: int, seed: int = 0):
    """(X, L, M): the bench's seeded 300k-style cloud and its Laplacian."""
    from eigenpinns_tpu.geometry import point_cloud_laplacian

    t0 = time.time()
    X = make_cloud(n, seed)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    log(f"[cloud] n={n} nnz={L.nnz} laplacian {time.time()-t0:.1f}s")
    return X, L.tocsr(), M.tocsr()


# ---------------------------------------------------------------------------
# phase 1: the CLI at bunny width
# ---------------------------------------------------------------------------


def phase_cli(out_dir: str, subdivisions: int = 4, config: dict = BENCH_MG,
              formats=("ell", "auto"), tol: float = EIG_TOL) -> dict:
    from eigenpinns_tpu.configs import Config
    from eigenpinns_tpu.geometry import load_mesh, point_cloud_laplacian
    from eigenpinns_tpu.geometry.mesh import save_obj
    from eigenpinns_tpu.io.vtu import read_vtu
    from eigenpinns_tpu.main import cli
    from eigenpinns_tpu.solvers.oracle import eigsh_smallest

    os.makedirs(out_dir, exist_ok=True)
    obj = os.path.join(out_dir, "bumpy_sphere.obj")
    save_obj(obj, bumpy_sphere(subdivisions))
    # The CLI's finest level is the whole normalized mesh in file order.
    mesh = load_mesh(obj, normalize=True)
    k = config["n_modes"]
    L, M = point_cloud_laplacian(mesh.verts,
                                 n_neighbors=Config().pc_neighbors)
    vals, _ = eigsh_smallest(L, M, k)
    out = {}
    for fmt in formats:
        vtu = os.path.join(out_dir, f"smoke_{fmt}.vtu")
        if os.path.exists(vtu):
            os.remove(vtu)
        args = [f"{key}={val!r}" for key, val in config.items()]
        args += [f"mesh_file={obj}", f"vtu_file={vtu}", "diagnostics_viz=",
                 f"operator_format={fmt}"]
        t0 = time.time()
        cli(["--override", *args])
        wall = time.time() - t0
        check(os.path.exists(vtu), f"{fmt}: VTU {vtu} written")
        _, _, pdata = read_vtu(vtu)
        U = np.stack([pdata[f"v{i}"] for i in range(k)], 1)
        lam = np.sort(rayleigh(U, L, M))
        rel = np.abs(lam[1:] - vals[1:]) / np.abs(vals[1:])
        log(f"[phase1] operator_format={fmt}: {mesh.n_verts} verts, "
            f"max rel eigenvalue err (modes 1..{k-1}) {rel.max():.3e} "
            f"(tol {tol:g}), CLI wall {wall:.1f}s")
        check(np.isfinite(rel).all() and rel.max() <= tol,
              f"{fmt}: eigenvalue error {rel.max():.3e} > {tol:g}")
        out[fmt] = float(rel.max())
    return out


# ---------------------------------------------------------------------------
# phase 2: every operator format against scipy float64
# ---------------------------------------------------------------------------


def build_formats(L, X, max_bandwidth: int = 8192):
    """{name: (operator, perm)} for every operator format."""
    from eigenpinns_tpu.sparse import (
        BandedELL,
        BSRTile,
        RollingBanded,
        SparseELL,
        SplitBanded,
    )

    builders = {
        "ell": lambda: (SparseELL.from_scipy(L), np.arange(L.shape[0])),
        "rolling": lambda: RollingBanded.from_scipy(
            L, max_bandwidth=max_bandwidth),
        "bsr": lambda: BSRTile.from_scipy(L),
        "banded": lambda: BandedELL.from_scipy(
            L, max_bandwidth=max_bandwidth),
        "split": lambda: SplitBanded.from_scipy(L, X=X),
    }
    out = {}
    for name, build in builders.items():
        t0 = time.time()
        out[name] = build()
        log(f"[phase2] built {name} in {time.time()-t0:.1f}s")
    return out


def phase_operators(L, X, ks=(20, 128), seed: int = 0,
                    max_bandwidth: int = 8192) -> dict:
    import jax

    from eigenpinns_tpu.sparse import spmm, spmm_gram

    @jax.jit
    def products(op, U, G):
        W, gram = spmm_gram(op, U)
        _, vjp = jax.vjp(lambda u: spmm(op, u), U)
        return W, vjp(G)[0], gram

    rng = np.random.default_rng(seed)
    results = {}
    formats = build_formats(L, X, max_bandwidth)
    for name in list(formats):
        op, perm = formats.pop(name)
        Lp = L[perm][:, perm].tocsr()
        precisions = (("highest", "high", "bf16")
                      if hasattr(op, "with_precision") else ("highest",))
        for prec in precisions:
            op_p = op.with_precision(prec) if prec != "highest" else op
            for k in ks:
                U = rng.normal(size=(L.shape[0], k)).astype(np.float32)
                G = rng.normal(size=(L.shape[0], k)).astype(np.float32)
                U64, G64 = U.astype(np.float64), G.astype(np.float64)
                W_ref = Lp @ U64
                refs = (W_ref, Lp.T @ G64, U64.T @ W_ref)
                got = jax.block_until_ready(products(op_p, U, G))
                errs = [rel_frob(g, r) for g, r in zip(got, refs)]
                tol = OP_TOL[prec]
                log(f"[phase2] {name:8s} {prec:8s} k={k:4d}: rel frob err "
                    f"A@U {errs[0]:.2e}  A^T g {errs[1]:.2e}  "
                    f"U^T A U {errs[2]:.2e} (tol {tol:g})")
                check(all(np.isfinite(e) and e <= tol for e in errs),
                      f"{name} {prec} k={k}: errors {errs} > {tol:g}")
                results[f"{name}/{prec}/k{k}"] = errs
            del op_p
        del op
        gc.collect()
    return results


# ---------------------------------------------------------------------------
# phase 3: train_joint at the bench's width, then one LOBPCG polish
# ---------------------------------------------------------------------------


def residual_referee(U, Kp, Mp):
    """(lam, per-mode ||Ku - lam Mu|| / (|lam| ||Mu||), M-orth defect),
    on the host in float64, modes sorted by lam. The constant mode of a
    closed surface has lam ~ 0, so its residual is scaled by the first
    nonzero eigenvalue instead of its own."""
    U = np.asarray(U, np.float64)
    lam = rayleigh(U, Kp, Mp)
    order = np.argsort(lam)
    U, lam = U[:, order], lam[order]
    MU = Mp @ U
    scale = np.maximum(np.abs(lam), np.abs(lam[min(1, len(lam) - 1)]))
    res = (np.linalg.norm(Kp @ U - MU * lam, axis=0)
           / (scale * np.linalg.norm(MU, axis=0)))
    defect = float(np.abs(U.T @ MU - np.eye(U.shape[1])).max())
    return lam, res, defect


def phase_training(L, M, X, k: int = 20, hidden=(256, 256, 256),
                   epochs: int = 150, scan_chunk: int = 50,
                   lobpcg_iters: int = 400, guard: int = 8,
                   max_bandwidth: int = 8192, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from eigenpinns_tpu.solvers.direct import train_joint
    from eigenpinns_tpu.solvers.lobpcg import lobpcg
    from eigenpinns_tpu.sparse import Diagonal, RollingBanded

    K_tr, perm = RollingBanded.from_scipy(L, max_bandwidth=max_bandwidth)
    M_tr = Diagonal(jnp.asarray(M.diagonal()[perm], jnp.float32))
    Kp, Mp = L[perm][:, perm].tocsr(), M[perm][:, perm].tocsr()
    t0 = time.time()
    res = train_joint(
        K_tr, M_tr, X[perm], n_modes=k, hidden=hidden, mode="penalty",
        epochs=epochs, scan_chunk=scan_chunk, w_res=1.0, w_orth=1000.0,
        w_trace=0.05, lr_start=2e-3, lr_end=2e-4, seed=seed,
        rayleigh_ritz_finish=False, loss_mxu_precision="bf16",
        mlp_compute_dtype="bfloat16")
    log(f"[phase3] train_joint n={L.shape[0]} k={k} {epochs} epochs in "
        f"{time.time()-t0:.1f}s, final loss "
        f"{float(res.history['loss'][-1]):.4g}")
    _, res0, _ = residual_referee(res.eigenvectors, Kp, Mp)

    guards = np.random.default_rng(seed + 3).normal(
        size=(L.shape[0], guard)).astype(np.float32)
    X0 = jnp.concatenate([jnp.asarray(res.eigenvectors), guards], 1)
    t0 = time.time()
    pol = lobpcg(K_tr, M_tr, X0, max_iter=lobpcg_iters, tol=1e-6)
    U = np.asarray(jax.block_until_ready(pol.eigenvectors))[:, :k]
    log(f"[phase3] lobpcg {int(pol.iterations)} iterations in "
        f"{time.time()-t0:.1f}s")
    lam, res1, defect = residual_referee(U, Kp, Mp)
    log(f"[phase3] eigenvalues {fmt(lam)}")
    log(f"[phase3] residual at trained start {fmt(res0)}")
    log(f"[phase3] residual after polish    {fmt(res1)}")
    log(f"[phase3] M-orthonormality defect {defect:.2e} (tol {ORTH_TOL:g})")
    log(f"[phase3] peak_bytes_in_use {peak_bytes(jax.devices()[0])}")
    check(defect <= ORTH_TOL, f"M-orthonormality defect {defect:.2e}")
    check(bool(np.isfinite(res1).all()), "finite residuals")
    check(bool((res1 < res0).all()),
          f"residuals below the trained start: {res1} vs {res0}")
    return {"defect": defect, "residuals": res1.tolist(),
            "start_residuals": res0.tolist()}


# ---------------------------------------------------------------------------
# phase 4 (--multi): sharded paths against their single-device runs
# ---------------------------------------------------------------------------


def _rel(a, b, floor=1e-9):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), floor)).max())


def phase_multi(X, L, M, n_devices: int = 4, k: int = 8,
                hidden=(64, 64, 64), epochs: int = 100,
                scan_chunk: int = 50, lobpcg_iters: int = 100,
                levels=(512, 2048, 8192), mg_hidden=(64, 64),
                mg_epochs: int = 20) -> dict:
    """The sharded solvers first, so the per-device peaks printed after
    them are theirs alone; then the single-device runs on device 0."""
    import jax

    from eigenpinns_tpu.configs import Config
    from eigenpinns_tpu.geometry.mesh import TriMesh
    from eigenpinns_tpu.parallel import make_mesh
    from eigenpinns_tpu.sampling import build_hierarchy
    from eigenpinns_tpu.solvers import (
        prepare_sharded_problem,
        train_joint,
        train_joint_sharded,
    )
    from eigenpinns_tpu.solvers.lobpcg import lobpcg
    from eigenpinns_tpu.solvers.lobpcg_sharded import lobpcg_sharded
    from eigenpinns_tpu.solvers.multigrid import MultigridTrainer
    from eigenpinns_tpu.sparse import as_operator

    check(len(jax.devices()) >= n_devices,
          f"{n_devices} devices (found {len(jax.devices())})")
    devices = jax.devices()[:n_devices]
    mesh = make_mesh(n_devices)
    out = {}

    kw = dict(n_modes=k, hidden=hidden, epochs=epochs, scan_chunk=scan_chunk,
              lr_start=3e-3, lr_end=1e-3, w_res=1.0, w_orth=10.0, seed=0)
    t0 = time.time()
    # One host-side ordering and sharding serves both sharded solvers.
    prob = prepare_sharded_problem(L, M, X=X, mesh=mesh)
    log(f"[phase4] sharded {prob.kind} problem n_pad={prob.n_pad} in "
        f"{time.time()-t0:.1f}s")
    t0 = time.time()
    rs = train_joint_sharded(L, M, X, problem=prob, **kw)
    t_tjs = time.time() - t0
    # Same warm start for both LOBPCGs: the sharded trained block.
    X0 = np.asarray(rs.eigenvectors, np.float32)
    t0 = time.time()
    vs, _, _ = lobpcg_sharded(L, M, k=k, problem=prob, X0=X0,
                              max_iter=lobpcg_iters, tol=1e-7)
    t_lobs = time.time() - t0
    del prob
    gc.collect()
    peaks = [peak_bytes(d) for d in devices]
    log(f"[phase4] peak_bytes_in_use per device after the sharded "
        f"train_joint and LOBPCG {peaks}")
    out["peak_bytes_in_use_sharded_solvers"] = peaks

    K_op, M_op = as_operator(L), as_operator(M)
    t0 = time.time()
    r1 = train_joint(K_op, M_op, X, **kw)
    t_tj = time.time() - t0
    d_loss = _rel(rs.history["loss"], r1.history["loss"])
    d_lam = _rel(rs.eigenvalues[1:], r1.eigenvalues[1:])
    log(f"[phase4] train_joint_sharded vs train_joint: max rel loss diff "
        f"{d_loss:.2e} (tol {TRAJ_TOL:g}), eigenvalues {d_lam:.2e} "
        f"(tol {EIGVAL_TOL:g}); {t_tj:.1f}s single, {t_tjs:.1f}s sharded")
    check(d_loss <= TRAJ_TOL and d_lam <= EIGVAL_TOL,
          f"train_joint_sharded: {d_loss:.2e} / {d_lam:.2e}")
    out["train_joint"] = {"loss": d_loss, "eigenvalues": d_lam}

    t0 = time.time()
    v1 = np.asarray(lobpcg(K_op, M_op, jax.numpy.asarray(X0),
                           max_iter=lobpcg_iters, tol=1e-7).eigenvalues)
    d_lob = _rel(np.sort(vs)[1:], np.sort(v1)[1:])
    log(f"[phase4] lobpcg_sharded vs lobpcg: max rel eigenvalue diff "
        f"{d_lob:.2e} (tol {EIGVAL_TOL:g}); {time.time()-t0:.1f}s single, "
        f"{t_lobs:.1f}s sharded")
    check(d_lob <= EIGVAL_TOL, f"lobpcg_sharded: {d_lob:.2e}")
    out["lobpcg"] = d_lob
    del K_op, M_op, r1, rs
    gc.collect()

    t0 = time.time()
    h = build_hierarchy(TriMesh(X, np.zeros((0, 3), np.int32)),
                        list(levels), n_modes=k, pc_neighbors=15)
    # Per-level loss on both sides: the single trainer's fused
    # block-diagonal loss sums in another order.
    cfg = Config(n_modes=k, hierarchy=list(levels),
                 hidden_layers=list(mg_hidden), epochs=mg_epochs,
                 scan_chunk=mg_epochs, log_every=0, polish_iters=0,
                 early_stop_patience=10 ** 9,
                 loss_mxu_precision=MG_PRECISION, fuse_level_ops=False)
    log(f"[phase4] hierarchy {h.actual_hierarchy} in {time.time()-t0:.1f}s")
    with jax.default_matmul_precision(MG_PRECISION):
        t0 = time.time()
        ms = MultigridTrainer(cfg).train(h, mesh=mesh)
        t1 = time.time()
        m1 = MultigridTrainer(cfg).train(h)
        t2 = time.time()
    d_mg = _rel(ms.history["loss"], m1.history["loss"])
    per_epoch = (np.abs(np.asarray(ms.history["loss"], np.float64)
                        - m1.history["loss"])
                 / np.abs(np.asarray(m1.history["loss"], np.float64)))
    log(f"[phase4] multigrid rel loss diff per epoch {fmt(per_epoch)}")
    d_mgl = _rel(ms.eigenvalues[1:], m1.eigenvalues[1:])
    log(f"[phase4] sharded MultigridTrainer vs single ({mg_epochs} epochs "
        f"at precision {MG_PRECISION}): max rel loss diff {d_mg:.2e} (tol "
        f"{MG_TRAJ_TOL:g}), eigenvalues {d_mgl:.2e} (tol {EIGVAL_TOL:g}); "
        f"{t2-t1:.1f}s single, {t1-t0:.1f}s sharded")
    check(d_mg <= MG_TRAJ_TOL and d_mgl <= EIGVAL_TOL,
          f"sharded multigrid: {d_mg:.2e} / {d_mgl:.2e}")
    out["multigrid"] = {"loss": d_mg, "eigenvalues": d_mgl}

    peaks = [peak_bytes(d) for d in devices]
    log(f"[phase4] peak_bytes_in_use per device at the end {peaks}")
    out["peak_bytes_in_use"] = peaks
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--out", default=os.path.join("outputs", "smoke"),
                    help="directory for the phase-1 mesh and VTU files")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (jax devices: {devices}); this "
              f"smoke test runs only on the card", file=sys.stderr)
        return 2
    from eigenpinns_tpu.geometry import native

    log(f"card: {card_line()}; native host library "
        f"{'loaded' if native.available() else 'NOT loaded'}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    t0 = time.time()
    X, L, M = cloud_problem(300_000)
    if args.multi:
        phase_multi(X, L, M, n_devices=4)
    else:
        phase_cli(args.out)
        phase_operators(L, X)
        phase_training(L, M, X)
    log(f"chip_smoke: all phases passed in {time.time()-t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
