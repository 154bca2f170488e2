"""Time the plain-JAX SpMM candidates on the card at the 300k cloud.

    python scripts/spmm_candidates.py [--n 300000] [--out FILE]

For each operator format XLA runs without a hand kernel — gather-ELL
(`sparse/ops.py`), the rolling band and strip-BSR at chunk 1 and 8, the
last three at precision 'highest' and 'high' — and k in {20, 128}: the
forward A@U and the forward plus VJP A^T g, each compiled and warmed,
then timed as the mean of 50 back-to-back calls
ended by `block_until_ready` (best of 3). Beside each time: the bytes
the format must move at least (its stored arrays, U read once, the
result written once; twice that for forward plus VJP), computed from
shapes, and that floor's share of the card's 3.35 TB/s. For scale, the
same run times a large copy and a large bf16 matmul.

Prints one line per measurement and writes them as JSON to --out.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import card_line, make_cloud, peaks_for  # noqa: E402


def timed(f, *args, reps: int = 50, rounds: int = 3) -> float:
    """Seconds per call: mean of `reps` back-to-back calls, best round."""
    import jax

    jax.block_until_ready(f(*args))
    best = np.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def operator_bytes(op) -> int:
    import jax

    return int(sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(op)
                   if hasattr(leaf, "nbytes")))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=300_000)
    ap.add_argument("--out", default="outputs/spmm_candidates.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found ({jax.devices()})", file=sys.stderr)
        return 2
    bw = peaks_for(dev)["hbm_bytes_per_s"]
    card = card_line()
    print(f"card: {card}; {dev.device_kind}", flush=True)

    from eigenpinns_tpu.geometry import point_cloud_laplacian
    from eigenpinns_tpu.sparse import BSRTile, RollingBanded, SparseELL, spmm

    rows = []

    def record(**kw):
        kw["card"] = card
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    # Reference points: a plain copy and a bf16 matmul.
    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)       # 1 GiB
    t = timed(jax.jit(lambda a: a * 2.0), x, reps=20)
    record(what="copy 1 GiB f32", ms=t * 1e3,
           gb_per_s=2 * x.nbytes / t / 1e9)
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    t = timed(jax.jit(lambda p, q: jnp.dot(
        p, q, preferred_element_type=jnp.float32)), a, a, reps=20)
    record(what="matmul 8192^3 bf16", ms=t * 1e3,
           tflops=2 * 8192 ** 3 / t / 1e12)
    del x, a

    X = make_cloud(args.n)
    t0 = time.time()
    L, _ = point_cloud_laplacian(X, n_neighbors=15)
    L = L.tocsr()
    print(f"laplacian n={args.n} nnz={L.nnz} in {time.time()-t0:.1f}s",
          flush=True)

    builders = {
        "ell": lambda: SparseELL.from_scipy(L),
        "rolling": lambda: RollingBanded.from_scipy(
            L, max_bandwidth=8192)[0],
        "bsr_c1": lambda: BSRTile.from_scipy(L, chunk=1)[0],
        "bsr_c8": lambda: BSRTile.from_scipy(L, chunk=8)[0],
    }
    fwd = jax.jit(spmm)

    @jax.jit
    def fwd_vjp(op, U, G):
        W, vjp = jax.vjp(lambda u: spmm(op, u), U)
        return W, vjp(G)[0]

    rng = np.random.default_rng(0)
    for name, build in builders.items():
        t0 = time.time()
        op = build()
        op_b = operator_bytes(op)
        print(f"{name}: built in {time.time()-t0:.1f}s, "
              f"{op_b/1e9:.3f} GB stored", flush=True)
        precisions = (("highest", "high") if hasattr(op, "with_precision")
                      else ("highest",))
        for prec in precisions:
            op_p = op.with_precision(prec) if prec != "highest" else op
            for k in (20, 128):
                U = jnp.asarray(rng.normal(size=(args.n, k)), jnp.float32)
                G = jnp.asarray(rng.normal(size=(args.n, k)), jnp.float32)
                floor = op_b + 2 * U.nbytes
                t_f = timed(fwd, op_p, U)
                t_fv = timed(fwd_vjp, op_p, U, G)
                record(what=f"{name} {prec} k={k}", op_gb=op_b / 1e9,
                       fwd_ms=t_f * 1e3, fwd_vjp_ms=t_fv * 1e3,
                       floor_gb=floor / 1e9,
                       fwd_roofline_share=floor / t_f / bw,
                       fwd_vjp_roofline_share=2 * floor / t_fv / bw)
                del U, G
        del op, op_p

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
