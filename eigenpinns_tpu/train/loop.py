"""Scan-chunked training loops.

The reference runs 10k-epoch Python loops with one graph launch per epoch
(src/multigrid_model.py:226-279). Here epochs are fused `scan_chunk` at a
time into ONE compiled program (jit(lax.scan)) and the host only syncs
between chunks — for early stopping, logging and plateau scheduling. This
removes per-step dispatch overhead entirely: with small per-step work it
is the difference between device-bound and launch-bound training.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp


class LoopResult(NamedTuple):
    state: Any
    history: dict           # metric name -> np array over epochs run
    epochs_run: int
    wall_time: float
    stopped_early: bool
    chunk_times: list       # [(n_epochs, seconds)] per chunk; chunk 0
                            # includes compilation — steady-state rate is
                            # sum(n)/sum(s) over chunks 1+
    best_state: Any = None  # state at the best metric (track_best=True)
    steady_rate: float | None = None  # steps/s from the chained timing
                                      # probe (timing_chunks > 0)


def run_scan_loop(
    step_fn: Callable,        # (state, epoch:int32) -> (state, metrics dict)
    init_state: Any,
    n_epochs: int,
    chunk: int = 100,
    early_stop_patience: int | None = None,
    early_stop_metric: str = "loss",
    early_stop_mode: str = "improve",
    early_stop_tol: float = 0.0,
    log_every: int = 0,
    log_fn: Callable | None = None,
    track_best: bool = False,
    data: Any = None,
    start_epoch: int = 0,
    chunk_callback: Callable | None = None,
    timing_chunks: int = 0,
) -> LoopResult:
    """Run `step_fn` for up to n_epochs, fused in jitted scan chunks.

    Early stopping follows the reference semantics
    (src/multigrid_model.py:262-272): a counter increments whenever the
    metric fails to improve on its best and the loop stops when the
    counter exceeds the patience. The counter is tracked inside the scan
    carry so fusing does not change behavior.

    `early_stop_mode="below_tol"` switches the counter to the notebook's
    EMA-slope convergence monitor (iterative_eigenvalues cell 1:233-237):
    it increments while |metric| < early_stop_tol (the smoothed loss has
    flattened) and resets otherwise. best-tracking still follows "loss".

    `data` (optional pytree) is forwarded to step_fn(state, epoch, data)
    as a JIT ARGUMENT. Large constants (operators, features) must travel
    this way, not as closures: closure-captured arrays are baked into the
    compiled program, which doubles device memory and bloats the
    compiled executable.

    `chunk_callback(epochs_run, state)` (optional) runs HOST-SIDE after
    every chunk with the live training state — the observability hook
    for mid-training evaluation (subspace-error tracking, custom
    checkpoint cadence) without breaking the scan fusion.

    `timing_chunks` (optional) appends a chained throughput probe AFTER
    training: 3 rounds, each dispatching the already-compiled chunk
    program `timing_chunks` times back-to-back with NO host sync in
    between and forcing with a single scalar readback. Round rate =
    epochs / raw wall INCLUDING that one readback — a LOWER bound on
    device throughput (nothing is subtracted); `LoopResult.steady_rate`
    is the max (tightest bound) over rounds. The main-loop `chunk_times`
    instead pay one host sync per chunk. The probe's extra training
    steps are DISCARDED: the returned state/history are exactly those of
    the requested `n_epochs` run.
    """
    import numpy as np

    @partial(jax.jit, static_argnums=(3,))
    def run_chunk(carry, data, epoch0, length):
        def body(c, i):
            state, best, patience, best_state = c
            if data is None:
                state, metrics = step_fn(state, epoch0 + i)
            else:
                state, metrics = step_fn(state, epoch0 + i, data)
            val = metrics[early_stop_metric]
            if early_stop_mode == "below_tol":
                # Convergence = |metric| stays under tol (e.g. a flat EMA
                # slope); best/improved track the loss for track_best.
                loss_val = metrics.get("loss", val)
                improved = loss_val < best
                best = jnp.where(improved, loss_val, best)
                flat = jnp.abs(val) < early_stop_tol
                patience = jnp.where(flat, patience + 1, 0)
            else:
                improved = val < best
                best = jnp.where(improved, val, best)
                patience = jnp.where(improved, 0, patience + 1)
            if track_best:
                best_state = jax.tree_util.tree_map(
                    lambda b, s: jnp.where(improved, s, b),
                    best_state, state)
            return (state, best, patience, best_state), metrics

        return jax.lax.scan(body, carry, jnp.arange(length, dtype=jnp.int32))

    carry = (init_state, jnp.asarray(jnp.inf, dtype=jnp.float32),
             jnp.asarray(0, dtype=jnp.int32), init_state)
    history: dict[str, list] = {}
    t0 = time.time()
    epochs_run = 0
    stopped = False
    chunk_times = []
    while epochs_run < n_epochs:
        t_chunk = time.time()
        length = min(chunk, n_epochs - epochs_run)
        # start_epoch offsets the epoch seen by step_fn (checkpoint
        # resume: ramps/schedules keyed on the epoch must continue, not
        # replay from zero); epochs_run/history still count this session.
        carry, metrics = run_chunk(
            carry, data,
            jnp.asarray(start_epoch + epochs_run, jnp.int32), length)
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        chunk_times.append((length, time.time() - t_chunk))
        for k, v in metrics.items():
            history.setdefault(k, []).append(v)
        epochs_run += length
        if chunk_callback is not None:
            chunk_callback(epochs_run, carry[0])
        if log_every and log_fn is not None:
            for e in range(epochs_run - length, epochs_run):
                if e % log_every == 0 or e == n_epochs - 1:
                    log_fn(e, {k: float(v[e - (epochs_run - length)])
                               for k, v in metrics.items()})
        patience = int(carry[2])
        if early_stop_patience is not None and patience > early_stop_patience:
            stopped = True
            break

    wall = time.time() - t0   # training wall only: the probe below runs
                              # extra (discarded) epochs that must not
                              # skew epochs_run/wall_time-derived rates
    steady_rate = None
    if timing_chunks > 0:
        probe_carry = carry
        rates = []
        for _ in range(3):
            probe_metrics = None
            t_probe = time.time()
            for i in range(timing_chunks):
                probe_carry, probe_metrics = run_chunk(
                    probe_carry, data,
                    jnp.asarray(start_epoch + epochs_run + i * chunk,
                                jnp.int32), chunk)
            float(probe_metrics[early_stop_metric][-1])  # forcing read
            raw = time.time() - t_probe   # includes ONE readback RTT
            rates.append(timing_chunks * chunk / max(raw, 1e-9))
        steady_rate = max(rates)          # tightest lower bound
        del probe_carry, probe_metrics    # probe training state discarded

    history = {k: np.concatenate(v) for k, v in history.items()}
    return LoopResult(carry[0], history, epochs_run, wall,
                      stopped, chunk_times,
                      carry[3] if track_best else None,
                      steady_rate)
