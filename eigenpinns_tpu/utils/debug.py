"""Debug / determinism utilities.

The reference is single-threaded Python with no sanitizers (SURVEY.md
sec 5). This framework's equivalents: NaN trapping through jax's
debug-nans mode, and a deterministic test mode pinning every RNG.
"""

from __future__ import annotations

import contextlib
import random

import numpy as np


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise on the first NaN produced inside jitted code."""
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def deterministic_mode(seed: int = 0):
    """Pin Python/numpy RNGs; returns a fresh jax PRNG key for the run."""
    import jax

    random.seed(seed)
    np.random.seed(seed)
    return jax.random.PRNGKey(seed)


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness check over a pytree (post-step validation)."""
    import jax

    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            bad = np.size(arr) - int(np.isfinite(arr).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite values")
