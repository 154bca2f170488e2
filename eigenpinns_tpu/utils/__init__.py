from eigenpinns_tpu.utils.fixtures import (
    laplacian_1d,
    laplacian_1d_eigenvalues,
    tridiagonal,
    random_spd,
    generate_test_matrices,
    verify_eigenpairs,
    subsample_hierarchy,
    icosphere,
)
from eigenpinns_tpu.utils.profiling import PhaseTimer, trace, annotate
from eigenpinns_tpu.utils.debug import (
    debug_nans,
    deterministic_mode,
    assert_finite,
)

__all__ = [
    "laplacian_1d", "laplacian_1d_eigenvalues", "tridiagonal", "random_spd",
    "generate_test_matrices", "verify_eigenpairs", "subsample_hierarchy",
    "icosphere",
    "PhaseTimer", "trace", "annotate", "debug_nans", "deterministic_mode",
    "assert_finite",
]
