"""Compute-op namespace: re-exports the framework's operator kernels.

The op surface lives in two implementation packages — `sparse/` (operator
formats and their SpMM/Gram products) and
`operators/` (problem definitions: Laplace-Beltrami assembly lives in
`geometry/`, Schrodinger and eikonal residuals here). This module gathers
them under one import for discoverability:

    from eigenpinns_tpu.ops import spmm, banded_spmm, schrodinger_residual
"""

from eigenpinns_tpu.sparse import (  # noqa: F401
    BandedELL,
    BSRTile,
    Diagonal,
    RollingBanded,
    SparseELL,
    as_operator,
    banded_spmm,
    bsr_spmm,
    bsr_spmm_gram,
    rolling_spmm,
    block_diag_ell,
    gcn_normalized_adjacency,
    gram,
    hdot,
    m_gram,
    m_normalize_columns,
    neighbor_mean,
    neighbor_mean_operator,
    normalize_columns,
    rayleigh_quotients,
    residual,
    spmm,
    spmv,
)
from eigenpinns_tpu.operators import (  # noqa: F401
    eigen_positional_encoding,
    eikonal_residual,
    gradient_norm_operator,
    harmonic_oscillator,
    infinite_well,
    laplacian_nd,
    mc_inner,
    mc_norm_sq,
    oscillator_eigenvalues,
    schrodinger_residual,
    second_derivative_1d,
    well_eigenvalues,
)
