from eigenpinns_tpu.sparse.formats import SparseELL, Diagonal, as_operator
from eigenpinns_tpu.sparse.banded import (
    BandedELL,
    banded_spmm,
    banded_spmm_gram,
)
from eigenpinns_tpu.sparse.rolling import (
    RollingBanded,
    rolling_spmm,
    rolling_spmm_gram,
)
from eigenpinns_tpu.sparse.split import (
    SplitBanded,
    split_spmm,
    split_spmm_gram,
    spatial_cluster_order,
    hilbert_order,
)
from eigenpinns_tpu.sparse.bsr import (
    BSRTile,
    bsr_spmm,
    bsr_spmm_gram,
)
from eigenpinns_tpu.sparse.ops import (
    hdot,
    operator_dot,
    spmm,
    spmm_gram,
    spmv,
    gram,
    m_gram,
    rayleigh_quotients,
    m_normalize_columns,
    normalize_columns,
    residual,
    block_diag_ell,
    gcn_normalized_adjacency,
    neighbor_mean,
    neighbor_mean_operator,
    neighbor_mean_scipy,
)

__all__ = [
    "SparseELL", "Diagonal", "as_operator",
    "BandedELL", "banded_spmm", "banded_spmm_gram",
    "RollingBanded", "rolling_spmm", "rolling_spmm_gram",
    "SplitBanded", "split_spmm", "split_spmm_gram", "spatial_cluster_order",
    "hilbert_order",
    "BSRTile", "bsr_spmm", "bsr_spmm_gram",
    "hdot", "operator_dot", "spmm", "spmm_gram", "spmv", "gram", "m_gram", "rayleigh_quotients",
    "m_normalize_columns", "normalize_columns", "residual",
    "block_diag_ell", "gcn_normalized_adjacency", "neighbor_mean",
    "neighbor_mean_operator", "neighbor_mean_scipy",
]
