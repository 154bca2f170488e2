"""Multiresolution hierarchy builder — the framework's `Sampler`.

Capability parity with `src/samplers.py:188-286`: given a mesh and a
hierarchy of target sizes, build per-level point sets X, operators (K, M),
kNN/connectivity edge lists, prolongations P, and smoothed initial
eigenvector guesses U. Differences from the reference, by design:

  * operators are canonicalized ONCE into device operator formats
    (SparseELL / Diagonal) — the reference reconverted scipy->torch every
    epoch (src/multigrid_model.py:306-307, the known hot-loop bug);
  * the coarsest-level exact solve can run on device (LOBPCG) or host
    (ARPACK oracle);
  * prolongation smoothing (Jacobi) runs on device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from eigenpinns_tpu.geometry import TriMesh, assemble_stiffness_mass
from eigenpinns_tpu.geometry.point_cloud import point_cloud_laplacian
from eigenpinns_tpu.sampling.decimation import decimation_levels
from eigenpinns_tpu.sampling.knn import knn_graph, prolongation_matrix
from eigenpinns_tpu.sampling.samplers import (
    farthest_point_levels,
    random_levels,
    voxel_levels,
)
from eigenpinns_tpu.sparse import as_operator
from eigenpinns_tpu.solvers import jacobi_smooth, lobpcg_from_random
from eigenpinns_tpu.solvers.oracle import eigsh_smallest

SAMPLER_TYPES = ("farthest_point", "voxel_downsampling", "graph_coarsening",
                 "random")
EDGE_TYPES = ("knn_based", "connectivity_based")
COARSE_SOLVERS = ("eigsh", "lobpcg")


@dataclasses.dataclass
class Hierarchy:
    """Preprocessed multiresolution problem, ready for on-device training."""

    X_list: list[np.ndarray]          # per-level coordinates (host f64)
    K_ops: list[Any]                  # per-level stiffness (SparseELL)
    M_ops: list[Any]                  # per-level mass (SparseELL/Diagonal)
    K_scipy: list[Any]                # host-side canonical operators
    M_scipy: list[Any]
    P_ops: list[Any]                  # prolongations level l-1 -> l
    Pt_ops: list[Any]                 # their transposes
    U_list: list[Any]                 # initial eigvec guesses (jax, f32)
    edge_index_list: list[np.ndarray]
    actual_hierarchy: list[int]
    meshes: list[TriMesh]
    indices_per_level: list[np.ndarray]
    coarse_eigenvalues: np.ndarray
    perms: list[np.ndarray] | None = None  # per-level RCM permutations
                                           # (banded format); None = identity
    build_max_bandwidth: int = 4096   # the rolling-band cap the per-level
                                      # ops were built with; fused_level_ops
                                      # defaults to the same cap

    def fused_level_ops(self, dtype=jnp.float32,
                        max_bandwidth: int | None = None):
        """Block-diagonal (K, M) device operators over the concatenated
        level node axis.

        The multigrid loss treats the levels as independent blocks of one
        batched problem (the trainer already concatenates U over levels);
        a single block-diagonal SpMM replaces the per-level SpMM
        dispatches — one kernel launch instead of n_levels, forward AND
        in the VJP. Levels keep their already-applied per-level ordering,
        so row ranges still line up with the trainer's node offsets.
        Result is cached on the instance per (dtype, max_bandwidth)
        (operators are build-once, like K_ops/M_ops — see module
        docstring); `max_bandwidth=None` inherits the cap the per-level
        ops were built with.
        """
        if max_bandwidth is None:
            max_bandwidth = self.build_max_bandwidth
        key = (jnp.dtype(dtype).name, int(max_bandwidth))
        cache = getattr(self, "_fused_ops", None)
        if cache is None:
            cache = {}
            self._fused_ops = cache
        if key in cache:
            return cache[key]
        import scipy.sparse as sp

        from eigenpinns_tpu.sparse.bsr import BSRTile
        from eigenpinns_tpu.sparse.formats import Diagonal
        from eigenpinns_tpu.sparse.rolling import RollingBanded

        K_blk = sp.block_diag([K.tocsr() for K in self.K_scipy],
                              format="csr")

        def _banded(A):
            # Mirror the finest level's format choice; block boundaries
            # only ever WIDEN the rolling window by < one tile, so a
            # bandwidth blowup past max_bandwidth falls back to strip-BSR
            # (no cap), exactly like build_hierarchy's per-level logic.
            if isinstance(self.K_ops[-1], RollingBanded):
                try:
                    return RollingBanded.from_scipy(
                        A, dtype=dtype, reorder=False,
                        max_bandwidth=max_bandwidth)[0]
                except ValueError:
                    pass
            return BSRTile.from_scipy(A, dtype=dtype, reorder=False)[0]

        if isinstance(self.K_ops[-1], (RollingBanded, BSRTile)):
            K_op = _banded(K_blk)
        else:
            K_op = as_operator(K_blk, dtype=dtype)
        if all(isinstance(op, Diagonal) for op in self.M_ops):
            M_op = Diagonal(jnp.concatenate(
                [op.diag for op in self.M_ops]).astype(dtype))
        else:
            M_blk = sp.block_diag([M.tocsr() for M in self.M_scipy],
                                  format="csr")
            if isinstance(self.K_ops[-1], (RollingBanded, BSRTile)):
                M_op = _banded(M_blk)
            else:
                M_op = as_operator(M_blk, dtype=dtype)
        cache[key] = (K_op, M_op)
        return cache[key]

    def to_original_order(self, U_finest: np.ndarray) -> np.ndarray:
        """Map finest-level rows back to the input mesh's vertex order
        (needed after banded-format training, whose levels are
        RCM-permuted)."""
        if self.perms is None:
            return U_finest
        perm = self.perms[-1]
        out = np.empty_like(U_finest)
        out[perm] = U_finest
        return out

    def save(self, directory: str) -> None:
        """Persist the preprocessed hierarchy (operators, prolongations,
        initial guesses) so reruns skip the 100s+ preprocessing at scale.

        Layout: one .npz of dense arrays + scipy .npz per sparse operator.
        """
        import os

        import scipy.sparse as sp

        os.makedirs(directory, exist_ok=True)
        dense = {
            "actual_hierarchy": np.asarray(self.actual_hierarchy),
            "coarse_eigenvalues": self.coarse_eigenvalues,
            "n_levels": np.asarray(self.n_levels),
            "has_perms": np.asarray(self.perms is not None),
        }
        for i in range(self.n_levels):
            dense[f"X_{i}"] = np.asarray(self.X_list[i])
            dense[f"U_{i}"] = np.asarray(self.U_list[i])
            dense[f"edges_{i}"] = np.asarray(self.edge_index_list[i])
            if self.perms is not None:
                dense[f"perm_{i}"] = np.asarray(self.perms[i])
            if i < len(self.indices_per_level):
                dense[f"indices_{i}"] = np.asarray(
                    self.indices_per_level[i])
            sp.save_npz(os.path.join(directory, f"K_{i}.npz"),
                        self.K_scipy[i].tocsr())
            sp.save_npz(os.path.join(directory, f"M_{i}.npz"),
                        self.M_scipy[i].tocsr())
        for i, (P, _) in enumerate(zip(self.P_ops, self.Pt_ops)):
            sp.save_npz(os.path.join(directory, f"P_{i}.npz"),
                        P.to_scipy().tocsr())
        mesh = self.meshes[-1]
        dense["mesh_verts"] = mesh.verts
        dense["mesh_faces"] = mesh.faces
        np.savez_compressed(os.path.join(directory, "hierarchy.npz"),
                            **dense)

    @classmethod
    def load(cls, directory: str, dtype=jnp.float32,
             operator_format: str = "ell",
             max_bandwidth: int = 4096) -> "Hierarchy":
        """Rebuild a Hierarchy from `save` output. Operators are
        re-canonicalized to the requested device format (the on-disk form
        is format-agnostic scipy CSR)."""
        import os

        import scipy.sparse as sp

        dense = np.load(os.path.join(directory, "hierarchy.npz"))
        n_levels = int(dense["n_levels"])
        has_perms = bool(dense["has_perms"])
        K_sp = [sp.load_npz(os.path.join(directory, f"K_{i}.npz"))
                for i in range(n_levels)]
        M_sp = [sp.load_npz(os.path.join(directory, f"M_{i}.npz"))
                for i in range(n_levels)]
        X_list = [dense[f"X_{i}"] for i in range(n_levels)]
        U_list = [jnp.asarray(dense[f"U_{i}"], dtype) for i in
                  range(n_levels)]
        edges = [dense[f"edges_{i}"] for i in range(n_levels)]
        perms = ([dense[f"perm_{i}"] for i in range(n_levels)]
                 if has_perms else None)
        indices = [dense[f"indices_{i}"] for i in range(n_levels)
                   if f"indices_{i}" in dense]
        if operator_format in ("banded", "auto") and has_perms:
            # Saved operators are ALREADY RCM-permuted; re-canonicalize
            # directly, with the same small-k/large-k format split as
            # build_hierarchy (k = saved initial-guess width).
            from eigenpinns_tpu.sparse.bsr import BSRTile
            from eigenpinns_tpu.sparse.rolling import RollingBanded

            k_saved = int(U_list[0].shape[1])

            def _op(K, _i=[0]):
                level = _i[0]
                _i[0] += 1
                if k_saved <= 32:
                    try:
                        return RollingBanded.from_scipy(
                            K, dtype=dtype, reorder=False,
                            max_bandwidth=max_bandwidth)[0]
                    except ValueError:
                        import warnings

                        warnings.warn(
                            f"load: level {level} RCM bandwidth exceeds "
                            f"max_bandwidth={max_bandwidth}; using the "
                            "strip-BSR format instead of the rolling "
                            "band (different HBM/perf profile)",
                            stacklevel=2)
                return BSRTile.from_scipy(K, dtype=dtype,
                                          reorder=False)[0]

            K_ops = [_op(K) for K in K_sp]
        else:
            K_ops = [as_operator(K, dtype=dtype) for K in K_sp]
        M_ops = [as_operator(M, dtype=dtype) for M in M_sp]
        P_ops, Pt_ops = [], []
        for i in range(n_levels - 1):
            P = sp.load_npz(os.path.join(directory, f"P_{i}.npz"))
            P_ops.append(as_operator(P.tocsr(), dtype=dtype))
            Pt_ops.append(as_operator(P.T.tocsr(), dtype=dtype))
        mesh = TriMesh(dense["mesh_verts"], dense["mesh_faces"])
        return cls(
            X_list=X_list, K_ops=K_ops, M_ops=M_ops,
            K_scipy=K_sp, M_scipy=M_sp, P_ops=P_ops, Pt_ops=Pt_ops,
            U_list=U_list, edge_index_list=edges,
            actual_hierarchy=[int(v) for v in dense["actual_hierarchy"]],
            meshes=[mesh], indices_per_level=indices,
            coarse_eigenvalues=dense["coarse_eigenvalues"],
            perms=perms,
            build_max_bandwidth=max_bandwidth,
        )

    @property
    def n_levels(self) -> int:
        return len(self.X_list)

    @property
    def node_offsets(self) -> list[int]:
        """Cumulative offsets of levels in the concatenated node axis
        (src/multigrid_model.py:95-97)."""
        sizes = [x.shape[0] for x in self.X_list]
        return [0] + list(np.cumsum(sizes[:-1]))


def build_hierarchy(
    mesh: TriMesh,
    hierarchy: list[int],
    n_modes: int,
    sampler_type: str = "farthest_point",
    edge_computation_type: str = "knn_based",
    k_neighbors: int = 21,
    prolongation_neighbors: int = 21,
    pc_neighbors: int = 30,
    coarse_solver: str = "eigsh",
    jacobi_alpha: float = 0.1,
    jacobi_iters: int = 10,
    seed: int = 0,
    dtype=jnp.float32,
    operator_format: str = "ell",   # 'ell' | 'banded' | 'auto'
    max_bandwidth: int = 4096,
) -> Hierarchy:
    """Build the full multiresolution problem (Sampler.preprocess_mesh
    parity, src/samplers.py:283-286)."""
    if sampler_type not in SAMPLER_TYPES:
        raise ValueError(
            f"sampler_type must be one of {SAMPLER_TYPES}, got "
            f"'{sampler_type}'")
    if edge_computation_type not in EDGE_TYPES:
        edge_computation_type = "knn_based"  # reference fallback behavior
    if coarse_solver not in COARSE_SOLVERS:
        raise ValueError(f"coarse_solver must be one of {COARSE_SOLVERS}")

    X_list, K_sp, M_sp, meshes, indices = [], [], [], [], []

    if sampler_type == "graph_coarsening":
        meshes = decimation_levels(mesh, hierarchy)
        for m in meshes:
            K, M = assemble_stiffness_mass(m)
            X_list.append(m.verts)
            K_sp.append(K)
            M_sp.append(M)
    else:
        if sampler_type == "farthest_point":
            indices = farthest_point_levels(mesh.verts, hierarchy, seed=seed)
        elif sampler_type == "voxel_downsampling":
            indices = voxel_levels(mesh.verts, hierarchy)
        else:
            indices = random_levels(mesh.verts, hierarchy, seed=seed)
        meshes = [mesh]
        for idx in indices:
            X = mesh.verts[idx]
            L, M = point_cloud_laplacian(X, n_neighbors=pc_neighbors)
            X_list.append(X)
            K_sp.append(L)
            M_sp.append(M)

    actual = [x.shape[0] for x in X_list]

    # Optional RCM permutation per level for the banded/tiled formats.
    # Format choice: the rolling-window band (sparse/rolling.py) for
    # narrow mode counts (k <= 32), strip-BSR (sparse/bsr.py, only the
    # nonempty tiles, no bandwidth cap) above. The rule is not yet
    # re-decided on the H100, where gather-ELL measured fastest at 300k
    # nodes for both k=20 and k=128 (PERF.md).
    # Every per-level array below is permuted consistently; `perms` lets
    # consumers map back.
    perms = None
    banded_ops: list = []
    if operator_format in ("banded", "auto"):
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        from eigenpinns_tpu.sparse.bsr import BSRTile
        from eigenpinns_tpu.sparse.rolling import RollingBanded

        prefer_rolling = n_modes <= 32
        if operator_format == "banded" and not prefer_rolling:
            # An EXPLICIT 'banded' request at wide k gets strip-BSR (the
            # rolling band's U gather loses past k~32 — see the format
            # note above). Not silent: callers pinning the band format
            # get a different HBM/perf profile.
            import warnings

            warnings.warn(
                f"operator_format='banded' with n_modes={n_modes} > 32: "
                "building strip-BSR operators (the rolling band is only "
                "used for k <= 32); pass operator_format='auto' to "
                "acknowledge the per-k format choice", stacklevel=2)
        perms = []
        new_K, new_M, new_X, new_idx = [], [], [], []
        for i, (K, M) in enumerate(zip(K_sp, M_sp)):
            perm = np.asarray(reverse_cuthill_mckee(K.tocsr(),
                                                    symmetric_mode=True))
            Kp = K.tocsr()[perm][:, perm].tocsr()
            Mp = M.tocsr()[perm][:, perm].tocsr()
            op = None
            if prefer_rolling:
                try:
                    op = RollingBanded.from_scipy(
                        Kp, dtype=dtype, reorder=False,
                        max_bandwidth=max_bandwidth)[0]
                except ValueError:
                    # Bandwidth blew past max_bandwidth -> strip-BSR
                    # below (no cap). Not silent: the formats have
                    # different HBM profiles.
                    import warnings

                    warnings.warn(
                        f"level {i}: RCM bandwidth exceeds "
                        f"max_bandwidth={max_bandwidth}; using the "
                        "strip-BSR format instead of the rolling band",
                        stacklevel=2)
                    op = None
            if op is None:
                op = BSRTile.from_scipy(Kp, dtype=dtype, reorder=False)[0]
            banded_ops.append(op)
            perms.append(perm)
            new_K.append(Kp)
            new_M.append(Mp)
            new_X.append(X_list[i][perm])
            if indices:
                new_idx.append(np.asarray(indices[i])[perm])
        K_sp, M_sp, X_list = new_K, new_M, new_X
        if indices:
            indices = new_idx

    # Edge lists.
    edge_index_list = []
    if (sampler_type == "graph_coarsening"
            and edge_computation_type == "connectivity_based"):
        edge_index_list = [m.edges(directed=True) for m in meshes]
        if perms is not None:
            # Meshes keep original vertex order but X/K/M were RCM-
            # permuted above — remap connectivity edges into the permuted
            # node numbering so GNN aggregation stays consistent.
            for i, perm in enumerate(perms):
                inv = np.empty(len(perm), dtype=np.int64)
                inv[perm] = np.arange(len(perm))
                edge_index_list[i] = inv[edge_index_list[i]]
    else:
        edge_index_list = [knn_graph(X, k=k_neighbors) for X in X_list]

    # Canonical device operators (built once — see module docstring).
    if banded_ops:
        K_ops = banded_ops
        M_ops = []
        for i, M in enumerate(M_sp):
            from eigenpinns_tpu.sparse.formats import Diagonal

            op = as_operator(M, dtype=dtype)
            if not isinstance(op, Diagonal):
                # (isinstance, not hasattr(op, 'diag'): BSRTile also has
                # a .diag field — the trap fixed in fused_level_ops.)
                # Consistent (non-lumped) mass: same format + SAME
                # (already-applied) permutation as that level's K — FEM
                # K and M share a sparsity pattern.
                from eigenpinns_tpu.sparse.rolling import RollingBanded

                if isinstance(banded_ops[i], RollingBanded):
                    op = RollingBanded.from_scipy(
                        M.tocsr(), dtype=dtype, reorder=False,
                        max_bandwidth=max_bandwidth)[0]
                else:
                    from eigenpinns_tpu.sparse.bsr import BSRTile

                    op = BSRTile.from_scipy(M.tocsr(), dtype=dtype,
                                            reorder=False)[0]
            M_ops.append(op)
    else:
        K_ops = [as_operator(K, dtype=dtype) for K in K_sp]
        M_ops = [as_operator(M, dtype=dtype) for M in M_sp]

    # Coarsest-level exact solve.
    if coarse_solver == "eigsh":
        vals0, U0 = eigsh_smallest(K_sp[0], M_sp[0], n_modes)
    else:
        res = lobpcg_from_random(K_ops[0], M_ops[0], n_modes,
                                 max_iter=400, tol=1e-6, dtype=dtype)
        vals0 = np.asarray(res.eigenvalues, dtype=np.float64)
        U0 = np.asarray(res.eigenvectors, dtype=np.float64)

    # Prolongations + smoothed initial guesses (src/samplers.py:264-281).
    P_ops, Pt_ops, U_list = [], [], [jnp.asarray(U0, dtype=dtype)]
    U_prev = U0
    for level in range(1, len(X_list)):
        P = prolongation_matrix(X_list[level - 1], X_list[level],
                                k=prolongation_neighbors).tocsr()
        P_ops.append(as_operator(P, dtype=dtype))
        Pt_ops.append(as_operator(P.T.tocsr(), dtype=dtype))
        U_init = jnp.asarray(P @ U_prev, dtype=dtype)
        U_init = jacobi_smooth(M_ops[level], K_ops[level], U_init,
                               alpha=jacobi_alpha, n_iters=jacobi_iters)
        U_list.append(U_init)
        U_prev = np.asarray(U_init, dtype=np.float64)

    return Hierarchy(
        X_list=X_list, K_ops=K_ops, M_ops=M_ops,
        K_scipy=K_sp, M_scipy=M_sp,
        P_ops=P_ops, Pt_ops=Pt_ops, U_list=U_list,
        edge_index_list=edge_index_list, actual_hierarchy=actual,
        meshes=meshes, indices_per_level=list(indices),
        coarse_eigenvalues=np.asarray(vals0),
        perms=perms,
        build_max_bandwidth=max_bandwidth,
    )
