"""Pipeline entry point — parity with `src/main.py`.

Orchestrates: config -> mesh -> hierarchy -> multigrid training -> VTU
export -> diagnostics. Run as

    python -m eigenpinns_tpu.main --config path/to/parameters.yml
    eigenpinns --config ... [--override key=value ...]
"""

from __future__ import annotations

import argparse
import ast
import os

import numpy as np


def main(config) -> np.ndarray:
    from eigenpinns_tpu.diagnostics import comprehensive_diagnostics
    from eigenpinns_tpu.geometry import load_mesh
    from eigenpinns_tpu.io import save_eigenfunctions
    from eigenpinns_tpu.sampling import build_hierarchy
    from eigenpinns_tpu.solvers.multigrid import MultigridTrainer

    print("Loading mesh...")
    mesh = load_mesh(config.mesh_file, normalize=True)

    print("Preprocessing mesh data...")
    hierarchy = build_hierarchy(
        mesh,
        config.hierarchy,
        n_modes=config.n_modes,
        sampler_type=config.sampler_type,
        edge_computation_type=config.edge_computation_type,
        k_neighbors=config.k_neighbors,
        prolongation_neighbors=config.prolongation_neighbors,
        pc_neighbors=config.pc_neighbors,
        coarse_solver=config.coarse_solver,
        seed=config.seed,
        operator_format=config.operator_format,
    )

    print("Training physics-informed multiresolution GNN...")
    trainer = MultigridTrainer(config)
    result = trainer.train(hierarchy)
    print(f"Trained {result.epochs_run} epochs in "
          f"{result.wall_time:.1f}s "
          f"({result.epochs_run / max(result.wall_time, 1e-9):.1f} steps/s)")
    print("Refined eigenvalues (first 10):",
          np.round(result.eigenvalues[:10], 6))

    print("Saving predicted eigenvectors...")
    if config.vtu_file:
        os.makedirs(os.path.dirname(os.path.abspath(config.vtu_file)),
                    exist_ok=True)
        # The finest level is the full mesh for point samplers; export on
        # the finest level's geometry.
        finest_mesh = hierarchy.meshes[-1]
        save_eigenfunctions(config.vtu_file, finest_mesh,
                            hierarchy.to_original_order(result.eigenvectors),
                            config.n_modes)

    print("Run diagnostics...")
    comprehensive_diagnostics(
        result.eigenvectors,
        hierarchy.K_scipy[-1],
        hierarchy.M_scipy[-1],
        n_modes=config.n_modes,
        plot_path=config.diagnostics_viz or None,
    )
    return result.eigenvectors


def cli(argv=None) -> None:
    from eigenpinns_tpu.configs import Config

    ap = argparse.ArgumentParser(
        prog="eigenpinns",
        description="physics-informed eigensolver pipeline")
    ap.add_argument("--config", default=None,
                    help="sectioned YAML config (reference parameters.yml "
                         "format); defaults apply when omitted")
    ap.add_argument("--override", nargs="*", default=[], action="extend",
                    metavar="KEY=VALUE",
                    help="config overrides, e.g. n_modes=10 epochs=2000; "
                         "repeated --override flags accumulate")
    args = ap.parse_args(argv)

    config = Config.from_yaml(args.config) if args.config else Config()
    overrides = {}
    for item in args.override:
        key, _, value = item.partition("=")
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value
    if overrides:
        config = config.override(**overrides)
    main(config)


if __name__ == "__main__":
    cli()
