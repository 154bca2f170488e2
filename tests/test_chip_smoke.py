"""chip_smoke.py: its refusal without a GPU, and its phases rehearsed at
tiny sizes on the CPU (the card runs them at full size)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run_smoke(script: str, cwd: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_refuses_without_gpu():
    proc = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert not _has_result(proc.stdout)


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


@pytest.fixture(scope="module")
def cloud():
    return cs.cloud_problem(2000)


def test_phase_cli_tiny(tmp_path):
    # 4 modes: the 162-vertex surface's modes 1-3 are well separated
    # from mode 4, so the polish converges them.
    cfg = dict(cs.BENCH_MG, n_modes=4, hierarchy=[48, 96],
               hidden_layers=[32, 32], epochs=100, scan_chunk=50)
    errs = cs.phase_cli(str(tmp_path), subdivisions=2, config=cfg)
    assert set(errs) == {"ell", "auto"}
    assert max(errs.values()) <= cs.EIG_TOL
    assert os.path.exists(tmp_path / "smoke_auto.vtu")


def test_phase_operators_tiny(cloud):
    X, L, _ = cloud
    res = cs.phase_operators(L, X, ks=(3, 16))
    # five formats at k in {3, 16}; rolling and bsr at three precisions
    assert len(res) == 2 * (3 + 2 * 3)
    assert max(e for errs in res.values() for e in errs) <= cs.OP_TOL["bf16"]


def test_phase_training_tiny(cloud):
    X, L, M = cloud
    res = cs.phase_training(L, M, X, k=5, hidden=(32, 32), epochs=100,
                            lobpcg_iters=100, guard=4)
    assert res["defect"] <= cs.ORTH_TOL
    assert np.all(np.asarray(res["residuals"])
                  < np.asarray(res["start_residuals"]))


def test_phase_multi_tiny(cloud):
    X, L, M = cloud
    res = cs.phase_multi(X, L, M, n_devices=4, k=4, hidden=(16, 16),
                         epochs=40, scan_chunk=20, lobpcg_iters=40,
                         levels=(64, 256), mg_hidden=(16, 16), mg_epochs=20)
    assert res["train_joint"]["loss"] <= cs.TRAJ_TOL
    assert res["lobpcg"] <= cs.EIGVAL_TOL
    assert res["multigrid"]["loss"] <= cs.MG_TRAJ_TOL
    assert res["multigrid"]["eigenvalues"] <= cs.EIGVAL_TOL
    assert len(res["peak_bytes_in_use_sharded_solvers"]) == 4
    assert len(res["peak_bytes_in_use"]) == 4


def test_residual_referee_scales_the_constant_mode():
    """The lam ~ 0 mode is scaled by the first nonzero eigenvalue, so an
    exact eigenbasis gives ~0 residuals and an identity Gram."""
    import scipy.sparse as sp

    from eigenpinns_tpu.utils import laplacian_1d

    K = laplacian_1d(50).tolil()
    K[0, 0] = K[-1, -1] = 1.0          # Neumann: constant null vector
    K = K.tocsr()
    M = sp.identity(50, format="csr")
    vals, vecs = np.linalg.eigh(K.toarray())
    lam, res, defect = cs.residual_referee(vecs[:, :4], K, M)
    assert abs(lam[0]) < 1e-10
    assert res.max() < 1e-8 and defect < 1e-10
