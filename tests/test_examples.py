"""Smoke-run every example script so they cannot silently rot.

Each example honors EIGENPINNS_SMOKE=1 (seconds-scale miniature sizes).
Run as subprocesses on the CPU backend with an isolated cwd so
relative-path outputs (e.g. outputs/bunny_model.vtu) land in tmp.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.py"))


@pytest.mark.slow
@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.stem)
def test_example_smoke(script, tmp_path):
    env = dict(os.environ)
    env["EIGENPINNS_SMOKE"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{script.name} failed\n--- stdout ---\n{proc.stdout[-3000:]}"
        f"\n--- stderr ---\n{proc.stderr[-3000:]}")
