"""Process start-up: the compile-cache placement and the optional
dependencies (flax is not needed at all; PyYAML only by Config.from_yaml).

Each case runs in a fresh interpreter, because both are decided when the
package is first imported.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_extra=None, env_drop=()):
    env = dict(os.environ)
    for k in env_drop:
        env.pop(k, None)
    env.update(env_extra or {})
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(env_dir, tmp_path):
    """Without JAX_COMPILATION_CACHE_DIR the package puts the cache at
    the fixed path inside the checkout; with it, JAX's own setting wins
    and the package sets no other directory."""
    code = ("import eigenpinns_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    if env_dir is None:
        got = _run(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
        assert got == os.path.join(REPO, ".jax_cache")
    else:
        d = str(tmp_path / env_dir)
        got = _run(code, env_extra={"JAX_COMPILATION_CACHE_DIR": d})
        assert got == d


def test_compile_cache_import_starts_no_backend():
    """Setting the cache path only writes the config: importing the
    package initializes no JAX backend."""
    code = ("import eigenpinns_tpu; "
            "from jax._src import xla_bridge as xb; "
            "print(len(xb._backends))")
    assert _run(code, env_drop=("JAX_COMPILATION_CACHE_DIR",)) == "0"


_BLOCK = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "yaml"):
            raise ModuleNotFoundError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
"""


def test_package_imports_without_flax_and_yaml():
    code = _BLOCK + """
import importlib, pkgutil
import eigenpinns_tpu
mods = [m.name for m in pkgutil.walk_packages(eigenpinns_tpu.__path__,
                                              "eigenpinns_tpu.")
        if not m.name.endswith("._native")]   # the ctypes library
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""
    assert int(_run(code)) > 40


def test_cli_overrides_without_yaml():
    """Config() and the CLI's --override path need no PyYAML; only
    Config.from_yaml does, and it says so."""
    code = _BLOCK + """
from eigenpinns_tpu import main as m
from eigenpinns_tpu.configs import Config
seen = {}
m.main = lambda cfg: seen.setdefault("cfg", cfg)
m.cli(["--override", "n_modes=7", "hierarchy=[16, 32]", "diagnostics_viz="])
cfg = seen["cfg"]
assert (cfg.n_modes, cfg.hierarchy, cfg.diagnostics_viz) == (7, [16, 32], "")
try:
    Config.from_yaml("unused.yml")
except ModuleNotFoundError as e:
    print("from_yaml needs yaml:", "yaml" in str(e))
"""
    assert _run(code) == "from_yaml needs yaml: True"
