"""Compile-cache placement and the GPU-only entry points, checked in
child processes on the CPU."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(args, env_set, env_drop=()):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_set)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("case", ["env_var", "default", "cpu_only"])
def test_compile_cache_placement(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured when set; otherwise the
    cache sits at the fixed in-checkout path; CPU-only runs keep none.
    (Importing the package configures the cache; no backend starts.)"""
    code = "import jax, oatk_tpu; print(jax.config.jax_compilation_cache_dir)"
    drop = ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")
    env = {}
    if case == "env_var":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    if case == "cpu_only":
        env["JAX_PLATFORMS"] = "cpu"
    cp = _child(["-c", code], env, drop)
    assert cp.returncode == 0, cp.stderr
    got = cp.stdout.strip().splitlines()[-1]
    want = {
        "env_var": str(tmp_path / "cc"),
        "default": os.path.join(REPO, ".jax_cache"),
        "cpu_only": "None",
    }[case]
    assert got == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_without_gpu(script):
    """Without a GPU the smoke test and the benchmark exit non-zero and
    report no result."""
    cp = _child([script], {"JAX_PLATFORMS": "cpu"})
    assert cp.returncode != 0
    assert '"ok": true' not in cp.stdout
    assert '"metric"' not in cp.stdout
