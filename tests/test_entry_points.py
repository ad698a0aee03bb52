"""Entry-point contracts checked in subprocesses: where the compile
cache goes, and that the GPU-only scripts refuse to run on the CPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CACHE_PROBE = (
    "import jax\n"
    "from repas_tpu.utils.compile_cache import configure_compile_cache\n"
    "print(configure_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n")


def _env(**overrides):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(overrides)
    return env


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_placement(tmp_path, preset):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    <checkout>/.jax_cache."""
    env = _env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) if preset else _env()
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    expect = str(tmp_path) if preset else str(ROOT / ".jax_cache")
    assert out == [expect, expect]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU chip_smoke.py exits non-zero and prints no result,
    both in the checkout and copied alone into an empty directory."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_bench_refuses_cpu():
    """bench.py measures the GPU only: on the CPU it exits non-zero
    before printing a record."""
    proc = subprocess.run([sys.executable, "bench.py"], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "needs a GPU" in proc.stderr
