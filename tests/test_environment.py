"""Run-time environment: the compile-cache location, the smoke's refusal of
a CPU backend, and a main path that imports without PyYAML or flax."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from fetalsyngen_tpu import compile_cache

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.cache_dir() == tmp_path / "cc"


def test_compile_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == REPO / ".jax_cache"
    assert path == compile_cache.cache_dir()  # no temp name, pid or time
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_refuses_cpu_backend():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with pytest.raises(RuntimeError, match="no GPU"):
        smoke.phase_device()


def test_main_path_imports_without_yaml_or_flax():
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['flax'] = None\n"
        "import fetalsyngen_tpu.config, fetalsyngen_tpu.generator.model\n"
        "import fetalsyngen_tpu.parallel.input_pipeline, fetalsyngen_tpu.train.step\n"
        "cfg = fetalsyngen_tpu.config.load_yaml('configs/dataset/synth_train.yaml')\n"
        "assert cfg['generator']['shape'] == [256, 256, 256]\n"
        "print('IMPORT-OK')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "IMPORT-OK" in r.stdout, r.stderr[-2000:]
