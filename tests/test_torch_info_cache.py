"""Where the port's kernels are built across processes
(``musicgan_tpu_torch/utils/cache.py``, the cases of ``tests/test_cache.py``
against JAX's ``enable_compilation_cache``) and the ``info`` subcommand, on
this CPU host."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import jax

from musicgan_tpu.utils.cache import enable_compilation_cache as jax_enable_compilation_cache
from musicgan_tpu_torch import native
from musicgan_tpu_torch.ops import _build
from musicgan_tpu_torch.utils.cache import enable_compilation_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_build_dirs(monkeypatch):
    """Whatever a case points the builds at is undone after it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)


def test_cache_noop_on_cpu_primary(monkeypatch):
    """No CUDA device and nothing forced: nothing changes, as JAX's is a
    no-op on a CPU-primary process."""
    monkeypatch.delenv("MUSICGAN_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("MUSICGAN_NO_COMPILE_CACHE", raising=False)
    before = (_build.BUILD_DIR, native.BUILD_DIR)
    assert enable_compilation_cache() is None
    assert jax_enable_compilation_cache() is None
    assert (_build.BUILD_DIR, native.BUILD_DIR) == before
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


def test_cache_enabled_when_forced(tmp_path, monkeypatch):
    """A forced path (the argument, or ``MUSICGAN_COMPILE_CACHE``) is made
    and both build directories point at it, as JAX's cache directory is set."""
    monkeypatch.delenv("MUSICGAN_NO_COMPILE_CACHE", raising=False)
    target = str(tmp_path / "kernels")
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compilation_cache(target) == target
        assert jax_enable_compilation_cache(str(tmp_path / "xla")) == str(tmp_path / "xla")
        assert os.path.isdir(target)
        assert _build.BUILD_DIR == Path(target) and native.BUILD_DIR == target
        assert _build._lib_path("istft").parent == Path(target)
        assert os.path.dirname(native.lib_path()) == target
        env_target = str(tmp_path / "kernels_env")
        monkeypatch.setenv("MUSICGAN_COMPILE_CACHE", env_target)
        assert enable_compilation_cache() == env_target
        assert _build.BUILD_DIR == Path(env_target)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_global_optout_wins(tmp_path, monkeypatch):
    """``MUSICGAN_NO_COMPILE_CACHE`` wins over a forced path: None, as
    JAX's; the builds go to a fresh temporary directory of the process."""
    monkeypatch.setenv("MUSICGAN_NO_COMPILE_CACHE", "1")
    assert jax_enable_compilation_cache(str(tmp_path / "x")) is None
    assert enable_compilation_cache(str(tmp_path / "x")) is None
    first = _build.BUILD_DIR
    assert not (tmp_path / "x").exists()
    assert first.is_dir() and first.name.startswith("musicgan_build_") and native.BUILD_DIR == str(first)
    assert first != _build.DEFAULT_BUILD_DIR
    assert enable_compilation_cache() is None and _build.BUILD_DIR != first


def test_info_subcommand_prints_its_json(tmp_path):
    """``python -m musicgan_tpu_torch info`` on this host: one JSON object
    with JAX's keys (``torch`` for ``jax``), backend ``cpu``, the native
    tail, and the persisted autotune table; no exception."""
    table = {"v1|cuda:test card|istft|513x5120|('xla', 'pallas')": "pallas"}
    (tmp_path / "conv_autotune.json").write_text(json.dumps(table))
    env = dict(os.environ, MUSICGAN_AUTOTUNE_DIR=str(tmp_path))
    env.pop("MUSICGAN_COMPILE_CACHE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "musicgan_tpu_torch", "info"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout)
    assert set(info) == {
        "python", "torch", "backend", "devices", "process_count", "native_ingest", "native_lib",
        "autotune_cache",
    }
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"] and info["process_count"] == 1
    assert info["native_ingest"] is True and info["native_lib"].endswith(".so")
    assert info["autotune_cache"] == table
    assert "Traceback" not in proc.stderr
