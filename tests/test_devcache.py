"""Compile-cache placement (utils/devcache.py)."""

import os
import subprocess
import sys
import tempfile

import jax
import pytest

from lr2rmats_tpu.utils import devcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing the process's
    cache settings."""
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    return seen


def test_env_dir_is_used_and_no_other(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert devcache.cache_dir() == str(tmp_path / "cc")
    assert devcache.enable_compile_cache() == str(tmp_path / "cc")
    assert config_updates["jax_compilation_cache_dir"] == str(tmp_path / "cc")


def test_unset_env_uses_repo_dir(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert devcache.cache_dir() == want
    assert devcache.enable_compile_cache() == want
    assert config_updates["jax_compilation_cache_dir"] == want
    assert config_updates["jax_persistent_cache_min_compile_time_secs"] == 0


def test_default_dir_never_depends_on_pid_or_tmp(monkeypatch, tmp_path):
    """Another process with another TMPDIR gets the same fixed path, and
    the path is not under the temp dir (the directory is part of the
    cache key, so a moving one never hits)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(TMPDIR=str(tmp_path), JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", "from lr2rmats_tpu.utils.devcache import "
         "cache_dir; print(cache_dir())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    other = r.stdout.strip()
    assert other == devcache.cache_dir()
    assert not other.startswith(tempfile.gettempdir())
    assert not other.startswith(str(tmp_path))
    assert str(os.getpid()) not in other
