"""The persistent compilation cache lives at one fixed directory."""

import os

import jax
import pytest

from topk_rec_tpu.utils import compile_cache

_update = jax.config.update


@pytest.fixture
def set_cache_dir():
    """Set the process's configured cache directory; restored after."""
    old = jax.config.jax_compilation_cache_dir
    yield lambda path: _update("jax_compilation_cache_dir", path)
    _update("jax_compilation_cache_dir", old)


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    return calls


def test_env_var_honoured_and_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _spy(monkeypatch)
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == []


@pytest.mark.parametrize("subdir", ["jax", "jax_cpu"])
def test_default_is_fixed_checkout_path(set_cache_dir, monkeypatch, subdir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    set_cache_dir(None)
    calls = _spy(monkeypatch)
    got = compile_cache.configure_compile_cache(subdir)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".cache", subdir)
    assert calls == [("jax_compilation_cache_dir", got)]


def test_already_configured_directory_kept(set_cache_dir, monkeypatch,
                                           tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    set_cache_dir(str(tmp_path))
    calls = _spy(monkeypatch)
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == []
