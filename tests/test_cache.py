"""Compile-cache policy (utils/cache.py)."""

import os

import jax
import pytest

from orb_slam3_comments_ghr_tpu.utils import cache


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


class TestCompileCachePolicy:
    def test_env_dir_is_left_to_jax(self, monkeypatch, config_calls, tmp_path):
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert cache.setup_compile_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in config_calls
        assert config_calls.get("jax_enable_compilation_cache", True)

    def test_gpu_without_env_uses_fixed_repo_path(self, monkeypatch,
                                                  config_calls):
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        want = os.path.join(cache.REPO_ROOT, ".jax_cache")
        assert cache.setup_compile_cache() == want
        assert config_calls["jax_compilation_cache_dir"] == want
        assert os.path.isfile(os.path.join(cache.REPO_ROOT, "chip_smoke.py"))

    @pytest.mark.parametrize("env_set", [False, True])
    def test_cpu_backend_turns_cache_off(self, monkeypatch, config_calls,
                                         tmp_path, env_set):
        if env_set:
            monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
        else:
            monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert cache.setup_compile_cache() is None
        assert config_calls == {"jax_enable_compilation_cache": False}
