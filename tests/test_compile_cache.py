"""Placement of the persistent compile cache (utils/compile_cache.py)."""
import jax
import pytest

from bossruns_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("env_dir", [None, "/some/shared/jax-cache"])
def test_cache_dir_comes_from_env_or_repo(monkeypatch, restore_cache_config, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV, env_dir)
    got = compile_cache.configure_compile_cache()
    if env_dir is None:
        assert got == str(compile_cache.DEFAULT_DIR)
        assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
        assert (compile_cache.DEFAULT_DIR.parent / "bossruns_tpu").is_dir()  # repo root
        assert jax.config.jax_compilation_cache_dir == got
    else:
        # the variable is JAX's own setting: left alone, no other dir set
        assert got == env_dir
        assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0
