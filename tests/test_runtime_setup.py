"""Process set-up shared by the CLI, the tests and the benchmark: where the
compile cache lives, and how many devices a conversion may ask for."""

import jax
import pytest

from mlvfs_tpu.utils import cache


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_defaults_to_the_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable_compile_cache() == cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == cache.REPO_CACHE_DIR
    assert cache.REPO_CACHE_DIR.endswith(".jax_cache")


def test_devices_beyond_the_device_count_raise(tmp_clip, tmp_path):
    from mlvfs_tpu import cli
    from mlvfs_tpu.format.reader import MLVClip
    from mlvfs_tpu.pipeline.config import ProcessingConfig
    from mlvfs_tpu.pipeline.convert import ClipConverter

    path, _spec = tmp_clip
    too_many = len(jax.devices()) + 1
    with MLVClip(path) as clip, pytest.raises(ValueError, match="more devices"):
        ClipConverter(clip, ProcessingConfig(shard_devices=too_many))
    with pytest.raises(ValueError, match="more devices"):
        cli.main(["convert", path, "-o", str(tmp_path / "out"), "--devices", str(too_many)])
