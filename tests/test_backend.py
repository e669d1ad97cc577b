"""The backend module: the GPU check and the compile-cache location."""

import types

import jax
import pytest

from openlbmpm_tpu import backend


class _Config:
    def __init__(self):
        self.updates = {}

    def update(self, name, value):
        self.updates[name] = value


def test_require_gpu_refuses_a_non_gpu_device():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(backend.NoGPUError, match="cpu"):
        backend.require_gpu()
    with pytest.raises(backend.NoGPUError):
        backend.require_gpu([])
    fake = [types.SimpleNamespace(platform="gpu", device_kind="H100")]
    assert backend.require_gpu(fake) is fake
    assert backend.device_summary(fake) == {"platform": "gpu",
                                            "kind": "H100", "count": 1}


def test_compile_cache_honours_the_environment(tmp_path):
    cfg = _Config()
    env = {backend.CACHE_ENV: str(tmp_path)}
    assert backend.enable_compile_cache(env, cfg) == str(tmp_path)
    assert cfg.updates == {}   # JAX reads the variable itself


def test_compile_cache_uses_the_fixed_checkout_path_when_unset():
    cfg = _Config()
    path = backend.enable_compile_cache({}, cfg)
    assert path == backend.DEFAULT_CACHE_DIR
    assert path.endswith(".jax_cache")
    assert cfg.updates == {"jax_compilation_cache_dir": path}
    # an empty variable counts as unset
    assert backend.enable_compile_cache({backend.CACHE_ENV: ""},
                                        _Config()) == path
