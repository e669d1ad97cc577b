"""Where the program runs: the GPU check and the compile-cache location.

The model steps are plain ``jax.numpy``/``lax`` code that XLA compiles for
whatever backend JAX selects; the entry points that measure or smoke-test
the accelerator (``chip_smoke.py``, ``bench.py``) call ``require_gpu`` so
that a run without a GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "NoGPUError", "require_gpu",
           "enable_compile_cache", "card_line", "device_summary"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed path: the cache key includes the directory, so a moving one never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


class NoGPUError(RuntimeError):
    """JAX's default backend is not a GPU."""


def require_gpu(devices=None):
    """Return ``jax.devices()`` if its first device is a GPU, else raise
    ``NoGPUError`` (the CPU included: nothing falls back to it)."""
    if devices is None:
        import jax
        devices = jax.devices()
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise NoGPUError(f"needs an NVIDIA GPU; JAX's default backend is "
                         f"{found}")
    return devices


def enable_compile_cache(environ=None, config=None) -> str:
    """Place JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    environ = os.environ if environ is None else environ
    if environ.get(CACHE_ENV):
        return environ[CACHE_ENV]
    if config is None:
        import jax
        config = jax.config
    config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_line() -> str:
    """``name, power.limit`` of each card, as ``nvidia-smi`` reports them
    (one line per card).  Raises if nvidia-smi cannot be read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out


def device_summary(devices) -> dict:
    """The device keys every measurement line carries."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
