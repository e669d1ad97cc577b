"""chip_smoke.py: importable without a device, refuses to run without a
GPU, and each phase runs end to end at tiny sizes when a test calls it."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke_t", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_imports_without_touching_a_device(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("device touched at import")
    monkeypatch.setattr(jax, "devices", boom)
    monkeypatch.setattr(jax, "local_devices", boom)
    mod = _load()
    assert callable(mod.main)


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    return any(line.startswith('{"ok"') for line in stdout.splitlines())


def test_main_exits_nonzero_without_a_gpu():
    p = _run(ROOT, SCRIPT)
    assert p.returncode != 0
    assert "NoGPUError" in p.stderr
    assert not _printed_result(p.stdout)


def test_exits_nonzero_alone(tmp_path):
    alone = shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    p = _run(str(tmp_path), str(alone))
    assert p.returncode != 0
    assert not _printed_result(p.stdout)


TINY = {
    "flagship": lambda cs, w: cs.phase_flagship(w, n=32, steps=4, io=2),
    "cg3d": lambda cs, w: cs.phase_cg3d(w, n=12, steps=2, io=1),
    "throughput": lambda cs, w: cs.phase_throughput(
        w, n2=32, n3=12, windows=2, steps2=2, steps3=2),
    "reference": lambda cs, w: cs.phase_reference(
        w, n2=32, steps2=6, n3=12, steps3=3),
    "profile": lambda cs, w: cs.phase_profile(w, n=32, steps=4, io=2),
    "four": lambda cs, w: cs.phase_four(
        w, n2=32, n3=12, n_sc=32, steps=2, devices=jax.devices()[:4]),
}
FAMILIES = ("sc", "efs", "basic", "transport", "sc3d", "basic3d",
            "transport3d")


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_runs_tiny_on_cpu(phase, tmp_path):
    TINY[phase](_load(), str(tmp_path))


@pytest.mark.parametrize("family", FAMILIES)
def test_family_phase_runs_tiny_on_cpu(family, tmp_path):
    cs = _load()
    assert family in cs.family_runs(str(tmp_path), 24, 12, 4)
    cs.phase_families(str(tmp_path), n2=24, n3=12, steps=4, only=(family,))


@pytest.mark.gpu
def test_reference_phase_on_gpu(gpu, tmp_path):
    """Phase 6 at its benchmark sizes: f32 on the card within tolerance of
    f64 on the CPU backend."""
    _load().phase_reference(str(tmp_path))
