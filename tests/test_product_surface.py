"""M5 product surface: CLI, config loaders, IO writer, checkpoint/cycles,
metrics (SURVEY.md section 7 M5)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu.checkpoint import (config_fingerprint, di_cycle_swap,
                                      load_checkpoint, save_checkpoint)
from openlbmpm_tpu.cli import main as cli_main
from openlbmpm_tpu.config import (load_colorgradient, load_shanchen,
                                  load_transport)
from openlbmpm_tpu.io import ResultWriter, append_series
from openlbmpm_tpu.metrics import (MetricsLogger, flow_diagnostics,
                                   measured_contact_angle)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_load_colorgradient_config():
    params, bcs, domain, run = load_colorgradient(
        os.path.join(CONFIGS, "rk_csf2d.ini"))
    assert params.variant == "CSF"
    assert params.collision == "MRT"
    assert params.surface_tension == 0.1
    assert bcs.inlet == "neumann"
    assert bcs.outlet == "dirichlet"
    assert domain.ny == 256
    assert run.io_interval == 2500


def test_load_shanchen_config():
    params, bcs, domain, run, extras = load_shanchen(
        os.path.join(CONFIGS, "twophasesetup.ini"),
        os.path.join(CONFIGS, "shanchen2D.ini"))
    assert params.scheme == "SC"
    assert params.g_matrix[0][1] == 3.8
    assert params.g_solid == (-0.4, 0.4)
    assert bcs.inlet == "zou_he_velocity"
    assert bcs.outlet == "convective"
    assert extras["background_densities"] == (0.02, 0.02)


def test_load_transport_config():
    tp = load_transport(os.path.join(CONFIGS, "transportsetup.ini"))
    assert tp.scheme == 5
    assert tp.inlet == "inamuro"
    assert tp.outlet == "freeflow"


def test_result_writer_roundtrip(tmp_path):
    w = ResultWriter(str(tmp_path), basename="T")
    rho = np.arange(12.0).reshape(3, 4)
    w.write_rk(100, rho, rho * 2, rho * 3, rho * 4)
    back = w.read(100, "FluidMacro/FluidDensityRin100")
    np.testing.assert_array_equal(back, rho)
    back_b = w.read(100, "FluidMacro/FluidDensityBin100")
    np.testing.assert_array_equal(back_b, rho * 2)


def test_append_series(tmp_path):
    p = str(tmp_path / "s.dat")
    append_series(p, 10, 1.5, 2.5)
    append_series(p, 20, 3.5)
    lines = open(p).read().splitlines()
    assert lines[0].split() == ["10", "1.5", "2.5"]


def test_checkpoint_roundtrip_and_fingerprint(tmp_path):
    state = (jnp.arange(18.0).reshape(2, 3, 3),
             jnp.ones((2, 3, 3)))
    fp = config_fingerprint({"tau": 1.0})
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state, 42, fp)
    loaded, step = load_checkpoint(path, state, fp)
    assert step == 42
    np.testing.assert_array_equal(np.asarray(loaded[0]),
                                  np.asarray(state[0]))
    with pytest.raises(ValueError):
        load_checkpoint(path, state, config_fingerprint({"tau": 2.0}))


def test_di_cycle_swap():
    f_r = jnp.zeros((9, 8, 4)).at[:, 6:, :].set(1.0)
    f_b = jnp.ones((9, 8, 4)).at[:, 6:, :].set(0.0)
    nr, nb = di_cycle_swap(f_r, f_b, buffer_rows=2, top=True)
    # buffer rows swapped, interior untouched
    assert float(jnp.sum(nr[:, 6:, :])) == 0.0
    assert float(jnp.sum(nb[:, 6:, :])) == 9 * 2 * 4
    np.testing.assert_array_equal(np.asarray(nr[:, :6]),
                                  np.asarray(f_r[:, :6]))


def test_flow_diagnostics_breakthrough():
    ny, nx = 16, 8
    rho_inv = np.zeros((ny, nx))
    rho_inv[4:, :] = 1.0   # front at row 4
    rho_def = 1.0 - rho_inv
    fl = np.ones((ny, nx), bool)
    d = flow_diagnostics(jnp.asarray(rho_inv), jnp.asarray(rho_def),
                         jnp.zeros((ny, nx)), jnp.zeros((ny, nx)), fl)
    assert d["front_row"] == 4
    assert not d["breakthrough"]
    rho_inv[0:, :] = 1.0
    d2 = flow_diagnostics(jnp.asarray(rho_inv), jnp.asarray(1 - rho_inv),
                          jnp.zeros((ny, nx)), jnp.zeros((ny, nx)), fl)
    assert d2["breakthrough"]


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "m.jsonl")
    log = MetricsLogger(p, active_sites=100)
    log.log(0, umax=0.1, breakthrough=False)
    log.log(10, umax=0.2, breakthrough=True)
    log.close()
    recs = [json.loads(x) for x in open(p)]
    assert recs[1]["breakthrough_step"] == 10
    assert "mlups" in recs[1]


def test_measured_contact_angle_flat():
    # half-circle on the wall => ~90 degrees
    ny, nx = 32, 64
    yy, xx = np.mgrid[0:ny, 0:nx]
    drop = (yy - 2.0) ** 2 + (xx - 32.0) ** 2 <= 100.0
    theta = measured_contact_angle(drop, wall_row=2)
    assert 80.0 < theta < 100.0


def test_cli_run_cg_small(tmp_path):
    """End-to-end CLI: tiny CSF run writes results, metrics, checkpoint."""
    cfg = str(tmp_path / "small.ini")
    with open(os.path.join(CONFIGS, "rk_csf2d.ini")) as fh:
        txt = fh.read()
    txt = txt.replace("xDomain = 128", "xDomain = 24")
    txt = txt.replace("yDomain = 256", "yDomain = 48")
    txt = txt.replace("numBufferingLayers = 10", "numBufferingLayers = 0")
    txt = txt.replace("TimeSteps = 20000", "TimeSteps = 20")
    txt = txt.replace("TimeInterval = 2500", "TimeInterval = 10")
    with open(cfg, "w") as fh:
        fh.write(txt)
    out = str(tmp_path / "out")
    rc = cli_main(["run", cfg, "--model", "cg", "--output", out])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "metrics.jsonl"))
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert any(r["step"] >= 20 for r in recs)
    # resume path: runs from the checkpoint without error
    rc2 = cli_main(["run", cfg, "--model", "cg", "--output", out,
                    "--resume", "--steps", "10"])
    assert rc2 == 0


def test_cli_run_with_profile(tmp_path):
    """--profile DIR captures a jax.profiler trace of the first
    post-compile chunk (phases annotated via jax.named_scope in the
    step; SURVEY.md section 5 tracing guidance)."""
    cfg = str(tmp_path / "small.ini")
    with open(os.path.join(CONFIGS, "rk_csf2d.ini")) as fh:
        txt = fh.read()
    txt = txt.replace("xDomain = 128", "xDomain = 24")
    txt = txt.replace("yDomain = 256", "yDomain = 48")
    txt = txt.replace("numBufferingLayers = 10", "numBufferingLayers = 0")
    txt = txt.replace("TimeSteps = 20000", "TimeSteps = 20")
    txt = txt.replace("TimeInterval = 2500", "TimeInterval = 5")
    with open(cfg, "w") as fh:
        fh.write(txt)
    out = str(tmp_path / "out")
    trace = str(tmp_path / "trace")
    rc = cli_main(["run", cfg, "--model", "cg", "--output", out,
                   "--profile", trace])
    assert rc == 0
    captured = [os.path.join(dp, f) for dp, _, fs in os.walk(trace)
                for f in fs]
    assert captured, "profiler trace directory is empty"


def test_cli_inspect(tmp_path, capsys):
    rc = cli_main(["inspect", os.path.join(CONFIGS, "rk_csf2d.ini"),
                   "--model", "cg"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "surface_tension" in out


def test_load_colorgradient3d_config():
    from openlbmpm_tpu.config import load_colorgradient3d
    params, dom, run, extras = load_colorgradient3d(
        os.path.join(CONFIGS, "rk_csf3d.ini"))
    assert dom["nz"] == 96 and dom["nx"] == 32
    assert params.surface_tension == 0.005
    assert extras["velocity_z"] == -1.0e-4
    assert run.num_steps == 1000


def test_nan_guard_raises_on_divergence():
    from openlbmpm_tpu.models.base import run_chunked

    def bad_step(s):
        return s * jnp.inf

    with pytest.raises(FloatingPointError, match="non-finite"):
        run_chunked(bad_step, jnp.ones((4, 4)), num_steps=4, io_interval=2,
                    nan_guard=True, donate=False)


def test_cli_run_sc_with_resume(tmp_path):
    """SC CLI: run, checkpoint, resume with D-I cycle swap."""
    main_cfg = str(tmp_path / "main.ini")
    phys_cfg = str(tmp_path / "phys.ini")
    txt = open(os.path.join(CONFIGS, "twophasesetup.ini")).read()
    txt = txt.replace("xGrid = 64", "xGrid = 24")
    txt = txt.replace("yGrid = 200", "yGrid = 48")
    open(main_cfg, "w").write(txt)
    ptxt = open(os.path.join(CONFIGS, "shanchen2D.ini")).read()
    ptxt = ptxt.replace("numberTimeStep = 10000", "numberTimeStep = 20")
    open(phys_cfg, "w").write(ptxt)
    out = str(tmp_path / "out")
    rc = cli_main(["run", main_cfg, "--model", "sc",
                   "--physics-config", phys_cfg, "--output", out])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    # resume with cycles on (swaps fluids in the buffer rows)
    txt2 = txt.replace("[DICycles]\nOption = 'no'",
                       "[DICycles]\nOption = 'yes'")
    open(main_cfg, "w").write(txt2)
    rc2 = cli_main(["run", main_cfg, "--model", "sc",
                    "--physics-config", phys_cfg, "--output", out,
                    "--resume", "--steps", "10"])
    assert rc2 == 0


def test_di_cycle_swap_sc():
    from openlbmpm_tpu.checkpoint import di_cycle_swap_sc
    f = jnp.zeros((2, 9, 8, 4))
    f = f.at[0, :, 6:, :].set(1.0)
    f = f.at[1, :, :6, :].set(2.0)
    out = di_cycle_swap_sc(f, buffer_rows=2, top=True)
    assert float(jnp.sum(out[0, :, 6:, :])) == 0.0   # fluid 0 left buffer
    assert float(jnp.sum(out[1, :, 6:, :])) == 9 * 2 * 4  # fluid 1 took it
    np.testing.assert_array_equal(np.asarray(out[:, :, :6]),
                                  np.asarray(f[:, :, :6]))


def test_cli_run_cg3d_with_resume(tmp_path):
    """End-to-end 3D CLI: tiny D3Q19 CSF run writes results, metrics,
    checkpoint; --resume restarts from it."""
    cfg = str(tmp_path / "small3d.ini")
    with open(os.path.join(CONFIGS, "rk_csf3d.ini")) as fh:
        txt = fh.read()
    txt = txt.replace("xDomain = 32", "xDomain = 12")
    txt = txt.replace("yDomain = 32", "yDomain = 12")
    txt = txt.replace("zDomain = 96", "zDomain = 24")
    txt = txt.replace("TimeSteps = 1000", "TimeSteps = 10")
    txt = txt.replace("TimeInterval = 500", "TimeInterval = 5")
    with open(cfg, "w") as fh:
        fh.write(txt)
    out = str(tmp_path / "out3d")
    rc = cli_main(["run", cfg, "--model", "cg3d", "--output", out])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert any(r["step"] >= 10 for r in recs)
    rc2 = cli_main(["run", cfg, "--model", "cg3d", "--output", out,
                    "--resume", "--steps", "5"])
    assert rc2 == 0
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert any(r["step"] >= 15 for r in recs)


def test_cli_run_basic_with_resume(tmp_path):
    """Single-phase CLI (the reference's BasicD2Q9/basicsetup.ini surface):
    body-force channel flow runs, logs, checkpoints, resumes."""
    cfg = str(tmp_path / "basic.ini")
    txt = open(os.path.join(CONFIGS, "basicsetup.ini")).read()
    txt = txt.replace("nx = 512", "nx = 16")
    txt = txt.replace("ny = 1024", "ny = 32")
    txt = txt.replace("TimeLength = 20000", "TimeLength = 20")
    txt = txt.replace("TimeInterval = 2500", "TimeInterval = 10")
    txt = txt.replace("xDomain = 1,510", "xDomain = 1,14")
    txt = txt.replace("yDomain = 0,1023", "yDomain = 0,31")
    open(cfg, "w").write(txt)
    out = str(tmp_path / "out")
    rc = cli_main(["run", cfg, "--model", "basic", "--output", out])
    assert rc == 0
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert any(r["step"] >= 20 and r["umax"] > 0 for r in recs)
    rc2 = cli_main(["run", cfg, "--model", "basic", "--output", out,
                    "--resume", "--steps", "10"])
    assert rc2 == 0


def test_cli_run_sc3d_small(tmp_path):
    """3D Shan-Chen CLI route (--model sc3d): tiny D3Q19 MCMP droplet run
    writes results, metrics, checkpoint."""
    cfg = str(tmp_path / "sc3d.ini")
    txt = open(os.path.join(CONFIGS, "shanchen3d.ini")).read()
    txt = txt.replace("xDomain = 32", "xDomain = 12")
    txt = txt.replace("yDomain = 32", "yDomain = 12")
    txt = txt.replace("zDomain = 64", "zDomain = 16")
    txt = txt.replace("numberTimeStep = 1000", "numberTimeStep = 10")
    txt = txt.replace("TimeInterval = 500", "TimeInterval = 5")
    txt = txt.replace("DropletRadius = 8.0", "DropletRadius = 4.0")
    open(cfg, "w").write(txt)
    out = str(tmp_path / "out")
    rc = cli_main(["run", cfg, "--model", "sc3d", "--output", out])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert any(r["step"] >= 10 for r in recs)
    assert all(np.isfinite(r["mass_invading"]) for r in recs)


def test_cli_run_basic3d_with_resume(tmp_path):
    """3D single-phase CLI route (--model basic3d): body-force channel
    runs, logs, checkpoints, resumes."""
    cfg = str(tmp_path / "basic3d.ini")
    txt = open(os.path.join(CONFIGS, "basic3d.ini")).read()
    txt = txt.replace("nx = 32", "nx = 12")
    txt = txt.replace("ny = 32", "ny = 12")
    txt = txt.replace("nz = 64", "nz = 16")
    txt = txt.replace("TimeLength = 1000", "TimeLength = 10")
    txt = txt.replace("TimeInterval = 500", "TimeInterval = 5")
    open(cfg, "w").write(txt)
    out = str(tmp_path / "out")
    rc = cli_main(["run", cfg, "--model", "basic3d", "--output", out])
    assert rc == 0
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert any(r["step"] >= 10 for r in recs)
    rc2 = cli_main(["run", cfg, "--model", "basic3d", "--output", out,
                    "--resume", "--steps", "5"])
    assert rc2 == 0


def test_cli_run_transport3d_small(tmp_path):
    """Coupled 3D flow + tracer CLI route (--model transport3d): the
    transport INI rides in config, the 3D flow INI in --physics-config."""
    tcfg = str(tmp_path / "tr.ini")
    txt = open(os.path.join(CONFIGS, "transportsetup.ini")).read()
    # the 3D tracer BC surface is 'none' (SURVEY: the reference ships no
    # 3D transport); strip the 2D-only inlet selection
    txt = txt.replace("InletType = 'Inamuro'", "InletType = 'none'")
    open(tcfg, "w").write(txt)
    fcfg = str(tmp_path / "flow3d.ini")
    txt = open(os.path.join(CONFIGS, "rk_csf3d.ini")).read()
    txt = txt.replace("xDomain = 32", "xDomain = 12")
    txt = txt.replace("yDomain = 32", "yDomain = 12")
    txt = txt.replace("zDomain = 96", "zDomain = 16")
    txt = txt.replace("TimeSteps = 1000", "TimeSteps = 10")
    txt = txt.replace("TimeInterval = 500", "TimeInterval = 5")
    open(fcfg, "w").write(txt)
    out = str(tmp_path / "out")
    rc = cli_main(["run", tcfg, "--model", "transport3d",
                   "--physics-config", fcfg, "--output", out])
    assert rc == 0
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert recs and all(np.isfinite(r["tracer0_mass"]) for r in recs)


def test_cli_inspect_new_models(tmp_path, capsys):
    for model, cfg in (("sc3d", "shanchen3d.ini"),
                       ("basic3d", "basic3d.ini"),
                       ("transport3d", "transportsetup.ini")):
        rc = cli_main(["inspect", os.path.join(CONFIGS, cfg),
                       "--model", model])
        assert rc == 0
        out = capsys.readouterr().out
        assert out.strip().startswith("{")
