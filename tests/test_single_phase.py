"""Physics regression tests for the single-phase solver (SURVEY.md section 4:
Poiseuille profile vs analytic, mass conservation)."""

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models.base import RunMetrics, run_chunked
from openlbmpm_tpu.models.single_phase import BoundaryConfig, SinglePhaseD2Q9


def _poiseuille_setup(collision, tau=0.8, nx=34, ny=16, g=1e-6):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    model = SinglePhaseD2Q9(
        geo.from_solid_mask(solid), tau=tau, collision=collision,
        body_force=(0.0, g), dtype=jnp.float64)
    return model, g


@pytest.mark.parametrize("collision", ["SRT", "MRT", "TRT"])
def test_poiseuille_profile(collision):
    model, g = _poiseuille_setup(collision)
    f = model.init_state()
    f = run_chunked(model.step, f, num_steps=6000, io_interval=2000)
    rho, (ux, uy) = model.macro(f)
    uy_prof = np.asarray(uy)[8, 1:-1]

    # analytic: u(x) = g/(2 nu) * ((H/2)^2 - x^2), walls at half-links
    nx = model.geo.nx
    h = nx - 2  # fluid columns
    xs = np.arange(1, nx - 1) - (nx - 1) / 2.0  # distance from centerline
    half = h / 2.0
    analytic = g / (2.0 * model.nu) * (half**2 - xs**2)
    err = np.abs(uy_prof - analytic).max() / analytic.max()
    assert err < 0.02, f"{collision}: rel err {err}"


def test_mass_conservation_closed_channel():
    model, _ = _poiseuille_setup("SRT")
    f = model.init_state()
    m0 = float(jnp.sum(f))
    f = run_chunked(model.step, f, num_steps=500, io_interval=500)
    m1 = float(jnp.sum(f))
    assert abs(m1 - m0) / m0 < 1e-12


def test_zou_he_channel_flux():
    """Velocity inlet at the top + pressure outlet at the bottom: the inlet
    flux must match the prescribed velocity (property test, SURVEY.md
    section 7 hard part 2)."""
    ny, nx = 40, 18
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    v_in = -1e-3
    model = SinglePhaseD2Q9(
        geo.from_solid_mask(solid), tau=0.9,
        boundaries=BoundaryConfig(inlet="zou_he_velocity", outlet="zou_he_pressure",
                                  inlet_velocity=v_in, outlet_density=1.0),
        dtype=jnp.float64)
    f = model.init_state()
    metrics = RunMetrics(model.geo.num_fluid_nodes)
    f = run_chunked(model.step, f, num_steps=4000, io_interval=1000,
                    metrics=metrics)
    rho, (ux, uy) = model.macro(f)
    uy_in = np.asarray(uy)[ny - 2, 1:-1].mean()
    assert abs(uy_in - v_in) / abs(v_in) < 0.05
    assert metrics.mlups > 0
    # steady state: flux is uniform along the channel
    flux = (np.asarray(uy * rho))[5:-5, 1:-1].sum(axis=1)
    assert np.ptp(flux) / np.abs(flux).max() < 0.02


def test_lid_driven_cavity_ghia_re100():
    """Moving-wall link bounce-back through the model
    (``calStreaming1withLinkGPU`` / ``calLinkBounceBack``,
    ``OptimizedD2Q9GPU.py:1664-1692``; the reference keeps the launch
    commented at ``ShanChenD2Q9.py:1595-1599``): lid-driven cavity at
    Re=100, vertical-centerline u_x checked against Ghia, Ghia & Shin
    (1982) — u(center) = -0.20581, min u = -0.21090."""
    n, U = 64, 0.1
    nu = U * n / 100.0
    solid = np.zeros((n + 2, n + 2), bool)
    solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = True
    moving = np.zeros_like(solid)
    moving[-1, :] = True                      # the lid: top solid row
    model = SinglePhaseD2Q9(geo.from_solid_mask(solid), tau=3 * nu + 0.5,
                            collision="SRT", moving_wall_mask=moving,
                            wall_velocity=(U, 0.0), dtype=jnp.float64)
    f = model.init_state(1.0)
    f = run_chunked(model.step, f, num_steps=10000, io_interval=5000)
    rho, (ux, uy) = model.macro(f)
    prof = np.asarray(ux[1:-1, (n + 2) // 2]) / U
    assert np.isfinite(np.asarray(rho)).all()
    assert abs(prof[n // 2] - (-0.20581)) < 0.01, prof[n // 2]
    assert abs(prof.min() - (-0.21090)) < 0.01, prof.min()
    # lid drags the top of the cavity along +x
    assert prof[-1] > 0.9
    # mass stays bounded (wall injects momentum, not mass)
    assert abs(float(jnp.sum(f)) / (n * n) - 1.0) < 1e-2
