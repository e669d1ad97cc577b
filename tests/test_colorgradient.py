"""Physics tests for the color-gradient model: Laplace law, mass
conservation, static contact angle (SURVEY.md section 4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models.base import run_chunked
from openlbmpm_tpu.models.colorgradient import (
    CGBoundaryConfig, ColorGradientParams, ColorGradientRK)


def _droplet_model(variant="CSF", collision="SRT", sigma=0.01, n=64,
                   tau_r=1.0, tau_b=1.0):
    solid = np.zeros((n, n), bool)  # fully periodic, no walls
    # equal unit densities => matched RK alphas (4/9 reduces the RK original
    # equilibrium to the standard D2Q9 weights); mismatched alphas encode a
    # density ratio and would crush the droplet.
    params = ColorGradientParams(
        variant=variant, collision=collision, surface_tension=sigma,
        tau_r=tau_r, tau_b=tau_b, beta=0.7, a_kr=sigma, a_kb=sigma,
        alpha_r=4.0 / 9.0, alpha_b=4.0 / 9.0)
    return ColorGradientRK(geo.from_solid_mask(solid), params,
                           CGBoundaryConfig(), dtype=jnp.float64)


@pytest.mark.parametrize("collision", ["SRT", "MRT"])
def test_laplace_law_csf(collision):
    sigma = 0.01
    radius = 14.0
    model = _droplet_model("CSF", collision, sigma)
    state = model.init_state_droplet(1.0, 1.0, radius=radius, background=0.0)
    state = run_chunked(model.step, state, num_steps=3000, io_interval=1000)
    rho_r, rho_b, phi, (ux, uy) = model.macro(state)
    phi = np.asarray(phi)
    rho = np.asarray(rho_r + rho_b)
    p = rho / 3.0
    inside = phi > 0.8
    outside = phi < -0.8
    # measured radius from droplet area
    r_meas = np.sqrt(inside.sum() / np.pi)
    dp = p[inside].mean() - p[outside].mean()
    dp_analytic = sigma / r_meas
    assert dp > 0
    assert abs(dp - dp_analytic) / dp_analytic < 0.15, (dp, dp_analytic)


def test_mass_conservation_per_color():
    model = _droplet_model("CSF", "SRT")
    state = model.init_state_droplet(1.0, 1.0, radius=12.0)
    m_r0 = float(jnp.sum(state[0]))
    m_b0 = float(jnp.sum(state[1]))
    state = run_chunked(model.step, state, num_steps=500, io_interval=500)
    assert abs(float(jnp.sum(state[0])) - m_r0) / m_r0 < 1e-12
    assert abs(float(jnp.sum(state[1])) - m_b0) / m_b0 < 1e-12


def test_spurious_currents_bounded():
    model = _droplet_model("CSF", "SRT", sigma=0.01)
    state = model.init_state_droplet(1.0, 1.0, radius=14.0)
    state = run_chunked(model.step, state, num_steps=2000, io_interval=1000)
    _, _, _, (ux, uy) = model.macro(state)
    umax = float(jnp.max(jnp.sqrt(ux**2 + uy**2)))
    assert umax < 0.01, umax


def test_laplace_law_perturbation_variant():
    sigma_param = 0.005
    model = _droplet_model("Perturbation", "SRT", sigma_param)
    state = model.init_state_droplet(1.0, 1.0, radius=14.0, background=0.0)
    state = run_chunked(model.step, state, num_steps=2000, io_interval=1000)
    rho_r, rho_b, phi, _ = model.macro(state)
    phi = np.asarray(phi)
    # droplet must stay intact and phase-separated
    assert (phi > 0.9).sum() > 300
    assert (phi < -0.9).sum() > 2000
    # pressure jump positive across the interface
    rho = np.asarray(rho_r + rho_b)
    p = rho / 3.0
    dp = p[phi > 0.8].mean() - p[phi < -0.8].mean()
    assert dp > 0


def test_static_contact_angle_neutral_wetting():
    """theta = 90 deg: a droplet sitting on a flat wall must keep a
    half-circle shape => measured angle ~ 90 deg (spherical-cap fit as in
    ``ShanChenD2Q9.calMeasuredContactAngle:864-886``)."""
    n = 64
    solid = np.zeros((n, n), bool)
    solid[:2, :] = True  # floor
    params = ColorGradientParams(
        variant="CSF", collision="SRT", surface_tension=0.01,
        contact_angle_deg=90.0, wetting_type=2)
    model = ColorGradientRK(geo.from_solid_mask(solid), params,
                            CGBoundaryConfig(), dtype=jnp.float64)
    state = model.init_state_droplet(1.0, 1.0, center=(2.0, n / 2),
                                     radius=12.0)
    state = run_chunked(model.step, state, num_steps=3000, io_interval=1500)
    _, _, phi, _ = model.macro(state)
    phi = np.asarray(phi)
    drop = phi > 0.0
    drop[:2, :] = False
    base = drop[2, :].sum()          # base chord length
    height = drop[:, n // 2].sum()   # cap height
    # spherical-cap: R = (base^2/4 + h^2) / (2h), cos(theta) = (R - h)/R
    r_cap = (base**2 / 4.0 + height**2) / (2.0 * height)
    cos_theta = (r_cap - height) / r_cap
    theta = np.degrees(np.arccos(np.clip(cos_theta, -1, 1)))
    assert 75.0 < theta < 105.0, theta


def test_modified_periodic_color_swap_outlet():
    """modified_periodic outlet: the invading red front re-enters the
    domain as blue at the seam — total mass conserved, colors swap."""
    n = 32
    params = ColorGradientParams(variant="CSF", collision="SRT",
                                 surface_tension=0.0)
    bcs = CGBoundaryConfig(inlet="periodic", outlet="modified_periodic")
    model = ColorGradientRK(geo.from_solid_mask(np.zeros((n, n), bool)),
                            params, bcs, dtype=jnp.float64)
    state = model.init_state_layers(1.0, 1.0, invading_rows=6,
                                    background=0.0)
    m_tot0 = float(jnp.sum(state[0]) + jnp.sum(state[1]))
    state = run_chunked(model.step, state, num_steps=50, io_interval=50)
    m_tot = float(jnp.sum(state[0]) + jnp.sum(state[1]))
    assert abs(m_tot - m_tot0) / m_tot0 < 1e-12


def test_capillary_intrusion_direction():
    """Canonical reference validation (README.md:54-63 'CapillaryRise'):
    a wetting fluid spontaneously intrudes a narrow slot, a non-wetting one
    does not.  Compare red mass inside the slot after the same number of
    steps for theta = 45 vs theta = 135."""
    ny, nx = 64, 32
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    # slot walls for y < 40: open channel of width 8 (columns 12..19)
    solid[:40, 1:12] = True
    solid[:40, 20:-1] = True
    masses = {}
    for theta in (45.0, 135.0):
        params = ColorGradientParams(
            variant="CSF", collision="SRT", surface_tension=0.05,
            contact_angle_deg=theta, wetting_type=2, beta=0.7)
        model = ColorGradientRK(geo.from_solid_mask(solid), params,
                                CGBoundaryConfig(), dtype=jnp.float64)
        # red reservoir fills the open region above the slot
        state = model.init_state_layers(1.0, 1.0, invading_rows=22)
        m0 = float(jnp.sum(jnp.sum(state[0], axis=0)[:38, 12:20]))
        state = run_chunked(model.step, state, num_steps=3000,
                            io_interval=1500)
        rho_r = jnp.sum(state[0], axis=0)
        masses[theta] = float(jnp.sum(rho_r[:38, 12:20])) - m0
    # wetting intrudes, non-wetting at most marginally
    assert masses[45.0] > 3.0, masses
    assert masses[45.0] > 4.0 * max(masses[135.0], 0.1), masses


@pytest.mark.parametrize("theta", [60.0, 120.0])
def test_static_contact_angle_sweep(theta):
    """Measured spherical-cap angle tracks the input theta (+-15 deg)."""
    n = 64
    solid = np.zeros((n, n), bool)
    solid[:2, :] = True
    params = ColorGradientParams(
        variant="CSF", collision="SRT", surface_tension=0.01,
        contact_angle_deg=theta, wetting_type=2)
    model = ColorGradientRK(geo.from_solid_mask(solid), params,
                            CGBoundaryConfig(), dtype=jnp.float64)
    state = model.init_state_droplet(1.0, 1.0, center=(2.0, n / 2),
                                     radius=12.0)
    state = run_chunked(model.step, state, num_steps=4000, io_interval=2000)
    _, _, phi, _ = model.macro(state)
    phi = np.asarray(phi)
    drop = phi > 0.0
    drop[:2, :] = False
    base = drop[2, :].sum()
    height = drop[:, n // 2].sum()
    r_cap = (base**2 / 4.0 + height**2) / (2.0 * height)
    cos_theta = (r_cap - height) / r_cap
    meas = np.degrees(np.arccos(np.clip(cos_theta, -1, 1)))
    assert abs(meas - theta) < 15.0, (meas, theta)


@pytest.mark.parametrize("variant,collision", [
    ("CSF", "SRT"), ("CSF", "MRT"), ("Perturbation", "SRT")])
def test_compressed_state_matches_split(variant, collision):
    """The compressed (f_total, rho_r) step tracks the split (f_r, f_b)
    step: identical trajectories of (f_r + f_b, sum f_r) to fp roundoff
    (f64, few steps — the tau(phi) selects amplify roundoff discretely
    once |phi| ~ delta interface cells accumulate noise)."""
    n = 32
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    kw = dict(variant=variant, collision=collision, surface_tension=0.01,
              tau_r=1.0, tau_b=0.8)
    if variant == "CSF":
        kw.update(tau_type=2, wetting_type=2)
    else:
        kw.update(a_kr=0.005, a_kb=0.003, alpha_r=4 / 9, alpha_b=4 / 9,
                  solid_phi=0.5)
    params = ColorGradientParams(**kw)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    m = ColorGradientRK(geo.from_solid_mask(solid), params, bcs,
                        dtype=jnp.float64)
    f_r, f_b = m.init_state_layers(1.0, 1.0, invading_rows=8)
    s = m.pack_state(f_r, f_b)
    for _ in range(6):
        f_r, f_b = m._step_impl(f_r, f_b)
        s = m._step_impl_c(s)
    assert float(jnp.max(jnp.abs((f_r + f_b) - s[:9]))) < 1e-12
    assert float(jnp.max(jnp.abs(jnp.sum(f_r, 0) - s[9]))) < 1e-12
    # diagnostics agree
    rho_r_a, rho_b_a, phi_a, (ux_a, uy_a) = m.macro((f_r, f_b))
    rho_r_b, rho_b_b, phi_b, (ux_b, uy_b) = m.macro_c(s)
    assert float(jnp.max(jnp.abs(rho_r_a - rho_r_b))) < 1e-12
    assert float(jnp.max(jnp.abs(ux_a - ux_b))) < 1e-12


def _washburn_run(tau_b, steps=2400, ny=96, nx=32, w=8, theta=45.0,
                  sigma=0.05):
    """Capillary intrusion into a slot of width `w`; returns (t, l(t))
    sampled every 100 steps, l = red mass in the slot / w."""
    c0 = (nx - w) // 2
    slot_top = ny - 28
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    solid[:slot_top, 1:c0] = True
    solid[:slot_top, c0 + w:-1] = True
    params = ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=sigma,
        contact_angle_deg=theta, wetting_type=2, beta=0.7, tau_type=2,
        tau_r=1.0, tau_b=tau_b)
    model = ColorGradientRK(geo.from_solid_mask(solid), params,
                            CGBoundaryConfig(), dtype=jnp.float64)
    state = model.init_state_layers(1.0, 1.0,
                                    invading_rows=ny - slot_top - 4)
    m0 = np.asarray(jnp.sum(state[0], axis=0))[:slot_top, c0:c0 + w].sum()
    import jax
    step = jax.jit(model._step_impl)
    ts, ls = [], []
    s = state
    for k in range(steps // 100):
        for _ in range(100):
            s = step(*s)
        rho_r = np.asarray(jnp.sum(s[0], axis=0))
        ls.append((rho_r[:slot_top, c0:c0 + w].sum() - m0) / w)
        ts.append((k + 1) * 100)
    return np.array(ts, float), np.array(ls), slot_top


@pytest.mark.slow
def test_washburn_capillary_rise_viscosity_ratio_001():
    """Quantitative Washburn validation at viscosity ratio 0.01 — the
    reference's flagship accuracy artifact (``/root/reference/README.md:
    58-60``, ``ExampleImages/CapillaryRise.gif``).

    A wetting fluid (theta=45, tau_r=1) intrudes a width-8 slot displacing
    a 100x-less-viscous fluid (tau_b=0.505).  Washburn's law for a 2D slot
    predicts d(l^2)/dt = w sigma cos(theta) / (3 mu_inv), constant in
    time.  Asserts (a) the l^2-vs-t fit is linear to R^2 > 0.995 (the
    sqrt-t law), (b) the slope is within the band expected after the
    Cox-Voinov dynamic-contact-angle reduction at Ca ~ 0.02 and the
    half-way-wall effective width (measured 0.41x ideal; band 0.25-0.75),
    and (c) an equal-viscosity control (ratio 1) intrudes measurably
    slower, confirming the displaced-fluid drag physics."""
    w, theta, sigma = 8, 45.0, 0.05
    ts, ls, slot_top = _washburn_run(tau_b=0.505)
    mask = (ls > 1.5 * w) & (ls < slot_top - 10)
    assert mask.sum() >= 8, "front never traversed the fit window"
    A = np.vstack([ts[mask], np.ones(mask.sum())]).T
    coef, *_ = np.linalg.lstsq(A, ls[mask] ** 2, rcond=None)
    pred = A @ coef
    l2 = ls[mask] ** 2
    r2 = 1.0 - ((l2 - pred) ** 2).sum() / ((l2 - l2.mean()) ** 2).sum()
    mu_inv = (1.0 - 0.5) / 3.0
    slope_ideal = w * sigma * np.cos(np.radians(theta)) / (3.0 * mu_inv)
    ratio = coef[0] / slope_ideal
    assert r2 > 0.995, r2
    assert 0.25 < ratio < 0.75, (coef[0], slope_ideal, ratio)
    # equal-viscosity control: same drive, much larger displaced-fluid
    # drag -> clearly slower front at the same step count
    _, ls_ctrl, _ = _washburn_run(tau_b=1.0)
    assert ls[-1] > 1.5 * ls_ctrl[-1], (ls[-1], ls_ctrl[-1])


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_contact_angle_150_viscosity_contrast_100(dtype):
    """Static contact angle 150 deg at viscosity contrast M=100 — the
    reference's showcase artifact (``/root/reference/README.md:54-57``,
    ``ExampleImages/ContactAngle150M100.png``).  Non-wetting droplet
    (tau_r=2.0) in ambient fluid at tau_b=0.515 (nu ratio 100); the
    spherical-cap fit must recover theta within 15 deg."""
    import jax
    n = 64
    solid = np.zeros((n, n), bool)
    solid[:2, :] = True
    params = ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=0.01,
        contact_angle_deg=150.0, wetting_type=2, tau_type=2,
        tau_r=2.0, tau_b=0.515)
    dt = jnp.float32 if dtype == "f32" else jnp.float64
    model = ColorGradientRK(geo.from_solid_mask(solid), params,
                            CGBoundaryConfig(), dtype=dt)
    state = model.init_state_droplet(1.0, 1.0, center=(2.0, n / 2),
                                     radius=12.0)
    step = jax.jit(model._step_impl)
    s = state
    for _ in range(5000):
        s = step(*s)
    assert bool(jnp.isfinite(s[0]).all())
    _, _, phi, _ = model.macro(s)
    phi = np.asarray(phi)
    drop = phi > 0.0
    drop[:2, :] = False
    base = drop[2, :].sum()
    height = drop[:, n // 2].sum()
    assert base >= 4 and height >= 4, (base, height)
    r_cap = (base ** 2 / 4.0 + height ** 2) / (2.0 * height)
    meas = np.degrees(np.arccos(np.clip((r_cap - height) / r_cap, -1, 1)))
    assert abs(meas - 150.0) < 15.0, meas


@pytest.mark.slow
def test_relperm_layered_poiseuille():
    """Layered two-phase Poiseuille relative permeability: measured phase
    fluxes match the closed forms kr_w = (2 - 3s + s^3)/2 and
    kr_n = (3/2) M s (1 - s^2) + s^3 at the measured saturation within
    2% (docs/make_relperm_figure.py runs the full curve)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "docs"))
    from make_relperm_figure import run_point
    s_meas, kr_w, kr_n, kr_w_a, kr_n_a = run_point(0.45)
    assert abs(kr_w / kr_w_a - 1.0) < 0.02, (kr_w, kr_w_a)
    assert abs(kr_n / kr_n_a - 1.0) < 0.02, (kr_n, kr_n_a)


def _two_phase_channel(bcs, ny=64, nx=32, invading=16, sigma=0.01):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    params = ColorGradientParams(variant="CSF", collision="SRT",
                                 surface_tension=sigma, wetting_type=2)
    model = ColorGradientRK(geo.from_solid_mask(solid), params, bcs,
                            dtype=jnp.float64)
    state = model.init_state_layers(1.0, 1.0, invading_rows=invading)
    return model, state


def test_per_color_zou_he_velocity_inlet():
    """Per-color Zou-He velocity inlet
    (``RKGPU2DBoundary.constantVelocityZHBoundaryHigherRK:11-56``): each
    color carries its own prescribed velocity on the BC row — the red
    (invading) phase at the inlet must move at exactly velocityYR, and the
    displacement must advance like the total-momentum inlet drives it."""
    vy_r = -2.0e-3
    bcs = CGBoundaryConfig(inlet="neumann_per_color", outlet="convective",
                           inlet_velocity_r=vy_r, inlet_velocity_b=0.0)
    model, state = _two_phase_channel(bcs)
    front0 = int((np.asarray(jnp.sum(state[0], axis=0)) > 0.5).sum())
    state = run_chunked(model.step, state, num_steps=1500, io_interval=500)
    f_r, f_b = state
    assert bool(jnp.isfinite(f_r).all() and jnp.isfinite(f_b).all())
    ny = f_r.shape[-2]
    # red row momentum / red row density = prescribed per-color velocity
    # post-stream state: interior columns hold the prescribed rate (the
    # 2-3 wall-adjacent columns feel the side-wall bounce-back)
    ey = jnp.asarray(model.lat.e[:, 1], f_r.dtype).reshape(-1, 1)
    row = f_r[:, ny - 2, 4:-4]
    uy_r = np.asarray(jnp.sum(row * ey, axis=0) / jnp.sum(row, axis=0))
    np.testing.assert_allclose(uy_r, vy_r, rtol=1e-2)
    # and the BC rewrite itself enforces it exactly on the row
    f_r2, f_b2 = model._apply_inlet(f_r, f_b)
    row2 = f_r2[:, ny - 2, 1:-1]
    uy_r2 = np.asarray(jnp.sum(row2 * ey, axis=0) / jnp.sum(row2, axis=0))
    np.testing.assert_allclose(uy_r2, vy_r, rtol=1e-12)
    # the red front advanced into the channel
    front1 = int((np.asarray(jnp.sum(f_r, axis=0)) > 0.5).sum())
    assert front1 > front0 + 32, (front0, front1)


def test_convective_average_outlet_two_phase_channel():
    """Averaged convective outlet (``convectiveAverageBoundaryGPU{,2,3}:
    791-886``): blends each outlet row's previous PDFs with the fresh row
    above at the first interior row's speed.  On a driven two-phase channel
    it must stay finite, admit the displaced fluid out (domain mass does
    not accumulate), and track the upstream state at the outlet rows."""
    bcs = CGBoundaryConfig(inlet="neumann", outlet="convective_average",
                           inlet_velocity=-2.0e-3)
    model, state = _two_phase_channel(bcs)
    m0 = float(jnp.sum(state[0]) + jnp.sum(state[1]))
    state = run_chunked(model.step, state, num_steps=2500, io_interval=500)
    f_r, f_b = state
    assert bool(jnp.isfinite(f_r).all() and jnp.isfinite(f_b).all())
    rho = np.asarray(jnp.sum(f_r + f_b, axis=0))
    # outlet rows relax toward the upstream state (blend, not copy: equality
    # only in steady state, so compare loosely)
    np.testing.assert_allclose(rho[0, 1:-1], rho[3, 1:-1], rtol=5e-2)
    # inflow is balanced by outflow: total mass stays within a few percent
    m1 = float(jnp.sum(f_r) + jnp.sum(f_b))
    assert abs(m1 - m0) / m0 < 0.05, (m0, m1)


def test_convective_average_selectable_from_ini(tmp_path):
    """'AverageConvective' must select the averaged trio, not alias to the
    plain copy trio (the reference reads it at ``RKD2Q9.py:1285``)."""
    from openlbmpm_tpu.config import load_colorgradient
    ini = tmp_path / "rk.ini"
    ini.write_text(
        "[DomainSize]\nxDomain = 32\nyDomain = 64\n"
        "[FluidParameters]\nTauR = 1.0\nTauB = 1.0\nTauType = 2\n"
        "[SurfaceTension]\nSurfaceTensionType = 'CSF'\n"
        "SurfaceTension = 0.01\nContactAngle = 60.0\nWettingType = 2\n"
        "[RelaxationType]\nType = 'SRT'\n"
        "[BoundaryCondition]\nBoundaryTypeInlet = 'Neumann'\n"
        "BoundaryTypeOutlet = 'AverageConvective'\n"
        "velocityYR = -1.0e-3\nvelocityYB = 0.0\n"
        "[TimeSetup]\nTimeSteps = 10\nTimeInterval = 10\n")
    params, bcs, domain, run = load_colorgradient(str(ini))
    assert bcs.outlet == "convective_average"
    # per-color velocity inlet selectable via VelocityType
    ini.write_text(ini.read_text().replace(
        "velocityYR", "VelocityType = 'PerColor'\nvelocityYR"))
    params, bcs, domain, run = load_colorgradient(str(ini))
    assert bcs.inlet == "neumann_per_color"
    assert bcs.inlet_velocity_r == -1.0e-3


def _phi_repair_models(on: bool):
    """Channel with a Dirichlet outlet (rho_r=0 / rho_b=1) — the flagship
    bench boundary — with the calNeumannPhiOutlet repair toggled."""
    solid = np.zeros((32, 16), bool)
    solid[:, 0] = solid[:, -1] = True
    params = ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=0.1,
        tau_r=1.0, tau_b=1.0, tau_type=2, wetting_type=2)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0, phi_outlet_repair=on)
    return ColorGradientRK(geo.from_solid_mask(solid), params, bcs,
                           dtype=jnp.float64)


def test_phi_outlet_repair_kills_spurious_outlet_force():
    """calNeumannPhiOutlet (AcceleratedRKGPU2D.py:1363-1380): when the red
    front reaches the Dirichlet outlet, the fixed outlet densities
    (rho_r=0, rho_b=1) manufacture a phi jump between rows 1 and 2 and
    with it a spurious CSF force pinning the interface at the open
    boundary; the repair copies phi from row 2 onto rows 1 and 0, so the
    outlet-adjacent rows carry no interfacial force."""
    m_on = _phi_repair_models(True)
    m_off = _phi_repair_models(False)
    ny, nx = m_on.geo.shape
    # red has invaded everything above the outlet layers; the outlet rows
    # hold the Dirichlet densities (pure blue), as the BC rewrite enforces
    rho_r = np.zeros((ny, nx))
    rho_b = np.zeros((ny, nx))
    rho_r[2:] = 1.0
    rho_b[:2] = 1.0
    rho_r *= m_on.geo.is_fluid
    rho_b *= m_on.geo.is_fluid
    rho_r = jnp.asarray(rho_r)
    rho_b = jnp.asarray(rho_b)

    phi_off, _, _, fx_off, fy_off = \
        m_off.color_force_fields_from_rho(rho_r, rho_b)
    phi_on, _, _, fx_on, fy_on = \
        m_on.color_force_fields_from_rho(rho_r, rho_b)

    fmag_off = np.abs(np.asarray(fx_off)) + np.abs(np.asarray(fy_off))
    fmag_on = np.abs(np.asarray(fx_on)) + np.abs(np.asarray(fy_on))
    # without the repair the fake interface at rows 1-2 carries CSF force
    assert fmag_off[:3].max() > 1e-4, fmag_off[:3].max()
    # with it, phi is uniform over rows 0-2 -> no gradient, no force on
    # the outlet-adjacent band
    assert fmag_on[:2].max() < 1e-12, fmag_on[:2].max()
    # and the repaired phi rows equal the third-row value
    assert np.allclose(np.asarray(phi_on)[0], np.asarray(phi_on)[2])
    assert np.allclose(np.asarray(phi_on)[1], np.asarray(phi_on)[2])
    # the unrepaired phi keeps the manufactured jump
    assert np.asarray(phi_off)[1].min() < -0.9


def test_phi_outlet_repair_interface_leaves_domain():
    """With the repair the invading front drains through the open
    boundary instead of pinning: run a drainage channel until red reaches
    the outlet band and compare red mass in the outlet rows."""
    m_on = _phi_repair_models(True)
    m_off = _phi_repair_models(False)
    st_on = m_on.init_state_layers(1.0, 1.0, invading_rows=26)
    st_off = m_off.init_state_layers(1.0, 1.0, invading_rows=26)
    st_on = run_chunked(m_on.step, st_on, num_steps=400, io_interval=400)
    st_off = run_chunked(m_off.step, st_off, num_steps=400, io_interval=400)
    r_on = np.asarray(jnp.sum(st_on[0], axis=0))
    r_off = np.asarray(jnp.sum(st_off[0], axis=0))
    assert np.isfinite(r_on).all() and np.isfinite(r_off).all()
    # the trajectories genuinely diverge near the outlet (the repair is
    # not a no-op on the flagship BC combination)
    assert np.abs(r_on[:4] - r_off[:4]).max() > 1e-6
