"""3D model tests: D3Q19 Poiseuille, SC phase separation, CSF Laplace law
(dp = 2 sigma / R in 3D), D3Q7 diffusion (SURVEY.md section 4)."""

import jax.numpy as jnp
import numpy as np

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models.base import run_chunked
from openlbmpm_tpu.models.flow3d import (ColorGradientParams3D,
                                         ColorGradientRK3D, ShanChenMCMP3D,
                                         ShanChenParams3D, SinglePhaseD3Q19,
                                         TransportD3Q7)


def test_d3q19_poiseuille_plates():
    """Body-force flow between two plates (solid y-walls): parabolic u_x(y).
    With half-way bounce-back the walls sit half a cell inside the solid."""
    nz, ny, nx = 4, 18, 4
    solid = np.zeros((nz, ny, nx), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    tau, force = 0.9, 1e-6
    m = SinglePhaseD3Q19(geo.from_solid_mask(solid), tau=tau,
                         body_force=(force, 0.0, 0.0), dtype=jnp.float64)
    f = m.init_state()
    f = run_chunked(m.step, f, num_steps=4000, io_interval=4000)
    rho, (ux, uy, uz) = m.macro(f)
    prof = np.asarray(ux[2, :, 2])
    y = np.arange(ny, dtype=float)
    y0, y1 = 0.5, ny - 1.5  # half-way wall positions
    analytic = force / (2.0 * m.nu) * (y - y0) * (y1 - y)
    analytic[solid[2, :, 2]] = 0.0
    mask = ~solid[2, :, 2]
    err = np.abs(prof[mask] - analytic[mask]).max() / analytic.max()
    assert err < 0.02, err


def test_sc3d_phase_separation_and_mass():
    n = 24
    g = 3.6
    p = ShanChenParams3D(g_matrix=((0.0, g), (g, 0.0)), g_solid=(0.0, 0.0),
                         tau=(1.0, 1.0))
    m = ShanChenMCMP3D(geo.from_solid_mask(np.zeros((n, n, n), bool)), p,
                       dtype=jnp.float64)
    f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02), radius=6.0)
    m0 = np.asarray(jnp.sum(f, axis=(1, 2, 3, 4)))
    f = run_chunked(m.step, f, num_steps=600, io_interval=600)
    m1 = np.asarray(jnp.sum(f, axis=(1, 2, 3, 4)))
    np.testing.assert_allclose(m1, m0, rtol=1e-11)
    rho_k, u = m.macro(f)
    r = np.asarray(rho_k[0])
    assert r[n // 2, n // 2, n // 2] > 0.5
    assert r[2, 2, 2] < 0.2
    p_ = np.asarray(m.pressure(rho_k))
    assert p_[r > 0.8].mean() > p_[r < 0.1].mean()


def test_cg3d_laplace_law():
    """3D Laplace law: dp = 2 sigma / R across a spherical droplet."""
    n = 32
    sigma = 0.005
    params = ColorGradientParams3D(surface_tension=sigma, tau_r=1.0,
                                   tau_b=1.0)
    m = ColorGradientRK3D(geo.from_solid_mask(np.zeros((n, n, n), bool)),
                          params, dtype=jnp.float64)
    state = m.init_state_droplet(1.0, 1.0, radius=8.0)
    m0r = float(jnp.sum(state[0]))
    state = run_chunked(m.step, state, num_steps=1500, io_interval=1500)
    assert abs(float(jnp.sum(state[0])) - m0r) / m0r < 1e-12
    rho_r, rho_b, phi, u = m.macro(state)
    phi = np.asarray(phi)
    p = np.asarray(rho_r + rho_b) / 3.0
    inside = phi > 0.8
    outside = phi < -0.8
    # droplet radius from the half-way (phi = 0) contour: the phi > 0.8
    # plateau under-counts by the interface width
    r_meas = ((phi > 0).sum() * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    dp = p[inside].mean() - p[outside].mean()
    dp_analytic = 2.0 * sigma / r_meas
    assert dp > 0
    assert abs(dp - dp_analytic) / dp_analytic < 0.1, (dp, dp_analytic)
    umax = float(jnp.max(jnp.sqrt(u[0] ** 2 + u[1] ** 2 + u[2] ** 2)))
    assert umax < 0.02, umax


def test_cg3d_wetting_contact_angle_neutral():
    """90-degree wetting: hemispherical cap keeps base ~ 2x its height."""
    n = 28
    solid = np.zeros((n, n, n), bool)
    solid[:2, :, :] = True  # floor at low z
    params = ColorGradientParams3D(surface_tension=0.01,
                                   contact_angle_deg=90.0)
    m = ColorGradientRK3D(geo.from_solid_mask(solid), params,
                          dtype=jnp.float64)
    state = m.init_state_droplet(1.0, 1.0, center=(2.0, n / 2, n / 2),
                                 radius=8.0)
    state = run_chunked(m.step, state, num_steps=1200, io_interval=1200)
    _, _, phi, _ = m.macro(state)
    phi = np.asarray(phi)
    drop = phi > 0.0
    drop[:2] = False
    base_diam = np.sqrt(drop[2].sum() * 4.0 / np.pi)
    height = drop[:, n // 2, n // 2].sum()
    ratio = base_diam / (2.0 * height)
    assert 0.75 < ratio < 1.3, (base_diam, height)


def test_d3q7_diffusion_gaussian():
    n = 40
    j0, tau = 0.25, 1.0
    m = TransportD3Q7(geo.from_solid_mask(np.zeros((n, n, n), bool)),
                      num_tracers=1, tau=(tau,), j0=(j0,),
                      dtype=jnp.float64)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(float)
    c = n / 2.0
    conc0 = np.exp(-((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2) / 8.0)
    g = m.init_state(conc0[None])
    def var(ci, ax):
        t = ci.sum()
        grids = (zz, yy, xx)
        m1 = (ci * grids[ax]).sum() / t
        return (ci * (grids[ax] - m1) ** 2).sum() / t
    v0 = [var(conc0, a) for a in range(3)]
    steps = 150
    g = run_chunked(m.step, g, num_steps=steps, io_interval=steps)
    conc = np.asarray(m.concentration(g))[0]
    d_an = m.diffusivity()
    for a in range(3):
        d_meas = (var(conc, a) - v0[a]) / (2 * steps)
        assert abs(d_meas - d_an) / d_an < 0.03, (a, d_meas, d_an)
    assert abs(conc.sum() - conc0.sum()) / conc0.sum() < 1e-12


def test_d3q7_interface_confinement():
    """Hard interface bounce-back keeps tracer in the rho_R < 0.5 phase."""
    n = 20
    m = TransportD3Q7(geo.from_solid_mask(np.zeros((n, n, n), bool)),
                      num_tracers=1, tau=(1.0,), j0=(0.25,),
                      interface_mode="bounceback", dtype=jnp.float64)
    conc0 = np.zeros((1, n, n, n))
    conc0[0, 2:8] = 1.0
    g = m.init_state(conc0)
    rho_r = jnp.asarray((np.mgrid[0:n, 0:n, 0:n][0] >= n // 2) * 1.0)
    zeros = jnp.zeros((n, n, n))
    total0 = float(np.asarray(m.concentration(g)).sum())
    for _ in range(100):
        g = m.step(g, (zeros, zeros, zeros), rho_r)
    conc = np.asarray(m.concentration(g))[0]
    leak = conc[np.asarray(rho_r) > 0.5].sum() / total0
    assert leak < 1e-10, leak
    assert abs(conc.sum() - total0) / total0 < 1e-12


def test_coupled_3d_flow_transport():
    """Coupled 3D: tracer stays confined to the blue phase while the CSF
    flow advances; masses conserved."""
    from openlbmpm_tpu.models.flow3d import TransportRK3D
    n = 20
    params = ColorGradientParams3D(surface_tension=0.005)
    m = TransportRK3D(geo.from_solid_mask(np.zeros((n, n, n), bool)),
                      params, num_tracers=1, tau=(1.0,), j0=(0.25,),
                      interface_mode="bounceback", dtype=jnp.float64)
    fs = m.flow.init_state_layers(1.0, 1.0, invading_slabs=n // 2)
    conc0 = np.zeros((1, n, n, n))
    conc0[0, 2:6] = 1.0  # pulse deep in the blue phase
    state = m.init_state(fs, conc0)
    total0 = float(np.asarray(m.concentration(state[2])).sum())
    m_r0 = float(jnp.sum(state[0]))
    state = run_chunked(m.step, state, num_steps=100, io_interval=100)
    conc = np.asarray(m.concentration(state[2]))[0]
    rho_r = np.asarray(jnp.sum(state[0], axis=0))
    leak = conc[rho_r > 0.5].sum() / total0
    assert leak < 1e-10, leak
    assert abs(conc.sum() - total0) / total0 < 1e-12
    assert abs(float(jnp.sum(state[0])) - m_r0) / m_r0 < 1e-12


def test_cg3d_macro_compressed_matches_split():
    """macro_compressed on the packed (f_total, rho_r) state returns the
    same fields as macro on (f_r, f_b) — the compressed CLI path's
    diagnostics are exact."""
    n = 16
    solid = np.zeros((n, n, n), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    params = ColorGradientParams3D(surface_tension=0.01, tau_r=1.0,
                                   tau_b=0.8, contact_angle_deg=60.0,
                                   body_force=(0.0, 0.0, -1e-5))
    m = ColorGradientRK3D(geo.from_solid_mask(solid), params,
                          dtype=jnp.float64)
    state = m.init_state_layers(1.0, 1.0, invading_slabs=6)
    for _ in range(3):
        state = m.step(state)
    rho_r, rho_b, phi, u = m.macro(state)
    s = m.pack_state(*state)
    rho_r2, rho_b2, phi2, u2 = m.macro_compressed(s)
    np.testing.assert_allclose(np.asarray(rho_r), np.asarray(rho_r2),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(rho_b), np.asarray(rho_b2),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(phi2),
                               rtol=0, atol=1e-14)
    for d in range(3):
        np.testing.assert_allclose(np.asarray(u[d]), np.asarray(u2[d]),
                                   rtol=0, atol=1e-14)
