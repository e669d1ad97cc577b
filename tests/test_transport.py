"""Transport physics tests: Gaussian-pulse diffusion vs analytic, tracer
mass conservation, anisotropic MRT diffusion, phase confinement
(SURVEY.md section 4)."""

import jax.numpy as jnp
import numpy as np

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models.base import run_chunked
from openlbmpm_tpu.models.colorgradient import ColorGradientParams
from openlbmpm_tpu.models.transport import TransportParams, TransportRK


def _still_blue_domain(n=48):
    """Uniform blue fluid at rest (transport domain everywhere)."""
    solid = np.zeros((n, n), bool)
    g = geo.from_solid_mask(solid)
    flow_params = ColorGradientParams(surface_tension=0.0)
    return g, flow_params


def _gaussian(n, sigma=3.0):
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    c = n / 2.0
    return np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * sigma**2))


def _second_moments(conc):
    n = conc.shape[-1]
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    total = conc.sum()
    cy = (conc * yy).sum() / total
    cx = (conc * xx).sum() / total
    vy = (conc * (yy - cy) ** 2).sum() / total
    vx = (conc * (xx - cx) ** 2).sum() / total
    return vx, vy


def test_d2q5_diffusion_gaussian():
    # 64^2 so the wrapped Gaussian tails stay negligible (> 3.5 sigma at the
    # periodic seam after 200 steps); tail truncation biases the measured
    # variance low by ~2% on a 48^2 box.
    n = 64
    g_dom, fp = _still_blue_domain(n)
    j0, tau = 1.0 / 3.0, 1.0
    tp = TransportParams(num_tracers=1, scheme=5, tau=(tau,), j0=(j0,),
                         interface_mode="none")
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(0.0, 1.0, invading_rows=0)
    conc0 = _gaussian(n)[None]
    state = model.init_state(flow_state, conc0)
    vx0, vy0 = _second_moments(np.asarray(model.concentration(state.g)))

    steps = 200
    state = run_chunked(model.step, state, num_steps=steps, io_interval=steps)
    conc = np.asarray(model.concentration(state.g))

    d_analytic = (1.0 - j0) / 2.0 * (tau - 0.5)
    vx1, vy1 = _second_moments(conc)
    # variance grows by 2 D t per axis
    for v0, v1 in ((vx0, vx1), (vy0, vy1)):
        d_meas = (v1 - v0) / (2 * steps)
        assert abs(d_meas - d_analytic) / d_analytic < 0.02, (d_meas, d_analytic)
    # mass conserved
    assert abs(conc.sum() - conc0.sum()) / conc0.sum() < 1e-12


def test_d2q5_mrt_anisotropic_diffusion():
    n = 64
    g_dom, fp = _still_blue_domain(n)
    dx_, dy_ = 0.15, 0.05
    tp = TransportParams(num_tracers=1, scheme=5, relaxation="MRT",
                         diff_x=(dx_,), diff_y=(dy_,), diff_xy=(0.0,),
                         diff_yx=(0.0,), interface_mode="none")
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(0.0, 1.0, invading_rows=0)
    conc0 = _gaussian(n)[None]
    state = model.init_state(flow_state, conc0)
    vx0, vy0 = _second_moments(np.asarray(model.concentration(state.g)))
    steps = 200
    state = run_chunked(model.step, state, num_steps=steps, io_interval=steps)
    conc = np.asarray(model.concentration(state.g))
    vx1, vy1 = _second_moments(conc)
    dx_meas = (vx1 - vx0) / (2 * steps)
    dy_meas = (vy1 - vy0) / (2 * steps)
    assert abs(dx_meas - dx_) / dx_ < 0.05, dx_meas
    assert abs(dy_meas - dy_) / dy_ < 0.05, dy_meas


def test_d2q9_diffusion_mass_conservation():
    n = 32
    g_dom, fp = _still_blue_domain(n)
    tp = TransportParams(num_tracers=1, scheme=9, tau=(0.8,),
                         interface_mode="none")
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(0.0, 1.0, invading_rows=0)
    conc0 = _gaussian(n)[None]
    state = model.init_state(flow_state, conc0)
    state = run_chunked(model.step, state, num_steps=100, io_interval=100)
    conc = np.asarray(model.concentration(state.g))
    assert abs(conc.sum() - conc0.sum()) / conc0.sum() < 1e-12
    assert conc.min() > -1e-8


def test_interface_bounce_back_confines_tracer():
    """Tracers confined to the blue phase: with a static red/blue interface
    and hard interface bounce-back, no tracer mass leaks into the red phase
    (``calTransportInterfaceGPU``)."""
    n = 32
    solid = np.zeros((n, n), bool)
    g_dom = geo.from_solid_mask(solid)
    fp = ColorGradientParams(surface_tension=0.0)
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
                         interface_mode="bounceback")
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    # red occupies the top half (rows >= n/2)
    flow_state = model.flow.init_state_layers(1.0, 1.0, invading_rows=n // 2)
    conc0 = np.zeros((1, n, n))
    conc0[0, 4:12, :] = 1.0  # pulse deep in the blue phase
    state = model.init_state(flow_state, conc0)
    total0 = float(np.asarray(model.concentration(state.g)).sum())
    state = run_chunked(model.step, state, num_steps=300, io_interval=300)
    conc = np.asarray(model.concentration(state.g))[0]
    rho_r = np.asarray(jnp.sum(state.f_r, axis=0))
    red_zone = rho_r > 0.5
    leak = conc[red_zone].sum() / total0
    assert leak < 1e-10, leak
    assert abs(conc.sum() - total0) / total0 < 1e-12


def test_bilinear_reaction_stoichiometry():
    """A + B -> C: dC_C/dt = -dC_A/dt = k C_A C_B."""
    n = 24
    g_dom, fp = _still_blue_domain(n)
    k = 1e-3
    tp = TransportParams(num_tracers=3, scheme=5, tau=(1.0, 1.0, 1.0),
                         j0=(1 / 3,) * 3, interface_mode="none",
                         reaction_rate=k)
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(0.0, 1.0, invading_rows=0)
    conc0 = np.stack([np.full((n, n), 1.0), np.full((n, n), 0.5),
                      np.zeros((n, n))])
    state = model.init_state(flow_state, conc0)
    state = run_chunked(model.step, state, num_steps=50, io_interval=50)
    conc = np.asarray(model.concentration(state.g))
    # uniform fields stay uniform; check rates
    assert conc[2].mean() > 0
    np.testing.assert_allclose(conc[0].mean() - 1.0, -conc[2].mean(),
                               rtol=1e-10)
    np.testing.assert_allclose(conc[1].mean() - 0.5, -conc[2].mean(),
                               rtol=1e-10)


def test_inamuro_inlet_sets_concentration():
    n = 32
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    g_dom = geo.from_solid_mask(solid)
    fp = ColorGradientParams(surface_tension=0.0)
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
                         interface_mode="none", inlet="inamuro",
                         inlet_conc=(1.0,), outlet="freeflow")
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(0.0, 1.0, invading_rows=0)
    state = model.init_state(flow_state, np.zeros((1, n, n)))
    state = run_chunked(model.step, state, num_steps=200, io_interval=200)
    conc = np.asarray(model.concentration(state.g))[0]
    np.testing.assert_allclose(conc[n - 1, 1:-1], 1.0, atol=1e-8)
    # tracer has diffused into the domain from the inlet
    assert conc[n - 6, n // 2] > 0.01


def test_d2q5_mrt_quadratic_equilibrium():
    """Quadratic MRT equilibrium option reproduces isotropic diffusion."""
    n = 64
    g_dom, fp = _still_blue_domain(n)
    tp = TransportParams(num_tracers=1, scheme=5, relaxation="MRT",
                         mrt_equilibrium="quadratic",
                         diff_x=(0.1,), diff_y=(0.1,), diff_xy=(0.0,),
                         diff_yx=(0.0,), interface_mode="none")
    model = TransportRK(g_dom, fp, tp, standalone=True, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(0.0, 1.0, invading_rows=0)
    conc0 = _gaussian(n)[None]
    state = model.init_state(flow_state, conc0)
    vx0, vy0 = _second_moments(np.asarray(model.concentration(state.g)))
    steps = 150
    state = run_chunked(model.step, state, num_steps=steps, io_interval=steps)
    conc = np.asarray(model.concentration(state.g))
    vx1, _ = _second_moments(conc)
    d_meas = (vx1 - vx0) / (2 * steps)
    assert abs(d_meas - 0.1) / 0.1 < 0.05, d_meas


def test_redistribute_on_interface_motion():
    """Interface motion repair: exited nodes hand mass to in-domain
    neighbors, entered nodes start at the J-equilibrium; total conserved."""
    from openlbmpm_tpu.lattice import D2Q5
    from openlbmpm_tpu.ops import transport as tr
    n = 16
    jc = tr.j_coefficients(np.array([1 / 3]))
    yy = np.mgrid[0:n, 0:n][0]
    dom_old = jnp.asarray(yy < 8)
    dom_new = jnp.asarray(yy < 7)   # interface moved down: row 7 exited
    conc0 = np.zeros((1, n, n))
    conc0[0, :8, :] = 1.0
    g = jnp.asarray(conc0)[:, None] * jnp.asarray(jc)[:, :, None, None]
    total0 = float(jnp.sum(g))
    g2 = tr.redistribute_on_interface_motion(g, dom_new, dom_old, jc, D2Q5)
    conc2 = np.asarray(jnp.sum(g2, axis=1))[0]
    assert abs(float(jnp.sum(g2)) - total0) / total0 < 1e-12
    assert conc2[7].sum() == 0.0                 # exited row cleared
    assert conc2[6].mean() > 1.5                 # neighbors absorbed it
    # reverse motion: row 7 re-enters, initialized from received mass
    g3 = tr.redistribute_on_interface_motion(g2, dom_old, dom_new, jc, D2Q5)
    assert abs(float(jnp.sum(g3)) - total0) / total0 < 1e-12
    assert np.asarray(jnp.sum(g3, axis=1))[0, 7].mean() > 0


def test_redistribute_wired_into_coupled_drainage():
    """`interface_mode="redistribute"` in the coupled step: a velocity-driven
    drainage front sweeps through the tracer phase; the moving-interface
    repair (``Transport2DRK.py:479-695``, ``AccelerateTransport2DRK.py:
    216-302``) must conserve the total tracer mass to 1e-12 in f64 WITHOUT
    the global renormalization crutch, while exited nodes carry zero."""
    from openlbmpm_tpu.models.colorgradient import CGBoundaryConfig
    ny, nx = 64, 32
    g_dom = geo.box_with_walls(nx, ny)
    fp = ColorGradientParams(surface_tension=0.01, collision="SRT")
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
                         interface_mode="redistribute", conserve_mass=False)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="convective",
                           inlet_velocity=-4e-3)
    model = TransportRK(g_dom, fp, tp, boundaries=bcs, dtype=jnp.float64)
    flow_state = model.flow.init_state_layers(invading_rows=16)
    conc0 = np.zeros((1, ny, nx))
    conc0[0, 20:36, 1:-1] = 1.0   # tracer band in the defending (blue) phase
    state = model.init_state(flow_state, conc0)
    mass0 = float(np.asarray(model.concentration(state.g)).sum())
    dom0 = int((np.asarray(jnp.sum(state.f_r, axis=0)) < 0.5).sum())
    state = run_chunked(model.step, state, num_steps=600, io_interval=200)
    conc = np.asarray(model.concentration(state.g))[0]
    rho_r = np.asarray(jnp.sum(state.f_r, axis=0))
    in_domain = rho_r < 0.5
    # the front actually moved (nodes exited the transport domain)
    assert int(in_domain.sum()) < dom0 - nx, (int(in_domain.sum()), dom0)
    # total tracer mass conserved exactly (local exchange, no global repair)
    mass1 = float(conc.sum())
    assert abs(mass1 - mass0) / mass0 < 1e-12, (mass0, mass1)
    # exited nodes carry no leftover tracer
    fluid = np.asarray(model.fluid_mask) > 0
    outside = np.logical_and(~in_domain, fluid)
    assert float(np.abs(conc[outside]).max()) < 1e-10
    assert np.isfinite(conc).all()
