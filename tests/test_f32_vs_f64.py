"""Every model family's f32 step against the same step in f64.

These are the GPU route's correctness checks at CPU size: the f32 state
must stay float32 with 64-bit mode on (conftest enables it; an np.float64
scalar would otherwise promote the whole state silently), and a few dozen
f32 steps must stay within the stated tolerance of the f64 step from the
same initial condition.  chip_smoke.py phase 6 runs the same comparison on
the GPU at benchmark sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu import geometry as geo

# mean: accumulated f32 rounding; max: contact-line cells, where the
# wetting rotation's distance tie-breaks flip under 1-ulp differences
# (DEVIATIONS.md) -- the tolerance chip_smoke.py states for phase 6
MEAN_TOL = 1e-5
MAX_TOL = 1e-3
NY, NX = 32, 24
N3 = 12


def _walls2d():
    solid = np.zeros((NY, NX), bool)
    solid[:, 0] = solid[:, -1] = True
    return geo.from_solid_mask(solid)


def _walls3d():
    solid = np.zeros((N3, N3, N3), bool)
    solid[:, :, 0] = solid[:, :, -1] = True
    solid[:, 0, :] = solid[:, -1, :] = True
    return geo.from_solid_mask(solid)


def _cg(variant, collision):
    from openlbmpm_tpu.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    p = ColorGradientParams(variant=variant, collision=collision,
                            surface_tension=0.01, tau_type=2,
                            wetting_type=2, alpha_r=4 / 9, alpha_b=4 / 9)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-3, outlet_density_r=0.0,
                           outlet_density_b=1.0)

    def build(dtype):
        m = ColorGradientRK(_walls2d(), p, bcs, dtype=dtype)
        return m, m.init_state_layers(1.0, 1.0, invading_rows=8), m.step
    return build


def _sc(scheme):
    from openlbmpm_tpu.models.shanchen import ShanChenMCMP, ShanChenParams
    if scheme == "SC":
        p = ShanChenParams(g_matrix=((0.0, 3.8), (3.8, 0.0)),
                           g_solid=(-0.4, 0.4), tau=(1.0, 1.0))
    else:
        p = ShanChenParams(g_matrix=((0.0, 0.2), (0.2, 0.0)),
                           g_solid=(0.0, 0.0), tau=(1.0, 0.55),
                           scheme="EFS", iso_order=8, collision="MRT")

    def build(dtype):
        solid = np.zeros((NY, NX), bool)
        if scheme == "SC":
            solid[:2] = True
        m = ShanChenMCMP(geo.from_solid_mask(solid), p, dtype=dtype)
        f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                 center=(NY / 2, NX / 2), radius=6.0)
        return m, f, m.step
    return build


def _single(collision):
    from openlbmpm_tpu.models.single_phase import SinglePhaseD2Q9

    def build(dtype):
        m = SinglePhaseD2Q9(_walls2d(), tau=0.8, collision=collision,
                            body_force=(0.0, -1e-5), dtype=dtype)
        return m, m.init_state(), m.step
    return build


def _transport_mrt(dtype):
    from openlbmpm_tpu.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams)
    from openlbmpm_tpu.models.transport import TransportParams, TransportRK
    fp = ColorGradientParams(variant="CSF", collision="MRT",
                             surface_tension=0.01, tau_type=2)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-3, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    tp = TransportParams(num_tracers=1, scheme=5, relaxation="MRT",
                         diff_x=(0.1,), diff_y=(0.05,), diff_xy=(0.01,),
                         diff_yx=(0.01,))
    m = TransportRK(_walls2d(), fp, tp, bcs, dtype=dtype)
    conc0 = np.zeros((1, NY, NX))
    conc0[0, 4:NY // 2] = 1.0
    st = m.init_state(m.flow.init_state_layers(1.0, 1.0, invading_rows=8),
                      conc0)
    return m, st, m.step


def _cg3d(dtype):
    from openlbmpm_tpu.models.flow3d import (
        CG3DBoundaryConfig, ColorGradientParams3D, ColorGradientRK3D)
    p = ColorGradientParams3D(surface_tension=0.01, contact_angle_deg=60.0,
                              tau_b=0.8)
    bcs = CG3DBoundaryConfig(inlet="velocity", outlet="dirichlet",
                             inlet_velocity=-1e-4)
    m = ColorGradientRK3D(_walls3d(), p, bcs, dtype=dtype)
    return m, m.init_state_layers(1.0, 1.0, invading_slabs=4), m.step


def _sc3d(dtype):
    from openlbmpm_tpu.models.flow3d import ShanChenMCMP3D, ShanChenParams3D
    p = ShanChenParams3D(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                         g_solid=(-0.3, 0.3), tau=(1.0, 0.8))
    m = ShanChenMCMP3D(_walls3d(), p, dtype=dtype)
    return m, m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                   radius=3.0), m.step


def _basic3d(dtype):
    from openlbmpm_tpu.models.flow3d import SinglePhaseD3Q19
    m = SinglePhaseD3Q19(_walls3d(), tau=0.8, collision="TRT",
                         body_force=(0.0, 0.0, -1e-5), dtype=dtype)
    return m, m.init_state(1.0), m.step


def _transport3d(dtype):
    from openlbmpm_tpu.models.flow3d import (ColorGradientParams3D,
                                             TransportRK3D)
    m = TransportRK3D(_walls3d(), ColorGradientParams3D(surface_tension=0.01),
                      num_tracers=1, tau=(0.9,), dtype=dtype)
    conc0 = np.zeros((1, N3, N3, N3))
    conc0[:, : N3 // 2] = 1.0
    flow = m.flow.init_state_layers(1.0, 1.0, invading_slabs=4)
    return m, m.init_state(flow, conc0), m.step


FAMILIES = {
    "csf-srt": _cg("CSF", "SRT"),
    "csf-mrt": _cg("CSF", "MRT"),
    "perturbation": _cg("Perturbation", "SRT"),
    "sc": _sc("SC"),
    "efs-iso8-mrt": _sc("EFS"),
    "single-srt": _single("SRT"),
    "single-mrt": _single("MRT"),
    "single-trt": _single("TRT"),
    "transport-d2q5-mrt": _transport_mrt,
    "cg3d": _cg3d,
    "sc3d": _sc3d,
    "basic3d": _basic3d,
    "transport3d": _transport3d,
}


def _fields(state, dim):
    """Every macroscopic field of a state: the direction axis (the one
    before the ``dim`` spatial axes) summed out of each PDF leaf, giving
    per-component densities and tracer concentrations."""
    return [jnp.sum(x, axis=-(dim + 1)).reshape((-1,) + x.shape[-dim:])
            for x in jax.tree_util.tree_leaves(state) if x.ndim > dim]


def _advance(step, state, n):
    return jax.jit(lambda s: jax.lax.fori_loop(0, n, lambda _, x: step(x),
                                               s))(state)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_step_keeps_float32_under_x64(family):
    assert jax.config.jax_enable_x64
    _, state, step = FAMILIES[family](jnp.float32)
    out = _advance(step, state, 2)
    for leaf in jax.tree_util.tree_leaves(out):
        assert leaf.dtype == jnp.float32, (family, leaf.shape, leaf.dtype)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_step_tracks_f64(family):
    n = 24 if "3d" in family else 36
    m32, s32, step32 = FAMILIES[family](jnp.float32)
    m64, s64, step64 = FAMILIES[family](jnp.float64)
    fluid = np.asarray(m64.geo.is_fluid, bool)
    a = _fields(_advance(step32, s32, n), fluid.ndim)
    b = _fields(_advance(step64, s64, n), fluid.ndim)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        d = np.abs(np.asarray(x, np.float64) - np.asarray(y))[:, fluid]
        assert np.isfinite(d).all(), family
        assert d.mean() <= MEAN_TOL and d.max() <= MAX_TOL, \
            (family, float(d.mean()), float(d.max()))
