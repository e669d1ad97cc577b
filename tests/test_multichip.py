"""Multi-chip domain decomposition: the same case on 1 device and on a
sharded 8-device mesh must agree to rounding (SURVEY.md section 4c).

The virtual mesh comes from --xla_force_host_platform_device_count=8
(conftest).  XLA's SPMD partitioner lowers the jnp.roll halo reads into
collective-permute exchanges; no code changes between the two runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openlbmpm_tpu import geometry as geo
from openlbmpm_tpu.models.colorgradient import (
    CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
from openlbmpm_tpu.models.shanchen import ShanChenMCMP, ShanChenParams
from openlbmpm_tpu.parallel.mesh import (domain_sharding, make_mesh,
                                         shard_domain)



@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")


def _run_sharded(model, state, steps, n_devices=8, ndim=3):
    mesh = make_mesh(n_devices)
    state = shard_domain(state, mesh)
    shard = domain_sharding(mesh, ndim)
    if isinstance(state, tuple):
        step = jax.jit(model._step_impl,
                       in_shardings=(shard,) * len(state),
                       out_shardings=(shard,) * len(state))
        for _ in range(steps):
            state = step(*state)
    else:
        step = jax.jit(model._step_impl, in_shardings=shard,
                       out_shardings=shard)
        for _ in range(steps):
            state = step(state)
    return state


def test_csf_sharded_equals_single():
    ny, nx = 64, 128   # nx divisible by 8
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    params = ColorGradientParams(variant="CSF", collision="MRT",
                                 surface_tension=0.01, tau_type=2,
                                 wetting_type=2)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    model = ColorGradientRK(geo.from_solid_mask(solid), params, bcs,
                            dtype=jnp.float64)
    state0 = model.init_state_layers(1.0, 1.0, invading_rows=12)

    ref = state0
    for _ in range(20):
        ref = model._step_impl(*ref)
    shd = _run_sharded(model, state0, 20)
    np.testing.assert_allclose(np.asarray(ref[0]), np.asarray(shd[0]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ref[1]), np.asarray(shd[1]),
                               rtol=0, atol=1e-12)


def test_shanchen_sharded_equals_single():
    ny, nx = 48, 64
    params = ShanChenParams(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                            g_solid=(0.0, 0.0), tau=(1.0, 1.0))
    model = ShanChenMCMP(geo.from_solid_mask(np.zeros((ny, nx), bool)),
                         params, dtype=jnp.float64)
    state0 = model.init_state_droplet((1.0, 1.0), (0.02, 0.02), radius=10.0)
    ref = state0
    for _ in range(20):
        ref = model._step_impl(ref)
    shd = _run_sharded(model, state0, 20, ndim=4)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(shd),
                               rtol=0, atol=1e-12)


def test_sharded_2d_mesh():
    """2D ('y','x') mesh decomposition also reproduces the single-device
    run (both spatial axes sharded)."""
    ny, nx = 64, 64
    params = ColorGradientParams(variant="CSF", collision="SRT",
                                 surface_tension=0.01)
    model = ColorGradientRK(geo.from_solid_mask(np.zeros((ny, nx), bool)),
                            params, CGBoundaryConfig(), dtype=jnp.float64)
    state0 = model.init_state_droplet(1.0, 1.0, radius=14.0)
    ref = state0
    for _ in range(10):
        ref = model._step_impl(*ref)
    mesh = make_mesh(shape=(2, 4))
    state = shard_domain(state0, mesh)
    shard = domain_sharding(mesh, 3)
    step = jax.jit(model._step_impl, in_shardings=(shard, shard),
                   out_shardings=(shard, shard))
    for _ in range(10):
        state = step(*state)
    np.testing.assert_allclose(np.asarray(ref[0]), np.asarray(state[0]),
                               rtol=0, atol=1e-12)


def test_cg3d_sharded_equals_single():
    """3D model sharded over an 8-device x-mesh == single device."""
    from openlbmpm_tpu.models.flow3d import (ColorGradientParams3D,
                                             ColorGradientRK3D)
    nz, ny, nx = 16, 16, 32
    params = ColorGradientParams3D(surface_tension=0.005)
    m = ColorGradientRK3D(geo.from_solid_mask(np.zeros((nz, ny, nx), bool)),
                          params, dtype=jnp.float64)
    state0 = m.init_state_droplet(1.0, 1.0, radius=5.0)
    ref = state0
    for _ in range(10):
        ref = m._step_impl(*ref)
    mesh = make_mesh(8)
    state = shard_domain(state0, mesh)
    shard = domain_sharding(mesh, 4)
    step = jax.jit(m._step_impl, in_shardings=(shard, shard),
                   out_shardings=(shard, shard))
    for _ in range(10):
        state = step(*state)
    np.testing.assert_allclose(np.asarray(ref[0]), np.asarray(state[0]),
                               rtol=0, atol=1e-12)


def test_explicit_halo_exchange_matches_global():
    """The explicit shard_map + ppermute halo path (parallel/halo.py)
    reproduces the global computation for a radius-2 stencil step."""
    from openlbmpm_tpu.parallel.halo import make_sharded_stepper

    ny, nx = 16, 64

    def stencil_step(a, b):
        # radius-2 periodic stencil in x, radius-1 in y
        lap = (jnp.roll(a, 1, -1) + jnp.roll(a, -1, -1) +
               0.5 * jnp.roll(a, 2, -1) + 0.5 * jnp.roll(a, -2, -1) +
               jnp.roll(a, 1, -2) + jnp.roll(a, -1, -2) - 5.0 * a)
        return a + 0.05 * lap + 0.01 * b, b + 0.02 * a

    rng = np.random.RandomState(0)
    a0 = jnp.asarray(rng.randn(ny, nx))
    b0 = jnp.asarray(rng.randn(ny, nx))
    ref_a, ref_b = a0, b0
    for _ in range(5):
        ref_a, ref_b = stencil_step(ref_a, ref_b)

    mesh = make_mesh(8)
    step = make_sharded_stepper(stencil_step, mesh, state_ndim=2, halo=2)
    shard = domain_sharding(mesh, 2)
    a = jax.device_put(a0, shard)
    b = jax.device_put(b0, shard)
    for _ in range(5):
        a, b = step(a, b)
    np.testing.assert_allclose(np.asarray(ref_a), np.asarray(a),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ref_b), np.asarray(b),
                               rtol=0, atol=1e-12)


def test_coupled_transport_sharded_equals_single():
    """Coupled CSF flow + phase-confined tracer transport (jnp path,
    interface redistribution active) sharded over the 8-device mesh ==
    single device at 1e-12: the β-partition shifts, hard bounce-back
    repair, and moving-front mass redistribution all lower to
    collective-permute exchanges under XLA SPMD."""
    from openlbmpm_tpu.models.transport import (TransportParams,
                                                TransportRK)
    ny, nx = 64, 128
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    fp = ColorGradientParams(variant="CSF", collision="MRT",
                             surface_tension=0.01, tau_type=2,
                             wetting_type=2)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-3, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,),
                         beta_interface=(0.2,),
                         interface_mode="redistribute")
    m = TransportRK(geo.from_solid_mask(solid), fp, tp, bcs,
                    dtype=jnp.float64)
    flow0 = m.flow.init_state_layers(1.0, 1.0, invading_rows=12)
    conc0 = np.zeros((1, ny, nx))
    conc0[0, ny // 2:] = 1.0
    state0 = m.init_state(flow0, conc0)

    ref = state0
    step1 = jax.jit(m._step_impl)
    for _ in range(10):
        ref = step1(ref)

    mesh = make_mesh(8)
    shd = shard_domain(state0, mesh)
    stepn = jax.jit(m._step_impl)
    for _ in range(10):
        shd = stepn(shd)
    for a, b in zip(ref, shd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-12)


def _spmd_equals_single(step, state0, spec_of, mesh, steps):
    """Run ``step`` on one device and with every state leaf placed by
    ``spec_of(leaf)`` on ``mesh`` (XLA SPMD inserts the halo exchanges);
    the two trajectories agree to f64 rounding."""
    from jax.sharding import NamedSharding

    ref = state0
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, spec_of(x))), state0)
    jstep = jax.jit(step)
    for _ in range(steps):
        ref = jstep(ref)
        sharded = jstep(sharded)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(sharded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-12)


def _yx_spec(x):
    """Trailing two axes over the ("y", "x") mesh; 1D arrays replicated."""
    from jax.sharding import PartitionSpec as P
    return P() if x.ndim < 2 else P(*((None,) * (x.ndim - 2) + ("y", "x")))


def _zy_spec(x):
    """3D fields (..., nz, ny, nx): z over "y", y over "x"."""
    from jax.sharding import PartitionSpec as P
    return P(*((None,) * (x.ndim - 3) + ("y", "x", None)))


def _csf_walls_model(ny, nx, variant="CSF", collision="MRT"):
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    params = ColorGradientParams(variant=variant, collision=collision,
                                 surface_tension=0.01, tau_type=2,
                                 wetting_type=2, alpha_r=4 / 9, alpha_b=4 / 9)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    return ColorGradientRK(geo.from_solid_mask(solid), params, bcs,
                           dtype=jnp.float64)


@pytest.mark.parametrize("variant,collision", [("CSF", "MRT"),
                                               ("Perturbation", "SRT")])
def test_compressed_spmd_2d_mesh_equals_single(variant, collision):
    """The compressed (f_total, rho_r) jnp step under a (2, 4) 'y' x 'x'
    mesh -- row and column halos, wetting walls and the inlet/outlet rows
    crossing shard seams -- matches the single-device step."""
    model = _csf_walls_model(32, 64, variant, collision)
    s0 = model.pack_state(*model.init_state_layers(1.0, 1.0,
                                                   invading_rows=8))
    _spmd_equals_single(model._step_impl_c, s0, _yx_spec,
                        make_mesh(shape=(2, 4)), 4)


def test_cg3d_spmd_zy_mesh_equals_single():
    """The D3Q19 CSF step with z-face inlet/outlet BCs and wetting y walls
    under a (z, y) 2-D mesh matches the single-device step."""
    from openlbmpm_tpu.models.flow3d import (CG3DBoundaryConfig,
                                             ColorGradientParams3D,
                                             ColorGradientRK3D)
    nz, ny, nx = 16, 16, 8
    solid = np.zeros((nz, ny, nx), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    params = ColorGradientParams3D(surface_tension=0.01, tau_r=1.0,
                                   tau_b=0.8, contact_angle_deg=60.0)
    bcs = CG3DBoundaryConfig(inlet="velocity", outlet="convective",
                             inlet_velocity=-1e-3)
    m = ColorGradientRK3D(geo.from_solid_mask(solid), params, bcs,
                          dtype=jnp.float64)
    s0 = m.init_state_layers(1.0, 1.0, invading_slabs=4)
    _spmd_equals_single(lambda s: m._step_impl(*s), s0, _zy_spec,
                        make_mesh(shape=(2, 2)), 3)


def _coupled_2d():
    from openlbmpm_tpu.models.transport import (TransportParams,
                                                TransportRK)
    ny, nx = 32, 32
    model = _csf_walls_model(ny, nx)
    tp = TransportParams(num_tracers=2, scheme=5, tau=(1.0, 0.8),
                         j0=(0.25, 0.25), beta_interface=(0.2, 0.0),
                         interface_mode="bounceback")
    m = TransportRK(model.geo, model.p, tp, model.bcs, dtype=jnp.float64)
    conc0 = np.zeros((2, ny, nx))
    conc0[:, ny // 2:] = 1.0
    return m, m.init_state(m.flow.init_state_layers(1.0, 1.0,
                                                    invading_rows=8), conc0)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_coupled_spmd_mesh_equals_single(shape):
    """Coupled CSF flow + two phase-confined tracers (partition and hard
    bounce-back) under a 4-shard y-mesh and a (2, 2) y x x mesh: flow PDFs
    and tracer PDFs ride the same SPMD halo exchanges."""
    m, st = _coupled_2d()
    _spmd_equals_single(m._step_impl, st, _yx_spec, make_mesh(shape=shape),
                        3)


def test_coupled3d_spmd_z_mesh_equals_single():
    """Coupled 3D flow + D3Q7 tracer (interface bounce-back) with the
    domain split in z over 4 devices matches the single-device step."""
    from jax.sharding import PartitionSpec as P

    from openlbmpm_tpu.models.flow3d import (ColorGradientParams3D,
                                             TransportRK3D)
    nz, n = 16, 8
    solid = np.zeros((nz, n, n), bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    params = ColorGradientParams3D(surface_tension=0.01, tau_r=1.0,
                                   tau_b=0.8, contact_angle_deg=60.0)
    m = TransportRK3D(geo.from_solid_mask(solid), params, num_tracers=1,
                      tau=(1.0,), interface_mode="bounceback",
                      dtype=jnp.float64)
    conc0 = np.zeros((1, nz, n, n))
    conc0[:, nz // 2:] = 1.0
    st = m.init_state(m.flow.init_state_layers(1.0, 1.0, invading_slabs=4),
                      conc0)
    _spmd_equals_single(
        m._step_impl, st,
        lambda x: P(*((None,) * (x.ndim - 3) + ("y", None, None))),
        make_mesh(shape=(4, 1)), 2)
