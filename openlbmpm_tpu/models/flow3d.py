"""3D model family: D3Q19 flow (single-phase, Shan-Chen MCMP, color-gradient
CSF) and D3Q7 solute transport.

Restores the capability the reference promises but does not ship: its driver
dispatches to ``ShanChenD3Q19`` / ``RKColorGradientD3Q19`` / 3D transport
modules that are absent from the snapshot (``/root/reference/main.py:15-22,
72-81``; SURVEY.md section 0), and ``IniFiles/RKtwophasesetup3D.ini``
configures a 32x32x96 3D run.  Physics definitions follow the 2D modules
one-to-one, generalized over the lattice dimension:

- quadratic equilibria / pull-streaming / half-way bounce-back are the same
  dimension-generic ops as 2D (``ops.equilibrium``, ``ops.streaming``);
- SC interaction force uses the D3Q19 nearest-neighbor weighted stencil
  (the D3Q19 weights play the role the D2Q9 weights do in
  ``OptimizedD2Q9GPU.calInteractionForce:186-313``);
- CSF color gradient / curvature / LKR recoloring use the dimension-generic
  forms in ``ops.colorgrad`` (kappa = (n_a n_b - delta_ab) d_a n_b reduces
  to the reference's 2D expansion);
- D3Q7 transport mirrors the D2Q5 J-scheme: J_0 = j0, J_i = (1 - j0)/6,
  D = (1 - j0)/3 (tau - 1/2).

Arrays are indexed [z, y, x]; e components are (x, y, z).  The canonical
flow axis is -z (inlet at the top z-slabs), matching the 2D convention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry, solid_normals_nd, wetting_masks_nd
from ..lattice import D3Q7, D3Q19
from ..ops import collision as col
from ..ops import colorgrad as cg
from ..ops import common
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.common import shift
from ..ops.forcing import guo_source
from ..ops.streaming import stream, upwind_solid_masks

__all__ = ["SinglePhaseD3Q19", "ShanChenParams3D", "ShanChenMCMP3D",
           "ColorGradientParams3D", "CG3DBoundaryConfig", "ColorGradientRK3D",
           "TransportD3Q7", "TransportRK3D"]


def _density3(f):
    return mac.density(f, spatial_dim=3)


def _grad_lattice(field, lat):
    """sum_i w_i e_i field(x + e_i) per component (zero-on-solid gather)."""
    g = [jnp.zeros_like(field) for _ in range(lat.dim)]
    for i in range(1, lat.q):
        w = float(lat.w[i])
        s = shift(field, int(lat.e[i, 0]), int(lat.e[i, 1]),
                  int(lat.e[i, 2]))
        for d in range(lat.dim):
            ed = int(lat.e[i, d])
            if ed:
                g[d] = g[d] + (w * ed) * s
    return tuple(g)


# ---------------------------------------------------------------------------
# Single-phase D3Q19
# ---------------------------------------------------------------------------

class SinglePhaseD3Q19:
    """Single-component D3Q19 SRT/TRT solver on a dense masked grid."""

    def __init__(self, geometry: Geometry, tau: float = 1.0,
                 collision: Literal["SRT", "TRT"] = "SRT",
                 body_force=(0.0, 0.0, 0.0), dtype=jnp.float32):
        self.lat = D3Q19
        self.geo = geometry
        self.tau = float(tau)
        self.collision = collision
        self.body_force = tuple(float(v) for v in body_force)
        self.dtype = dtype
        self.fluid_mask = jnp.asarray(geometry.is_fluid, dtype)
        self.upwind_solid = jnp.asarray(
            upwind_solid_masks(self.lat, geometry.is_solid))
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    def init_state(self, rho0: float = 1.0):
        rho = jnp.full(self.geo.shape, rho0, self.dtype) * self.fluid_mask
        z = jnp.zeros_like(rho)
        return eq.feq_quadratic(self.lat, rho, (z, z, z))

    def macro(self, f):
        rho = _density3(f)
        force = tuple(b * rho for b in self.body_force) \
            if any(self.body_force) else None
        u = mac.velocity(self.lat, f, rho, force)
        return rho, u

    def _step_impl(self, f):
        rho = _density3(f)
        force = tuple(b * rho for b in self.body_force)
        u = mac.velocity(self.lat, f, rho, force)
        feq = eq.feq_quadratic(self.lat, rho, u)
        if self.collision == "SRT":
            f = col.bgk(f, feq, self.tau)
            if any(self.body_force):
                src = guo_source(self.lat, u, force)
                f = f + (1.0 - 0.5 / self.tau) * src
        else:
            f = col.trt(f, feq, self.lat, self.tau)
            if any(self.body_force):
                src = guo_source(self.lat, u, force)
                f = f + col.trt_force_transform(src, self.lat, self.tau)
        return stream(f, self.lat, self.upwind_solid) * self.fluid_mask

    def step(self, f):
        return self._step(f)

    @property
    def nu(self):
        return (self.tau - 0.5) / 3.0


# ---------------------------------------------------------------------------
# Shan-Chen MCMP D3Q19
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShanChenParams3D:
    g_matrix: tuple
    g_solid: tuple
    tau: tuple
    psi: Literal["rho", "PR"] = "rho"
    body_force: tuple = (0.0, 0.0, 0.0)

    @property
    def num_fluids(self):
        return len(self.tau)


class ShanChenMCMP3D:
    """Original-SC multicomponent flow on D3Q19 (velocity-shift forcing, as
    ``ShanChenD2Q9.runOptimizedLBM`` in 2D).  State: f (K, 19, nz, ny, nx).
    """

    def __init__(self, geometry: Geometry, params: ShanChenParams3D,
                 dtype=jnp.float32):
        self.lat = D3Q19
        self.geo = geometry
        self.p = params
        self.dtype = dtype
        self.k = params.num_fluids
        self.fluid_mask = jnp.asarray(geometry.is_fluid, dtype)
        self.upwind_solid = jnp.asarray(
            upwind_solid_masks(self.lat, geometry.is_solid))
        self.tau = np.asarray(params.tau, np.float64)
        self.g_matrix = np.asarray(params.g_matrix, np.float64)
        self.g_solid = np.asarray(params.g_solid, np.float64)
        # static solid-adhesion stencil field per component
        solid = np.asarray(geometry.is_solid, np.float64)
        adh = [np.zeros_like(solid) for _ in range(3)]
        for i in range(1, 19):
            s = np.roll(np.roll(np.roll(solid, -int(D3Q19.e[i, 2]), 0),
                                -int(D3Q19.e[i, 1]), 1),
                        -int(D3Q19.e[i, 0]), 2)
            for d in range(3):
                ed = int(D3Q19.e[i, d])
                if ed:
                    adh[d] += float(D3Q19.w[i]) * ed * s
        self.adhesion = jnp.asarray(np.stack(adh), dtype)
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    def init_state_droplet(self, rho_main, rho_background, center=None,
                           radius: float = 8.0):
        nz, ny, nx = self.geo.shape
        if center is None:
            center = (nz / 2.0, ny / 2.0, nx / 2.0)
        zz, yy, xx = np.mgrid[0:nz, 0:ny, 0:nx]
        inside = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 +
                  (xx - center[2]) ** 2) <= radius ** 2
        rho = np.empty((self.k, nz, ny, nx))
        for i in range(self.k):
            region = inside if i == 0 else ~inside
            rho[i] = np.where(region, rho_main[i], rho_background[i])
        rho *= self.geo.is_fluid
        rho_k = jnp.asarray(rho, self.dtype)
        z = jnp.zeros_like(rho_k)
        f = eq.feq_quadratic(self.lat, rho_k, (z, z, z))
        return f * self.fluid_mask

    def _force(self, rho_k):
        psi = rho_k  # psi = rho (P-R EOS available via ops.shanchen)
        grads = [jnp.zeros_like(rho_k) for _ in range(3)]
        for i in range(1, 19):
            w = float(D3Q19.w[i])
            s = shift(psi, int(D3Q19.e[i, 0]), int(D3Q19.e[i, 1]),
                      int(D3Q19.e[i, 2]))
            for d in range(3):
                ed = int(D3Q19.e[i, d])
                if ed:
                    grads[d] = grads[d] + (w * ed) * s
        g = jnp.asarray(self.g_matrix, self.dtype)
        gs = jnp.asarray(self.g_solid, self.dtype).reshape(-1, 1, 1, 1)
        out = []
        for d in range(3):
            gv = jnp.einsum("kj,jzyx->kzyx", g, grads[d],
                            precision=common.CONTRACTION_PRECISION)
            out.append(-psi * (gv + gs * self.adhesion[d]) +
                       float(self.p.body_force[d]) * rho_k)
        return tuple(out)

    def _step_impl(self, f):
        rho_k = _density3(f)
        rho_safe = jnp.where(rho_k > 0, rho_k, 1.0)
        # common velocity u' (``calMacroWholeVelocity`` in 2D)
        up = mac.sc_common_velocity(self.lat, f, rho_k, self.tau)
        force = self._force(rho_k)
        tau_b = jnp.asarray(self.tau, self.dtype).reshape(-1, 1, 1, 1)
        ueq = tuple(up[d][None] + tau_b * force[d] / rho_safe
                    for d in range(3))
        feq = eq.feq_quadratic(self.lat, rho_k, ueq)
        tau_q = jnp.asarray(self.tau, self.dtype).reshape(-1, 1, 1, 1, 1)
        f = f - (f - feq) / tau_q
        return stream(f, self.lat, self.upwind_solid) * self.fluid_mask

    def step(self, f):
        return self._step(f)

    def macro(self, f):
        rho_k = _density3(f)
        force = self._force(rho_k)
        rho = jnp.sum(rho_k, axis=0)
        rho_s = jnp.where(rho > 0, rho, 1.0)
        mom = mac.momentum(self.lat, f)
        u = tuple(jnp.sum(mom[d] + 0.5 * force[d], axis=0) / rho_s
                  for d in range(3))
        return rho_k, u

    def pressure(self, rho_k):
        return mac.pressure_sc(rho_k, self.g_matrix)


# ---------------------------------------------------------------------------
# Color-gradient CSF D3Q19
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColorGradientParams3D:
    tau_r: float = 1.0
    tau_b: float = 1.0
    surface_tension: float = 0.01
    contact_angle_deg: float = 90.0
    beta: float = 0.7
    delta: float = 0.98
    tau_type: int = 2
    body_force: tuple = (0.0, 0.0, 0.0)


# D3Q19 direction groups by e_z sign (e components are (x, y, z))
_EZ_PLUS = (5, 11, 14, 15, 18)
_EZ_MINUS = (6, 12, 13, 16, 17)
_EZ_ZERO = (0, 1, 2, 3, 4, 7, 8, 9, 10)


@dataclasses.dataclass(frozen=True)
class CG3DBoundaryConfig:
    """Open z-face boundaries for the 3D color-gradient model.

    The reference ships no 3D code, so the z-face closures use the
    standard non-equilibrium bounce-back (NEBB) generalization of Zou-He
    (f_unknown = feq + f_opp - feq_opp at prescribed rho/u), the
    straightforward D3Q19 extension of the 2D kernels it does ship
    (``RKGPU2DBoundary.py``); see DEVIATIONS.md.
    """

    inlet: str = "periodic"     # periodic | velocity (top z face)
    outlet: str = "periodic"    # periodic | dirichlet | convective
    inlet_velocity: float = 0.0  # v_z at the inlet (negative = inflow)
    outlet_density: float = 1.0  # total rho at the outlet face


class ColorGradientRK3D:
    """CSF color-gradient two-phase flow on D3Q19 (SRT with tau(phi)).

    The 3D sibling of ``ColorGradientRK._step_csf`` with the identical op
    order; the contact-angle rotation uses the plane-based Akai formula
    which is dimension-independent.  State: (f_r, f_b) each (19, nz, ny, nx).
    """

    def __init__(self, geometry: Geometry, params: ColorGradientParams3D,
                 boundaries: CG3DBoundaryConfig = CG3DBoundaryConfig(),
                 dtype=jnp.float32):
        self.lat = D3Q19
        self.geo = geometry
        self.p = params
        self.dtype = dtype
        self.fluid_mask = jnp.asarray(geometry.is_fluid, dtype)
        self.is_fluid = jnp.asarray(geometry.is_fluid)
        self.upwind_solid = jnp.asarray(
            upwind_solid_masks(self.lat, geometry.is_solid))
        wet_fluid, wet_solid = wetting_masks_nd(geometry.is_solid, self.lat)
        self.wet_fluid = jnp.asarray(wet_fluid)
        self.has_wetting = bool(wet_solid.any())
        self.ns = tuple(jnp.asarray(c, dtype)
                        for c in solid_normals_nd(geometry.is_solid,
                                                  self.lat))
        # contact_angle_deg is the red-phase angle; the Akai rotation
        # constrains the into-blue normal (180 deg complement), so the
        # cosine flips (see models/colorgradient.py).
        theta = math.radians(params.contact_angle_deg)
        self.cos_t, self.sin_t = -math.cos(theta), math.sin(theta)
        self.bcs = boundaries
        nz = geometry.shape[0]
        self._slab_masks = {z: jnp.asarray(geometry.is_fluid[z], dtype)
                            for z in (0, 1, 2, 3, nz - 1, nz - 2)}
        self._step = jax.jit(self._step_impl, donate_argnums=(0, 1))

    # -- z-face boundary conditions (NEBB; see CG3DBoundaryConfig) --------
    @staticmethod
    def _feq_vz(rho, vz):
        """D3Q19 equilibria at u = (0, 0, vz): list over Q."""
        lat = D3Q19
        out = []
        for i in range(lat.q):
            ez = float(lat.e[i, 2])
            eu = ez * vz
            out.append(float(lat.w[i]) * rho *
                       (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * vz * vz))
        return out

    def _nebb_rewrite(self, ft, unknown, rho, vz):
        """NEBB closure on a (19, ny, nx) slab of the total PDF."""
        lat = self.lat
        feq = self._feq_vz(rho, vz)
        new = {}
        for i in unknown:
            io = int(lat.opp[i])
            new[i] = feq[i] + (ft[io] - feq[io])
        return new

    def _apply_inlet(self, f_r, f_b):
        if self.bcs.inlet != "velocity":
            return f_r, f_b
        nz = self.geo.shape[0]
        z = nz - 2
        m = self._slab_masks[z]
        vz = self.bcs.inlet_velocity
        ft = f_r[:, z] + f_b[:, z]
        s0 = sum(ft[i] for i in _EZ_ZERO)
        sp = sum(ft[i] for i in _EZ_PLUS)
        rho = (s0 + 2.0 * sp) / (1.0 + vz)
        new = self._nebb_rewrite(ft, _EZ_MINUS, rho, vz)
        rho_r = jnp.sum(f_r[:, z], axis=0)
        rho_t = jnp.sum(ft, axis=0)
        ratio = rho_r / jnp.where(rho_t != 0, rho_t, 1.0)
        for i, val in new.items():
            f_r = f_r.at[i, z].set(jnp.where(m > 0.5, ratio * val,
                                             f_r[i, z]))
            f_b = f_b.at[i, z].set(jnp.where(m > 0.5, (1.0 - ratio) * val,
                                             f_b[i, z]))
        # ghost slab copies the boundary slab
        mg = self._slab_masks[nz - 1]
        f_r = f_r.at[:, nz - 1].set(jnp.where(mg > 0.5, f_r[:, z],
                                              f_r[:, nz - 1]))
        f_b = f_b.at[:, nz - 1].set(jnp.where(mg > 0.5, f_b[:, z],
                                              f_b[:, nz - 1]))
        return f_r, f_b

    def _apply_outlet(self, f_r, f_b):
        if self.bcs.outlet == "convective":
            for z in (2, 1, 0):
                m = self._slab_masks[z]
                f_r = f_r.at[:, z].set(jnp.where(m > 0.5, f_r[:, z + 1],
                                                 f_r[:, z]))
                f_b = f_b.at[:, z].set(jnp.where(m > 0.5, f_b[:, z + 1],
                                                 f_b[:, z]))
            return f_r, f_b
        if self.bcs.outlet != "dirichlet":
            return f_r, f_b
        z = 1
        m = self._slab_masks[z]
        rho_t = self.bcs.outlet_density
        ft = f_r[:, z] + f_b[:, z]
        s0 = sum(ft[i] for i in _EZ_ZERO)
        sm = sum(ft[i] for i in _EZ_MINUS)
        vz = 1.0 - (s0 + 2.0 * sm) / rho_t
        new = self._nebb_rewrite(ft, _EZ_PLUS, rho_t, vz)
        rho_r = jnp.sum(f_r[:, z], axis=0)
        tot = jnp.sum(ft, axis=0)
        ratio = rho_r / jnp.where(tot != 0, tot, 1.0)
        for i, val in new.items():
            f_r = f_r.at[i, z].set(jnp.where(m > 0.5, ratio * val,
                                             f_r[i, z]))
            f_b = f_b.at[i, z].set(jnp.where(m > 0.5, (1.0 - ratio) * val,
                                             f_b[i, z]))
        mg = self._slab_masks[0]
        f_r = f_r.at[:, 0].set(jnp.where(mg > 0.5, f_r[:, 1], f_r[:, 0]))
        f_b = f_b.at[:, 0].set(jnp.where(mg > 0.5, f_b[:, 1], f_b[:, 0]))
        return f_r, f_b

    def init_state_droplet(self, rho_r=1.0, rho_b=1.0, center=None,
                           radius: float = 8.0, background: float = 0.0):
        nz, ny, nx = self.geo.shape
        if center is None:
            center = (nz / 2.0, ny / 2.0, nx / 2.0)
        zz, yy, xx = np.mgrid[0:nz, 0:ny, 0:nx]
        inside = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 +
                  (xx - center[2]) ** 2) <= radius ** 2
        r = np.where(inside, rho_r, background) * self.geo.is_fluid
        b = np.where(inside, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def init_state_layers(self, rho_r=1.0, rho_b=1.0, invading_slabs=8,
                          background: float = 0.0):
        nz = self.geo.shape[0]
        z = np.arange(nz).reshape(-1, 1, 1)
        top = np.broadcast_to(z >= nz - invading_slabs, self.geo.shape)
        r = np.where(top, rho_r, background) * self.geo.is_fluid
        b = np.where(top, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def _feq_init(self, rho_r, rho_b):
        zeros = jnp.zeros(self.geo.shape, self.dtype)
        u0 = (zeros, zeros, zeros)
        f_r = eq.feq_quadratic(self.lat, jnp.asarray(rho_r, self.dtype), u0)
        f_b = eq.feq_quadratic(self.lat, jnp.asarray(rho_b, self.dtype), u0)
        return f_r * self.fluid_mask, f_b * self.fluid_mask

    def pack_state(self, f_r, f_b):
        """Compressed 20-plane state: concat([f_total (19), rho_r (1)]),
        the 3D counterpart of ``ColorGradientRK.pack_state`` (read back
        with ``macro_compressed``)."""
        return jnp.concatenate([f_r + f_b,
                                jnp.sum(f_r, axis=0)[None]], axis=0)

    def color_force_fields(self, f_r, f_b):
        return self._fields_from_densities(_density3(f_r), _density3(f_b))

    def _fields_from_densities(self, rho_r, rho_b):
        phi = cg.phase_field(rho_r, rho_b) * self.fluid_mask
        phi_ext = cg.solid_phi_extrapolate(phi, self.is_fluid, self.lat) \
            if self.has_wetting else phi
        g = cg.color_gradient(phi_ext, self.lat)
        if self.has_wetting:
            g = cg.rotate_gradient_on_wetting_akai_nd(
                g, self.ns, self.cos_t, self.sin_t, self.wet_fluid)
        force, kappa = cg.csf_force_nd(g, self.p.surface_tension,
                                       self.is_fluid, inward_normal=True,
                                       lat=self.lat)
        if any(self.p.body_force):
            rho = rho_r + rho_b
            force = tuple(force[d] + float(self.p.body_force[d]) * rho
                          for d in range(3))
        force = tuple(c * self.fluid_mask for c in force)
        return rho_r, rho_b, phi, g, force

    def _step_impl(self, f_r, f_b):
        f_r, f_b = self._apply_inlet(f_r, f_b)
        f_r, f_b = self._apply_outlet(f_r, f_b)
        return self._physics(f_r, f_b)

    def _physics(self, f_r, f_b):
        """Collide + recolor + stream on post-BC PDFs (the physics half of
        ``_step_impl``; ``TransportRK3D`` composes it after the tracer)."""
        rho_r, rho_b, phi, g, force = self.color_force_fields(f_r, f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        f_tot = f_r + f_b
        mom = mac.momentum(self.lat, f_tot)
        u = tuple((mom[d] + 0.5 * force[d]) / rho_safe for d in range(3))
        tau = cg.tau_interp_csf(phi, rho_r, rho_b, self.p.tau_r,
                                self.p.tau_b, self.p.delta, self.p.tau_type)
        feq = eq.feq_quadratic(self.lat, rho, u)
        src = guo_source(self.lat, u, force)
        f_tot = col.bgk_field_tau(f_tot, feq, tau)
        f_tot = f_tot + (1.0 - 0.5 / tau)[None] * src
        f_r, f_b = cg.recolor_lkr_nd(f_tot, rho_r, rho_b, g, self.p.beta,
                                     self.lat)
        f_r = stream(f_r, self.lat, self.upwind_solid) * self.fluid_mask
        f_b = stream(f_b, self.lat, self.upwind_solid) * self.fluid_mask
        return f_r, f_b

    def step(self, state):
        return self._step(*state)

    def macro(self, state):
        f_r, f_b = state
        rho_r, rho_b, phi, g, force = self.color_force_fields(f_r, f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        mom = mac.momentum(self.lat, f_r + f_b)
        u = tuple((mom[d] + 0.5 * force[d]) / rho_safe for d in range(3))
        return rho_r, rho_b, phi, u

    def macro_compressed(self, s):
        """``macro`` on the compressed (20, nz, ny, nx) state: identical
        fields, since the split macro touches (f_r, f_b) only through
        (f_total, rho_r)."""
        q = self.lat.q
        f_tot = s[:q]
        rho_r = s[q]
        rho_b = _density3(f_tot) - rho_r
        rho_r2, rho_b2, phi, g, force = \
            self._fields_from_densities(rho_r, rho_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        mom = mac.momentum(self.lat, f_tot)
        u = tuple((mom[d] + 0.5 * force[d]) / rho_safe for d in range(3))
        return rho_r, rho_b, phi, u

# ---------------------------------------------------------------------------
# D3Q7 transport
# ---------------------------------------------------------------------------

class TransportD3Q7:
    """Passive/reactive tracer transport on D3Q7 confined to one phase.

    J-scheme equilibrium g_eq = C (J_i + e.u/2) with J_0 = j0,
    J_i = (1 - j0)/6; D = (1 - j0)/3 (tau - 1/2).  Interface handling
    mirrors the 2D module (hard bounce-back at the phase boundary).
    """

    def __init__(self, geometry: Geometry, num_tracers: int = 1,
                 tau=(1.0,), j0=(0.25,), criteria: float = 0.5,
                 interface_mode: str = "none", dtype=jnp.float32):
        self.lat = D3Q7
        self.geo = geometry
        self.dtype = dtype
        self.num_tracers = num_tracers
        self.tau = np.asarray(tau, np.float64)
        j0 = np.asarray(j0, np.float64)
        self.j_coeffs = np.zeros((num_tracers, 7))
        self.j_coeffs[:, 0] = j0
        self.j_coeffs[:, 1:] = ((1.0 - j0) / 6.0)[:, None]
        self.criteria = criteria
        self.interface_mode = interface_mode
        self.fluid_mask = jnp.asarray(geometry.is_fluid, dtype)
        self.upwind_solid = jnp.asarray(
            upwind_solid_masks(self.lat, geometry.is_solid))
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    def init_state(self, conc0):
        conc0 = jnp.asarray(conc0, self.dtype) * self.fluid_mask
        j = jnp.asarray(self.j_coeffs, self.dtype)[:, :, None, None, None]
        return conc0[:, None] * j

    def concentration(self, g):
        return jnp.sum(g, axis=1)

    def diffusivity(self, t: int = 0) -> float:
        return float((1.0 - self.j_coeffs[t, 0]) / 3.0 *
                     (self.tau[t] - 0.5))

    def _step_impl(self, g, u=None, rho_r=None):
        conc = self.concentration(g)
        if u is None:
            zeros = jnp.zeros(self.geo.shape, self.dtype)
            u = (zeros, zeros, zeros)
        geq = eq.feq_transport_j(self.lat, conc, u,
                                 self.j_coeffs[0]) \
            if self.num_tracers == 1 else jnp.stack([
                eq.feq_transport_j(self.lat, conc[i], u, self.j_coeffs[i])
                for i in range(self.num_tracers)])
        tau_b = jnp.asarray(self.tau, self.dtype).reshape(-1, 1, 1, 1, 1)
        g = g - (g - geq) / tau_b
        g = stream(g, self.lat, self.upwind_solid) * self.fluid_mask
        if self.interface_mode == "bounceback" and rho_r is not None:
            dom = rho_r < self.criteria
            for i in range(1, 7):
                dx, dy, dz = (int(self.lat.e[i, d]) for d in range(3))
                opp = int(self.lat.opp[i])
                nbr_out = jnp.logical_and(dom, ~shift(dom, dx, dy, dz))
                leaked = shift(g[:, i], dx, dy, dz)
                g = g.at[:, opp].set(
                    jnp.where(nbr_out[None], leaked, g[:, opp]))
                recv = jnp.logical_and(
                    ~dom, shift(dom, -dx, -dy, -dz))
                g = g.at[:, i].set(jnp.where(recv[None], 0.0, g[:, i]))
        return g

    def step(self, g, u=None, rho_r=None):
        if u is None and rho_r is None:
            return self._step(g)
        return self._step_impl(g, u, rho_r)


class TransportRK3D:
    """Coupled 3D flow + phase-confined tracer transport: one step advances
    the D3Q19 CSF flow and a D3Q7 tracer field seeing the flow's velocity
    and red density (the 3D sibling of ``TransportRK``; the reference
    promises 3D transport but ships none, ``main.py:72-81``).

    State: (f_r, f_b, g) with g (T, 7, nz, ny, nx).
    """

    def __init__(self, geometry: Geometry, flow_params: ColorGradientParams3D,
                 num_tracers: int = 1, tau=(1.0,), j0=(0.25,),
                 criteria: float = 0.5, interface_mode: str = "bounceback",
                 dtype=jnp.float32, boundaries=None):
        flow_kw = {} if boundaries is None else {"boundaries": boundaries}
        self.flow = ColorGradientRK3D(geometry, flow_params, dtype=dtype,
                                      **flow_kw)
        self.transport = TransportD3Q7(geometry, num_tracers, tau, j0,
                                       criteria, interface_mode, dtype)
        self.geo = geometry
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    def init_state(self, flow_state, conc0):
        return (*flow_state, self.transport.init_state(conc0))

    def concentration(self, g):
        return self.transport.concentration(g)

    def _step_impl(self, state):
        # op order (3D semantics are this framework's to define — the
        # reference ships no 3D code): flow BCs first, then the tracer
        # sees the post-BC pre-collision fields, then the flow physics.
        f_r, f_b, g = state
        f_r, f_b = self.flow._apply_inlet(f_r, f_b)
        f_r, f_b = self.flow._apply_outlet(f_r, f_b)
        rho_r, rho_b, phi, grad, force = \
            self.flow.color_force_fields(f_r, f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        mom = mac.momentum(self.flow.lat, f_r + f_b)
        u = tuple((mom[d] + 0.5 * force[d]) / rho_safe for d in range(3))
        g = self.transport._step_impl(g, u, rho_r)
        f_r, f_b = self.flow._physics(f_r, f_b)
        return (f_r, f_b, g)

    def step(self, state):
        return self._step(state)
