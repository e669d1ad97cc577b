"""Rothman-Keller color-gradient two-phase flow: Perturbation and CSF variants.

The flagship model family (reference README "the best option", README.md:51).
Rebuilds the two run loops of ``RKCG2D/RKD2Q9.py`` as fused jitted steps:

**CSF variant** (Akai et al. 2018; ``runRKColorGradient2DCSF``,
``RKD2Q9.py:1225-1493``) — one step, in the reference's exact op order:
  1. inlet BC (total-momentum velocity inlet + ghost row | per-color
     Zou-He pressure inlet + ghost row)
  2. outlet BC (convective copy trio | total-PDF pressure outlet + ghost)
  3. total PDF, velocity u = (sum f_tot e + F/2)/rho, phase field phi
  4. phi extrapolated onto wetting solids (masked weighted average)
  5. isotropic color gradient (solid phi included)
  6. contact-angle enforcement on wetting fluid nodes (Xu 2017 | Akai 2018)
  7. CSF force F = +-(1/2) sigma kappa grad(phi)
  8. single-phase collision on the total PDF: SRT with tau(phi) or MRT with
     s_nu = 1/tau(phi)
  9. Guo perturbation source (SRT: scalar (1 - 1/(2 tau)); MRT: moment-space
     (I - S/2))
 10. Latva-Kokko-Rothman recoloring
 11. per-color pull-streaming with half-way bounce-back

**Perturbation variant** (Liu et al. 2014; ``runRKColorGradient2DPerturbation``,
``RKD2Q9.py:979-1223``): per-color BGK collision with the RK "original"
equilibria (C_i constants), perturbation operator on the color gradient of
(rho_R - rho_B) with solid-color difference, Grunau tau(phi), LKR recoloring
with the feq-weighted segregation (``calRKCollision23GPU:244-333``).

State: (f_r, f_b) each (9, ny, nx); the force field is recomputed inside the
step (pure function of the PDFs), unlike the reference which carries it
between kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry, solid_normals, wetting_masks
from ..lattice import D2Q9
from ..ops import boundaries as bc
from ..ops import collision as col
from ..ops import colorgrad as cg
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.common import shift
from ..ops.forcing import guo_source
from ..ops.streaming import stream, upwind_solid_masks

__all__ = ["ColorGradientParams", "CGBoundaryConfig", "ColorGradientRK"]


@dataclasses.dataclass(frozen=True)
class ColorGradientParams:
    tau_r: float = 1.0
    tau_b: float = 1.0
    surface_tension: float = 0.1
    contact_angle_deg: float = 60.0
    beta: float = 0.7                # LKR interface-thickness parameter
    delta: float = 0.98              # tau-interpolation half-width
    tau_type: int = 1                # 1 | 2 (CSF tau(phi) option)
    wetting_type: int = 2            # 1 = Xu 2017 | 2 = Akai 2018
    variant: Literal["CSF", "Perturbation"] = "CSF"
    collision: Literal["SRT", "MRT"] = "SRT"
    solid_phi: float = 0.5           # solid color diff (Perturbation variant)
    alpha_r: float = 0.92            # RK equilibrium constants (Perturbation)
    alpha_b: float = 0.2
    a_kr: float = 0.0001             # perturbation strength (Perturbation)
    a_kb: float = 0.0001
    body_force: tuple[float, float] = (0.0, 0.0)
    gradient_type: str = "Isotropic"  # Perturbation variant gradient weights


@dataclasses.dataclass(frozen=True)
class CGBoundaryConfig:
    """Open-boundary selection for the RK/CSF run loops.

    inlet:  periodic | neumann (total-momentum velocity, NEBB,
            ``constantTotalVelocityInlet:2348``) | neumann_per_color
            (per-color Zou-He velocity,
            ``RKGPU2DBoundary.constantVelocityZHBoundaryHigherRK:11-56``)
            | dirichlet (pressure)
    outlet: periodic | convective (plain copy trio,
            ``convectiveOutletGPU:700-790``) | convective_average
            (f = (f_old + |v| f_up)/(1 + |v|) trio with |v| from the row
            above the outlet layers,
            ``convectiveAverageBoundaryGPU{,2,3}:791-886``) | dirichlet
            | modified_periodic
    """

    inlet: str = "periodic"
    outlet: str = "periodic"
    # phi Neumann repair at Dirichlet outlets (``calNeumannPhiOutlet``,
    # ``AcceleratedRKGPU2D.py:1363-1380``): copy phi from row 2 onto the
    # outlet rows 1 and 0 after the phase-field computation so the fixed
    # outlet densities cannot manufacture a color gradient -> CSF force at
    # the open boundary.  Launched unconditionally in the reference's
    # coupled loop (``Transport2DRK.py:846``); in the pure CG loops it is
    # gated on the misspelled literal ``'Dirilcht'``
    # (``RKD2Q9.py:1149,1369``), so shipped INIs (which spell
    # ``'Dirichlet'``) never fire it there — this rebuild applies the
    # kernel's evident intent whenever the outlet is Dirichlet; set False
    # to reproduce the reference's misspelling-gated behavior.
    phi_outlet_repair: bool = True
    inlet_velocity: float = 0.0        # total v_y (Neumann)
    inlet_velocity_r: float = 0.0      # per-color v_y (neumann_per_color)
    inlet_velocity_b: float = 0.0
    inlet_density_r: float = 1.0       # per-color inlet densities (Dirichlet)
    inlet_density_b: float = 0.0
    outlet_density_r: float = 0.0
    outlet_density_b: float = 1.0


class ColorGradientRK:
    """Two-phase color-gradient solver on a dense masked D2Q9 grid."""

    def __init__(self, geometry: Geometry, params: ColorGradientParams,
                 boundaries: CGBoundaryConfig = CGBoundaryConfig(),
                 dtype=jnp.float32):
        self.lat = D2Q9
        self.geo = geometry
        self.p = params
        self.bcs = boundaries
        self.dtype = dtype

        self.fluid_mask = jnp.asarray(geometry.is_fluid, dtype)
        self.is_fluid = jnp.asarray(geometry.is_fluid)
        self.upwind_solid = jnp.asarray(
            upwind_solid_masks(self.lat, geometry.is_solid))

        wet_fluid, wet_solid = wetting_masks(geometry.is_solid)
        nsx, nsy = solid_normals(geometry.is_solid)
        self.wet_fluid = jnp.asarray(wet_fluid)
        self.has_wetting = bool(wet_solid.any())
        self.nsx = jnp.asarray(nsx, dtype)
        self.nsy = jnp.asarray(nsy, dtype)
        # `contact_angle_deg` is the contact angle of the RED (invading)
        # phase.  The Akai rotation (wetting_type 2) constrains the angle
        # between -grad(phi)/|grad(phi)| (the into-blue normal) and n_s,
        # which geometrically equals 180 deg minus the red angle, so the
        # cosine flips sign; the Xu rotation (type 1) constrains the
        # into-red direction and uses the angle as-is.
        theta = math.radians(params.contact_angle_deg)
        flip = -1.0 if params.wetting_type == 2 else 1.0
        self.cos_t = flip * math.cos(theta)
        self.sin_t = math.sin(theta)

        if params.variant == "Perturbation":
            self.const_cr = eq.rk_constants(params.alpha_r)
            self.const_cb = eq.rk_constants(params.alpha_b)
            if params.gradient_type == "Anisotropic":
                gs = np.array([0.0] + [1 / 3] * 4 + [1 / 12] * 4)
            else:
                gs = np.ones(9)
                gs[0] = 0.0
            self._grad_scheme = gs
        self._mrt_s = col.mrt_relaxation_d2q9_rk()

        ny = geometry.ny
        self._row_masks = {r: jnp.asarray(geometry.is_fluid[r], bool)
                           for r in (0, 1, 2, ny - 1, ny - 2)}
        self._phi_repair = (boundaries.outlet == "dirichlet"
                            and boundaries.phi_outlet_repair)
        self._step = jax.jit(self._step_impl, donate_argnums=(0, 1))
        self._step_c = jax.jit(self._step_impl_c, donate_argnums=(0,))

    # -- initial conditions ----------------------------------------------
    def init_state_layers(self, rho_r: float = 1.0, rho_b: float = 1.0,
                          invading_rows: int = 10, background: float = 0.0):
        """Red occupies the top `invading_rows` rows (``RKD2Q9.py:445-575``)."""
        ny, nx = self.geo.shape
        y = np.arange(ny).reshape(-1, 1)
        top = np.broadcast_to(y >= ny - invading_rows, (ny, nx))
        r = np.where(top, rho_r, background) * self.geo.is_fluid
        b = np.where(top, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def init_state_droplet(self, rho_r: float = 1.0, rho_b: float = 1.0,
                           center=None, radius: float = 16.0,
                           background: float = 0.0):
        ny, nx = self.geo.shape
        if center is None:
            center = (ny / 2.0, nx / 2.0)
        yy, xx = np.mgrid[0:ny, 0:nx]
        inside = (yy - center[0]) ** 2 + (xx - center[1]) ** 2 <= radius ** 2
        r = np.where(inside, rho_r, background) * self.geo.is_fluid
        b = np.where(inside, background, rho_b) * self.geo.is_fluid
        return self._feq_init(r, b)

    def _feq_init(self, rho_r, rho_b):
        zeros = jnp.zeros(self.geo.shape, self.dtype)
        rr = jnp.asarray(rho_r, self.dtype)
        rb = jnp.asarray(rho_b, self.dtype)
        if self.p.variant == "Perturbation":
            f_r = eq.feq_rk_original(self.lat, rr, (zeros, zeros), self.const_cr)
            f_b = eq.feq_rk_original(self.lat, rb, (zeros, zeros), self.const_cb)
        else:
            f_r = eq.feq_quadratic(self.lat, rr, (zeros, zeros))
            f_b = eq.feq_quadratic(self.lat, rb, (zeros, zeros))
        return f_r * self.fluid_mask, f_b * self.fluid_mask

    # -- boundary conditions ----------------------------------------------
    def _apply_inlet(self, f_r, f_b):
        ny = self.geo.ny
        m = self._row_masks
        if self.bcs.inlet == "neumann":
            f_r, f_b = bc.total_velocity_inlet_top(
                f_r, f_b, self.bcs.inlet_velocity, ny - 2, m[ny - 2])
            f_r = bc.copy_row(f_r, ny - 1, ny - 2, m[ny - 1])
            f_b = bc.copy_row(f_b, ny - 1, ny - 2, m[ny - 1])
        elif self.bcs.inlet == "neumann_per_color":
            # per-color Zou-He velocity inlet
            # (``RKGPU2DBoundary.constantVelocityZHBoundaryHigherRK:11-56``)
            f_r, _ = bc.zou_he_velocity_top(
                f_r, self.bcs.inlet_velocity_r, ny - 2, m[ny - 2])
            f_b, _ = bc.zou_he_velocity_top(
                f_b, self.bcs.inlet_velocity_b, ny - 2, m[ny - 2])
            f_r = bc.copy_row(f_r, ny - 1, ny - 2, m[ny - 1])
            f_b = bc.copy_row(f_b, ny - 1, ny - 2, m[ny - 1])
        elif self.bcs.inlet == "dirichlet":
            f_r = bc.zou_he_pressure_top(f_r, self.bcs.inlet_density_r,
                                         ny - 2, m[ny - 2])
            f_b = bc.zou_he_pressure_top(f_b, self.bcs.inlet_density_b,
                                         ny - 2, m[ny - 2])
            f_r = bc.copy_row(f_r, ny - 1, ny - 2, m[ny - 1])
            f_b = bc.copy_row(f_b, ny - 1, ny - 2, m[ny - 1])
        return f_r, f_b

    def _apply_outlet(self, f_r, f_b):
        m = self._row_masks
        if self.bcs.outlet == "convective":
            f_r = bc.copy_rows_from_above(f_r, (2, 1, 0), (m[2], m[1], m[0]))
            f_b = bc.copy_rows_from_above(f_b, (2, 1, 0), (m[2], m[1], m[0]))
        elif self.bcs.outlet == "dirichlet":
            rho_t = self.bcs.outlet_density_r + self.bcs.outlet_density_b
            f_r, f_b = bc.total_pressure_outlet_bottom(f_r, f_b, rho_t, 1, m[1])
            f_r = bc.copy_row(f_r, 0, 1, m[0])
            f_b = bc.copy_row(f_b, 0, 1, m[0])
        return f_r, f_b

    # -- field computations -------------------------------------------------
    def color_force_fields(self, f_r, f_b):
        """phi, gradient (with wetting), and the CSF force, from PDFs."""
        rho_r = mac.density(f_r)
        rho_b = mac.density(f_b)
        return (rho_r, rho_b) + self.color_force_fields_from_rho(rho_r, rho_b)

    def _repair_phi_rows(self, phi):
        """phi Neumann repair at Dirichlet outlets (``calNeumannPhiOutlet``,
        ``AcceleratedRKGPU2D.py:1363-1380``): phi[1] <- phi[2] and
        phi[0] <- phi[2] on fluid cells, applied after the phase-field
        computation and before the solid-phi extrapolation / gradient
        (reference order: ``RKD2Q9.py:1148-1151,1368-1371``)."""
        m = self._row_masks
        src = phi[2]
        phi = phi.at[1].set(jnp.where(m[1], src, phi[1]))
        return phi.at[0].set(jnp.where(m[0], src, phi[0]))

    def color_force_fields_from_rho(self, rho_r, rho_b):
        """phi, wetted gradient, CSF force from the color densities alone
        (shared by the split and compressed state layouts)."""
        phi = cg.phase_field(rho_r, rho_b) * self.fluid_mask
        if self._phi_repair:
            phi = self._repair_phi_rows(phi)
        phi_ext = cg.solid_phi_extrapolate(phi, self.is_fluid) \
            if self.has_wetting else phi
        gx, gy = cg.color_gradient(phi_ext, self.lat)
        if self.has_wetting:
            rot = (cg.rotate_gradient_on_wetting_xu if self.p.wetting_type == 1
                   else cg.rotate_gradient_on_wetting_akai)
            gx, gy = rot(gx, gy, self.nsx, self.nsy, self.cos_t, self.sin_t,
                         self.wet_fluid)
        fx, fy, kappa = cg.csf_force(
            gx, gy, self.p.surface_tension, self.is_fluid,
            inward_normal=(self.p.wetting_type == 2), lat=self.lat)
        bfx, bfy = self.p.body_force
        if bfx or bfy:
            rho = rho_r + rho_b
            fx = fx + bfx * rho
            fy = fy + bfy * rho
        fx = fx * self.fluid_mask
        fy = fy * self.fluid_mask
        return phi, gx, gy, fx, fy

    # -- compressed state (f_total, rho_r) ----------------------------------
    def pack_state(self, f_r, f_b):
        """(f_r, f_b) -> packed (10, ny, nx) state: planes 0-8 the total
        PDF, plane 9 the red density.  The collision runs on the total PDF
        and recoloring needs only rho_r, so this layout carries 10 HBM
        planes per step instead of 18 (the exact per-color split is not
        retained — rho_r at t+1 is the streamed sum of the recolored red
        populations, reconstructed inside the step)."""
        return jnp.concatenate([f_r + f_b, mac.density(f_r)[None]], axis=0)

    def rho_fields_c(self, s):
        rho = mac.density(s[:9])
        rho_r = s[9]
        return rho_r, rho - rho_r, rho

    def _apply_bcs_c(self, s):
        ny = self.geo.ny
        m = self._row_masks
        if self.bcs.inlet == "neumann":
            s = bc.total_velocity_inlet_top_c(
                s, self.bcs.inlet_velocity, ny - 2, m[ny - 2])
            s = bc.copy_row(s, ny - 1, ny - 2, m[ny - 1])
        elif self.bcs.inlet == "dirichlet":
            rho_t = self.bcs.inlet_density_r + self.bcs.inlet_density_b
            s = bc.zou_he_pressure_top_total_c(s, rho_t, ny - 2, m[ny - 2])
            s = bc.copy_row(s, ny - 1, ny - 2, m[ny - 1])
        if self.bcs.outlet == "convective":
            s = bc.copy_rows_from_above(s, (2, 1, 0), (m[2], m[1], m[0]))
        elif self.bcs.outlet == "dirichlet":
            rho_t = self.bcs.outlet_density_r + self.bcs.outlet_density_b
            s = bc.total_pressure_outlet_bottom_c(s, rho_t, 1, m[1])
            s = bc.copy_row(s, 0, 1, m[0])
        return s

    def _step_csf_c(self, s):
        # jax.named_scope phase annotations (bc/fields/collide/recolor/
        # stream) show up in profiler traces captured via the CLI
        # ``--profile`` flag — observability the reference starts but never
        # reports (``ShanChenD2Q9.py:1080,1493``, SURVEY.md section 5).
        with jax.named_scope("bc"):
            s = self._apply_bcs_c(s)
        with jax.named_scope("fields"):
            rho_r, rho_b, rho = self.rho_fields_c(s)
            phi, gx, gy, fx, fy = self.color_force_fields_from_rho(
                rho_r, rho_b)
            rho_safe = jnp.where(rho > 0, rho, 1.0)
            f_tot = s[:9]
            mx, my = mac.momentum(self.lat, f_tot)
            ux = (mx + 0.5 * fx) / rho_safe
            uy = (my + 0.5 * fy) / rho_safe
            tau = cg.tau_interp_csf(phi, rho_r, rho_b, self.p.tau_r,
                                    self.p.tau_b, self.p.delta,
                                    self.p.tau_type)
        with jax.named_scope("collide"):
            feq_tot = eq.feq_quadratic(self.lat, rho, (ux, uy))
            src = guo_source(self.lat, (ux, uy), (fx, fy))
            if self.p.collision == "SRT":
                f_tot = col.bgk_field_tau(f_tot, feq_tot, tau)
                f_tot = f_tot + (1.0 - 0.5 / tau)[None] * src
            else:
                inv_tau = 1.0 / tau
                f_tot = col.mrt_variable_nu(f_tot, feq_tot, self.lat,
                                            self._mrt_s, inv_tau)
                f_tot = f_tot + col.mrt_force_transform_variable(
                    src, self.lat, self._mrt_s, inv_tau)
        with jax.named_scope("recolor"):
            f_r_post, _ = cg.recolor_lkr(f_tot, rho_r, rho_b, gx, gy,
                                         self.p.beta, self.lat)
        with jax.named_scope("stream"):
            f_tot = stream(f_tot, self.lat, self.upwind_solid) * \
                self.fluid_mask
            rho_r_new = mac.density(
                stream(f_r_post, self.lat, self.upwind_solid)) * \
                self.fluid_mask
        return jnp.concatenate([f_tot, rho_r_new[None]], axis=0)

    def _step_pert_c(self, s):
        """Compressed Perturbation step: the per-color BGK collision with a
        shared tau(phi) is linear in the PDFs, so the total update needs
        only (rho_r, rho_b)."""
        s = self._apply_bcs_c(s)
        rho_r, rho_b, rho = self.rho_fields_c(s)
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        phi = cg.phase_field(rho_r, rho_b) * self.fluid_mask
        if self._phi_repair:
            phi = self._repair_phi_rows(phi)
        f_tot = s[:9]
        mx, my = mac.momentum(self.lat, f_tot)
        ux = mx / rho_safe
        uy = my / rho_safe
        tau = cg.tau_interp_grunau(phi, self.p.tau_r, self.p.tau_b,
                                   self.p.delta)
        feq_tot = eq.feq_rk_original(self.lat, rho_r, (ux, uy),
                                     self.const_cr) + \
            eq.feq_rk_original(self.lat, rho_b, (ux, uy), self.const_cb)
        if self.p.collision == "MRT":
            f_tot = col.mrt_variable_nu(f_tot, feq_tot, self.lat,
                                        self._mrt_s, 1.0 / tau)
        else:
            f_tot = col.bgk_field_tau(f_tot, feq_tot, tau)
        gx, gy = self._pert_gradient(rho_r, rho_b)
        f_tot = f_tot + cg.perturbation(
            gx, gy, self.p.a_kr + self.p.a_kb, cg.B_CONSTANTS, self.lat)
        f_r_post, _ = cg.recolor_rk_original(
            f_tot, rho_r, rho_b, gx, gy, self.p.beta,
            self.const_cr, self.const_cb, self.lat)
        f_tot = stream(f_tot, self.lat, self.upwind_solid) * self.fluid_mask
        rho_r_new = mac.density(
            stream(f_r_post, self.lat, self.upwind_solid)) * self.fluid_mask
        return jnp.concatenate([f_tot, rho_r_new[None]], axis=0)

    def _step_impl_c(self, s):
        if self.bcs.outlet in ("modified_periodic", "convective_average"):
            raise NotImplementedError(
                f"{self.bcs.outlet} needs the split state (per-color "
                "pre-step PDFs / seam color swap)")
        if self.p.variant == "CSF":
            return self._step_csf_c(s)
        return self._step_pert_c(s)

    def step_c(self, s):
        return self._step_c(s)

    def macro_c(self, s):
        """Diagnostics from the compressed state."""
        rho_r, rho_b, rho = self.rho_fields_c(s)
        phi, gx, gy, fx, fy = self.color_force_fields_from_rho(rho_r, rho_b)
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        mx, my = mac.momentum(self.lat, s[:9])
        ux = (mx + 0.5 * fx) / rho_safe
        uy = (my + 0.5 * fy) / rho_safe
        return rho_r, rho_b, phi, (ux, uy)

    def _apply_convective_average(self, f_r, f_b, f_old, uy):
        """Averaged convective outlet trio: each outlet row blends its own
        pre-step PDFs with the fresh row above at the speed of the first
        interior row, f = (f_old + |v3| f_up)/(1 + |v3|)
        (``convectiveAverageBoundaryGPU{,2,3}:791-886``; the reference
        allocates the f_old buffers for this mode at ``RKD2Q9.py:1285-1287``
        but never launches the kernels — wired here as designed)."""
        m = self._row_masks
        vy3 = uy[3]
        rows = (2, 1, 0)
        masks = (m[2], m[1], m[0])
        f_r = bc.convective_outlet_rows(f_r, f_old[0], vy3, rows, masks)
        f_b = bc.convective_outlet_rows(f_b, f_old[1], vy3, rows, masks)
        return f_r, f_b

    # -- CSF step ---------------------------------------------------------
    def _step_csf(self, f_r, f_b):
        f_r, f_b = self._apply_inlet(f_r, f_b)
        f_r, f_b = self._apply_outlet(f_r, f_b)
        f_old = (f_r, f_b) if self.bcs.outlet == "convective_average" \
            else None
        rho_r, rho_b, phi, gx, gy, fx, fy = self.color_force_fields(f_r, f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)

        f_tot = f_r + f_b
        mx, my = mac.momentum(self.lat, f_tot)
        ux = (mx + 0.5 * fx) / rho_safe
        uy = (my + 0.5 * fy) / rho_safe

        tau = cg.tau_interp_csf(phi, rho_r, rho_b, self.p.tau_r, self.p.tau_b,
                                self.p.delta, self.p.tau_type)
        feq_tot = (eq.feq_quadratic(self.lat, rho_r, (ux, uy)) +
                   eq.feq_quadratic(self.lat, rho_b, (ux, uy)))
        src = guo_source(self.lat, (ux, uy), (fx, fy))
        if self.p.collision == "SRT":
            f_tot = col.bgk_field_tau(f_tot, feq_tot, tau)
            f_tot = f_tot + (1.0 - 0.5 / tau)[None] * src
        else:
            inv_tau = 1.0 / tau
            f_tot = col.mrt_variable_nu(f_tot, feq_tot, self.lat, self._mrt_s,
                                        inv_tau)
            f_tot = f_tot + col.mrt_force_transform_variable(
                src, self.lat, self._mrt_s, inv_tau)
        f_r, f_b = cg.recolor_lkr(f_tot, rho_r, rho_b, gx, gy, self.p.beta,
                                  self.lat)
        f_r = stream(f_r, self.lat, self.upwind_solid) * self.fluid_mask
        f_b = stream(f_b, self.lat, self.upwind_solid) * self.fluid_mask
        f_r, f_b = self._post_stream(f_r, f_b)
        if f_old is not None:
            f_r, f_b = self._apply_convective_average(f_r, f_b, f_old, uy)
        return f_r, f_b

    # -- Perturbation step --------------------------------------------------
    def _pert_gradient(self, rho_r, rho_b):
        """Color gradient of (rho_R - rho_B) with solidDiff on solid voxels
        (``calRKCollision23GPU:267-285``)."""
        diff = (rho_r - rho_b) * self.fluid_mask + \
            self.p.solid_phi * (1.0 - self.fluid_mask)
        gx = jnp.zeros_like(diff)
        gy = jnp.zeros_like(diff)
        for i in range(1, 9):
            dx, dy = int(self.lat.e[i, 0]), int(self.lat.e[i, 1])
            w = float(self._grad_scheme[i])
            s = shift(diff, dx, dy)
            if dx:
                gx = gx + (w * dx) * s
            if dy:
                gy = gy + (w * dy) * s
        return gx, gy

    def _step_perturbation(self, f_r, f_b):
        f_r, f_b = self._apply_inlet(f_r, f_b)
        f_r, f_b = self._apply_outlet(f_r, f_b)
        f_old = (f_r, f_b) if self.bcs.outlet == "convective_average" \
            else None
        rho_r = mac.density(f_r)
        rho_b = mac.density(f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        phi = cg.phase_field(rho_r, rho_b) * self.fluid_mask
        if self._phi_repair:
            phi = self._repair_phi_rows(phi)
        mx, my = mac.momentum(self.lat, f_r + f_b)
        ux = mx / rho_safe
        uy = my / rho_safe
        tau = cg.tau_interp_grunau(phi, self.p.tau_r, self.p.tau_b,
                                   self.p.delta)
        feq_r = eq.feq_rk_original(self.lat, rho_r, (ux, uy), self.const_cr)
        feq_b = eq.feq_rk_original(self.lat, rho_b, (ux, uy), self.const_cb)
        if self.p.collision == "MRT":
            # per-color moment-space collision with the shared tau(phi)
            # (``calRKCollision1GPU2DMRT``, AcceleratedRKGPU2D.py:429)
            inv_tau = 1.0 / tau
            f_r = col.mrt_variable_nu(f_r, feq_r, self.lat, self._mrt_s,
                                      inv_tau)
            f_b = col.mrt_variable_nu(f_b, feq_b, self.lat, self._mrt_s,
                                      inv_tau)
        else:
            f_r = col.bgk_field_tau(f_r, feq_r, tau)
            f_b = col.bgk_field_tau(f_b, feq_b, tau)
        # perturbation + recoloring on the per-color PDFs
        gx, gy = self._pert_gradient(rho_r, rho_b)
        f_r = f_r + cg.perturbation(gx, gy, self.p.a_kr, cg.B_CONSTANTS,
                                    self.lat)
        f_b = f_b + cg.perturbation(gx, gy, self.p.a_kb, cg.B_CONSTANTS,
                                    self.lat)
        f_tot = f_r + f_b
        f_r, f_b = cg.recolor_rk_original(
            f_tot, rho_r, rho_b, gx, gy, self.p.beta,
            self.const_cr, self.const_cb, self.lat)
        f_r = stream(f_r, self.lat, self.upwind_solid) * self.fluid_mask
        f_b = stream(f_b, self.lat, self.upwind_solid) * self.fluid_mask
        f_r, f_b = self._post_stream(f_r, f_b)
        if f_old is not None:
            f_r, f_b = self._apply_convective_average(f_r, f_b, f_old, uy)
        return f_r, f_b

    def _post_stream(self, f_r, f_b):
        """Post-streaming seam handling: the 'modified periodic' boundary
        swaps the incoming colors at the periodic seam so an invading front
        re-enters as the defending fluid
        (``calModifiedPeriodicBoundary:1382-1408``)."""
        if self.bcs.outlet == "modified_periodic":
            ny = self.geo.ny
            f_r, f_b = bc.modified_periodic_color_swap(
                f_r, f_b, self._row_masks[0], self._row_masks[ny - 1])
        return f_r, f_b

    def _step_impl(self, f_r, f_b):
        if self.p.variant == "CSF":
            return self._step_csf(f_r, f_b)
        return self._step_perturbation(f_r, f_b)

    def step(self, state):
        return self._step(*state)

    # -- diagnostics -------------------------------------------------------
    def macro(self, state):
        f_r, f_b = state
        rho_r, rho_b, phi, gx, gy, fx, fy = self.color_force_fields(f_r, f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        mx, my = mac.momentum(self.lat, f_r + f_b)
        ux = (mx + 0.5 * fx) / rho_safe
        uy = (my + 0.5 * fy) / rho_safe
        return rho_r, rho_b, phi, (ux, uy)
