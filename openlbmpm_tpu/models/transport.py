"""Coupled two-phase flow + solute transport (``RKCG2D/Transport2DRK.py``).

One coupled step interleaves a CSF color-gradient flow step with a tracer
transport step, as in ``runTransport2DMPMCRKNew`` (``Transport2DRK.py:1059-1485``,
call stack SURVEY.md section 3.4): the transport substep sees the flow's
velocity, color gradient, and the transport-domain mask derived from the red
density (tracers confined to one phase), then both fields advance.

Standalone (fixed velocity field) transport is supported by `standalone=True`.

State: ``TransportState(f_r, f_b, g)`` with g (T, Q, ny, nx) the tracer PDFs.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..lattice import D2Q5, D2Q9
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops import transport as tr
from ..ops.streaming import stream, upwind_solid_masks
from .colorgradient import CGBoundaryConfig, ColorGradientParams, ColorGradientRK

__all__ = ["TransportParams", "TransportState", "TransportRK"]


class TransportState(NamedTuple):
    f_r: jnp.ndarray
    f_b: jnp.ndarray
    g: jnp.ndarray          # tracer PDFs (T, Q, ny, nx)
    mass0: jnp.ndarray      # (T,) initial tracer mass (conservation repair)


@dataclasses.dataclass(frozen=True)
class TransportParams:
    num_tracers: int = 1
    scheme: int = 5                       # 5 (D2Q5) | 9 (D2Q9)
    tau: tuple = (1.0,)                   # per-tracer relaxation times
    j0: tuple = (0.25,)                   # J-scheme rest coefficients (D2Q5)
    relaxation: Literal["SRT", "MRT"] = "SRT"
    mrt_equilibrium: Literal["linear", "quadratic"] = "linear"
    # anisotropic diffusion tensor per tracer (MRT only)
    diff_x: tuple = (0.1,)
    diff_y: tuple = (0.1,)
    diff_xy: tuple = (0.0,)
    diff_yx: tuple = (0.0,)
    beta_interface: tuple = (0.0,)        # partition coefficient per tracer
    # "redistribute" = hard bounce-back confinement + the moving-interface
    # concentration redistribution of the reference's node-status loop
    # (``Transport2DRK.py:479-695``, ``AccelerateTransport2DRK.py:216-302``):
    # when the phase front moves, exited nodes hand their tracer mass to
    # in-domain neighbors and entered nodes borrow from donors — locally
    # mass-conserving, no global renormalization needed.
    interface_mode: Literal["permeable", "bounceback", "redistribute",
                            "none"] = "permeable"
    reaction_rate: float = 0.0            # bilinear A + B -> C rate
    reaction_stoich: tuple = (-1.0, -1.0, 1.0)
    criteria: float = 0.5                 # rho_R threshold of the host phase
    inlet: Literal["none", "inamuro", "anti_bounce_back", "zero"] = "none"
    inlet_conc: tuple = (1.0,)
    outlet: Literal["none", "freeflow"] = "none"
    conserve_mass: bool = False           # renormalization repair op


class TransportRK:
    """Coupled CSF flow + phase-confined tracer transport."""

    def __init__(self, geometry: Geometry, flow_params: ColorGradientParams,
                 transport_params: TransportParams,
                 boundaries: CGBoundaryConfig = CGBoundaryConfig(),
                 standalone: bool = False, dtype=jnp.float32):
        self.geo = geometry
        self.tp = transport_params
        self.dtype = dtype
        self.standalone = standalone
        self.flow = ColorGradientRK(geometry, flow_params, boundaries, dtype)
        self.lat_tr = D2Q5 if transport_params.scheme == 5 else D2Q9
        self.fluid_mask = self.flow.fluid_mask
        self.upwind_solid_tr = jnp.asarray(
            upwind_solid_masks(self.lat_tr, geometry.is_solid))
        self.tau_tr = np.asarray(transport_params.tau, np.float64)
        self.j_coeffs = tr.j_coefficients(np.asarray(transport_params.j0))
        if transport_params.relaxation == "MRT":
            build = tr.mrt_matrices_d2q5 if transport_params.scheme == 5 \
                else tr.mrt_matrices_d2q9
            self.mrt_update = build(transport_params.diff_x,
                                    transport_params.diff_y,
                                    transport_params.diff_xy,
                                    transport_params.diff_yx)
        ny = geometry.ny
        self._row_masks = {r: jnp.asarray(geometry.is_fluid[r], bool)
                           for r in (0, 1, 2, ny - 1, ny - 2)}
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    # ------------------------------------------------------------------
    def init_state(self, flow_state, conc0: np.ndarray) -> TransportState:
        """conc0: (T, ny, nx) initial concentrations.  PDFs start at
        w_i C (``Transport2DRK.py:466-469``)."""
        t = self.tp.num_tracers
        conc0 = jnp.asarray(conc0, self.dtype) * self.fluid_mask
        assert conc0.shape[0] == t
        w = jnp.asarray(self.lat_tr.w, self.dtype).reshape(1, -1, 1, 1)
        g = conc0[:, None] * w
        mass0 = jnp.sum(conc0, axis=(-2, -1))
        return TransportState(flow_state[0], flow_state[1], g, mass0)

    def concentration(self, g):
        return jnp.sum(g, axis=1)

    # ------------------------------------------------------------------
    def _transport_substep(self, g, mass0, u, gx, gy, rho_r):
        tp = self.tp
        lat = self.lat_tr
        conc = self.concentration(g)
        in_domain, value = tr.transport_domain_mask(rho_r, tp.criteria)

        # collision
        if tp.relaxation == "MRT":
            feq_fn = eq.feq_transport_quadratic \
                if tp.mrt_equilibrium == "quadratic" \
                else eq.feq_transport_linear
            geq = feq_fn(lat, conc, u)  # (T, Q, ny, nx)
            g = tr.mrt_collide(g, geq, self.mrt_update)
        else:
            if tp.scheme == 5:
                geq = jnp.stack([
                    eq.feq_transport_j(lat, conc[i], u, self.j_coeffs[i])
                    for i in range(tp.num_tracers)])
            else:
                geq = eq.feq_transport_linear(lat, conc, u)
            tau_b = jnp.asarray(self.tau_tr, self.dtype).reshape(-1, 1, 1, 1)
            g = g - (g - geq) / tau_b

        # interface partition / leak control
        if tp.interface_mode == "permeable" and any(tp.beta_interface):
            g = tr.interface_partition(g, conc, gx, gy, value,
                                       tp.beta_interface, lat)
        # reaction
        if tp.reaction_rate:
            g = tr.bilinear_reaction(g, conc, tp.reaction_rate,
                                     self.j_coeffs if tp.scheme == 5
                                     else np.tile(lat.w, (tp.num_tracers, 1)),
                                     np.asarray(tp.reaction_stoich))
        # outlet BC before streaming (reference order, Transport2DRK.py:1368)
        m = self._row_masks
        if tp.outlet == "freeflow":
            g = tr.free_flow_outlet(g, (2, 1, 0), (m[2], m[1], m[0]))

        # streaming with solid bounce-back, masked to the pore space
        g = stream(g, lat, self.upwind_solid_tr) * self.fluid_mask

        # hard interface bounce-back (post-streaming repair); redistribute
        # mode confines the same way in-step, then repairs front motion in
        # the step epilogue
        if tp.interface_mode in ("bounceback", "redistribute"):
            g = tr.interface_bounce_back(g, in_domain, lat)

        # inlet BC after streaming
        ny = self.geo.ny
        if tp.inlet == "inamuro":
            g = tr.inamuro_inlet(g, tp.inlet_conc, ny - 1, m[ny - 1])
        elif tp.inlet == "anti_bounce_back":
            g = tr.anti_bounce_back_inlet(g, tp.inlet_conc, ny - 2,
                                          m[ny - 1],
                                          w3=float(lat.w[3]))
        elif tp.inlet == "zero":
            g = tr.zero_concentration_inlet(g, ny - 2, m[ny - 2])

        # optional mass-conservation repair
        if tp.conserve_mass:
            conc = self.concentration(g)
            u_norm_sq = u[0] * u[0] + u[1] * u[1]
            g, _ = tr.renormalize_concentration(
                g, conc, mass0, in_domain, u_norm_sq,
                self.j_coeffs, u, lat)
        return g

    def _step_impl(self, state: TransportState) -> TransportState:
        f_r, f_b, g, mass0 = state
        rho_r, rho_b, phi, gx, gy, fx, fy = \
            self.flow.color_force_fields(f_r, f_b)
        rho = rho_r + rho_b
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        mx, my = mac.momentum(self.flow.lat, f_r + f_b)
        u = ((mx + 0.5 * fx) / rho_safe, (my + 0.5 * fy) / rho_safe)
        g = self._transport_substep(g, mass0, u, gx, gy, rho_r)
        if not self.standalone:
            f_r, f_b = self.flow._step_impl(f_r, f_b)
            if self.tp.interface_mode == "redistribute":
                g = self._redistribute(g, rho_r, mac.density(f_r))
        return TransportState(f_r, f_b, g, mass0)

    def _redistribute(self, g, rho_r_old, rho_r_new):
        """Moving-front concentration redistribution epilogue
        (``calUpdateConcOnNewNodesGPU`` family,
        ``AccelerateTransport2DRK.py:216-302``): compares the transport
        domain before and after the flow advance and exchanges the tracer
        mass of exited/entered nodes locally."""
        in_old, _ = tr.transport_domain_mask(rho_r_old, self.tp.criteria)
        in_new, _ = tr.transport_domain_mask(rho_r_new, self.tp.criteria)
        in_old = jnp.logical_and(in_old, self.fluid_mask > 0)
        in_new = jnp.logical_and(in_new, self.fluid_mask > 0)
        return tr.redistribute_on_interface_motion(
            g, in_new, in_old, self.j_coeffs if self.tp.scheme == 5
            else np.tile(self.lat_tr.w, (self.tp.num_tracers, 1)),
            self.lat_tr)

    def step(self, state: TransportState) -> TransportState:
        return self._step(state)
