"""Single-phase D2Q9 flow solver (SRT / TRT / MRT) on a dense masked grid.

Capability parity with the reference's ``BasicD2Q9`` CPU solver
(``/root/reference/ShanChen2D/SimpleD2Q9.py:221-331``: numpy-roll streaming,
full bounce-back, moment-space MRT) rebuilt as a single fused jitted step:
macro -> collide (+ optional Guo body force) -> pull-stream with half-way
bounce-back -> row boundary conditions.

This is the M1 "minimum end-to-end slice" of SURVEY.md section 7.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..lattice import D2Q9
from ..ops import boundaries as bc
from ..ops import collision as col
from ..ops import equilibrium as eq
from ..ops import macroscopic as mac
from ..ops.forcing import guo_source
from ..ops.streaming import (stream, stream_moving_wall,
                             upwind_solid_masks)

__all__ = ["SinglePhaseD2Q9", "BoundaryConfig"]


@dataclasses.dataclass(frozen=True)
class BoundaryConfig:
    """Row boundary conditions for channel-type domains.

    kinds: 'periodic' (default; rolls wrap naturally),
    'zou_he_velocity' (inlet top), 'zou_he_pressure' (either side).
    """

    inlet: str = "periodic"           # top side (y = ny - 1 ghost, ny - 2 BC row)
    outlet: str = "periodic"          # bottom side (row 1 BC, row 0 ghost)
    inlet_velocity: float = 0.0       # v_y at the inlet (negative = inflow)
    inlet_density: float = 1.0
    outlet_density: float = 1.0


class SinglePhaseD2Q9:
    """Single-component D2Q9 solver."""

    def __init__(
        self,
        geometry: Geometry,
        tau: float = 1.0,
        collision: Literal["SRT", "TRT", "MRT"] = "SRT",
        body_force: tuple[float, float] = (0.0, 0.0),
        boundaries: BoundaryConfig = BoundaryConfig(),
        dtype=jnp.float32,
        moving_wall_mask: np.ndarray | None = None,
        wall_velocity: tuple[float, float] = (0.0, 0.0),
    ):
        """moving_wall_mask: bool (ny, nx) subset of the solid voxels that
        translate at ``wall_velocity`` — streaming then uses the
        moving-wall link bounce-back of ``calStreaming1withLinkGPU`` /
        ``calLinkBounceBack`` (``OptimizedD2Q9GPU.py:1664-1692``), the
        lid-driven-cavity capability the reference keeps commented out at
        ``ShanChenD2Q9.py:1595-1599``."""
        self.lat = D2Q9
        self.geo = geometry
        self.tau = float(tau)
        self.collision = collision
        self.body_force = (float(body_force[0]), float(body_force[1]))
        self.bcs = boundaries
        self.dtype = dtype

        self.fluid_mask = jnp.asarray(geometry.is_fluid, dtype)
        self.upwind_solid = jnp.asarray(
            upwind_solid_masks(self.lat, geometry.is_solid))
        self.wall_velocity = (float(wall_velocity[0]),
                              float(wall_velocity[1]))
        self.upwind_moving = None
        if moving_wall_mask is not None and any(self.wall_velocity):
            mm = np.asarray(moving_wall_mask, bool)
            if not (mm <= geometry.is_solid).all():
                raise ValueError("moving_wall_mask must lie on solid voxels")
            self.upwind_moving = jnp.asarray(
                upwind_solid_masks(self.lat, mm))
        if collision == "MRT":
            self._s_vec = col.mrt_relaxation_d2q9_sc(self.tau)
        ny = geometry.ny
        self._row_masks = {
            r: jnp.asarray(geometry.is_fluid[r], bool) for r in
            (0, 1, 2, ny - 1, ny - 2)
        }
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    # -- state ------------------------------------------------------------
    def init_state(self, rho0: float = 1.0, u0=(0.0, 0.0)) -> jnp.ndarray:
        ny, nx = self.geo.shape
        rho = jnp.full((ny, nx), rho0, self.dtype) * self.fluid_mask
        ux = jnp.full((ny, nx), u0[0], self.dtype) * self.fluid_mask
        uy = jnp.full((ny, nx), u0[1], self.dtype) * self.fluid_mask
        return eq.feq_quadratic(self.lat, rho, (ux, uy))

    # -- physics ----------------------------------------------------------
    def macro(self, f):
        rho = mac.density(f)
        has_force = any(self.body_force)
        force = None
        if has_force:
            fx = self.body_force[0] * rho
            fy = self.body_force[1] * rho
            force = (fx, fy)
        u = mac.velocity(self.lat, f, rho, force)
        return rho, u

    def _collide(self, f):
        rho = mac.density(f)
        fx = self.body_force[0] * rho
        fy = self.body_force[1] * rho
        u = mac.velocity(self.lat, f, rho, (fx, fy))
        feq = eq.feq_quadratic(self.lat, rho, u)
        if self.collision == "SRT":
            f = col.bgk(f, feq, self.tau)
        elif self.collision == "TRT":
            f = col.trt(f, feq, self.lat, self.tau)
        else:
            f = col.mrt(f, feq, self.lat, self._s_vec)
        if any(self.body_force):
            src = guo_source(self.lat, u, (fx, fy))
            if self.collision == "SRT":
                f = f + (1.0 - 0.5 / self.tau) * src
            elif self.collision == "TRT":
                f = f + col.trt_force_transform(src, self.lat, self.tau)
            else:
                f = f + col.mrt_force_transform(src, self.lat, self._s_vec)
        return f

    def _apply_bcs(self, f):
        ny = self.geo.ny
        if self.bcs.inlet == "zou_he_velocity":
            f2 = f[None]
            f2, _ = bc.zou_he_velocity_top(
                f2, self.bcs.inlet_velocity, ny - 2, self._row_masks[ny - 2])
            f = f2[0]
            f = bc.copy_row(f, ny - 1, ny - 2, self._row_masks[ny - 1])
        elif self.bcs.inlet == "zou_he_pressure":
            f = bc.zou_he_pressure_top(
                f, self.bcs.inlet_density, ny - 2, self._row_masks[ny - 2])
            f = bc.copy_row(f, ny - 1, ny - 2, self._row_masks[ny - 1])
        if self.bcs.outlet == "zou_he_pressure":
            f = bc.zou_he_pressure_bottom(
                f, self.bcs.outlet_density, 1, self._row_masks[1])
            f = bc.copy_row(f, 0, 1, self._row_masks[0])
        elif self.bcs.outlet == "convective":
            f = bc.copy_rows_from_above(
                f, (2, 1, 0),
                (self._row_masks[2], self._row_masks[1], self._row_masks[0]))
        return f

    def _step_impl(self, f):
        if self.upwind_moving is not None:
            rho = mac.density(f)
        f = self._collide(f)
        if self.upwind_moving is not None:
            f = stream_moving_wall(f, self.lat, self.upwind_solid, rho,
                                   self.wall_velocity, self.upwind_moving)
            f = f * self.fluid_mask
        else:
            f = stream(f, self.lat, self.upwind_solid) * self.fluid_mask
        f = self._apply_bcs(f)
        return f

    def step(self, f):
        return self._step(f)

    @property
    def nu(self) -> float:
        """Kinematic viscosity (tau - 1/2)/3."""
        return (self.tau - 0.5) / 3.0
