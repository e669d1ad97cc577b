"""Shared helpers: periodic shifts and lattice-constant broadcasting."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..lattice import Lattice

# Precision of every small dense contraction in the steps (MRT moment
# transforms, SC force G-matrix sums, transport MRT).  The GPU's default
# f32 matmul runs in TF32, which keeps ~3 decimal digits; HIGHEST keeps
# full f32.  Read at trace time as ``common.CONTRACTION_PRECISION``.
CONTRACTION_PRECISION = lax.Precision.HIGHEST


def shift(a: jnp.ndarray, dx: int, dy: int, dz: int | None = None) -> jnp.ndarray:
    """Return array whose value at x is a(x + d), with periodic wrap.

    Works on the trailing spatial axes: (..., ny, nx) in 2D or
    (..., nz, ny, nx) in 3D.  A gather of the "upwind" neighbor value:
    ``shift(a, dx, dy)[..., y, x] == a[..., y + dy, x + dx]``.
    """
    if dz is None:
        return jnp.roll(a, shift=(-dy, -dx), axis=(-2, -1))
    return jnp.roll(a, shift=(-dz, -dy, -dx), axis=(-3, -2, -1))


def pull(a: jnp.ndarray, dx: int, dy: int, dz: int | None = None) -> jnp.ndarray:
    """Value at x of a(x - d): the pull-streaming gather for velocity d."""
    if dz is None:
        return jnp.roll(a, shift=(dy, dx), axis=(-2, -1))
    return jnp.roll(a, shift=(dz, dy, dx), axis=(-3, -2, -1))


def bcast_1d(v: np.ndarray, spatial_ndim: int, dtype) -> jnp.ndarray:
    """Broadcast a per-direction constant (Q,) against (Q, *spatial)."""
    return jnp.asarray(v, dtype=dtype).reshape((-1,) + (1,) * spatial_ndim)


def expand_q(x: jnp.ndarray, lat: Lattice) -> jnp.ndarray:
    """Insert the direction axis: (..., *spatial) -> (..., 1, *spatial)."""
    return jnp.expand_dims(x, -(lat.dim + 1))


def e_dot_u(lat: Lattice, u, dtype):
    """(..., Q, *spatial) array of e_i . u for u = (ux, uy[, uz]).

    Each u component may carry leading batch axes (fluids/tracers); the
    direction axis is inserted at -(dim + 1), matching the state layout
    f = (..., Q, *spatial).
    """
    acc = bcast_1d(lat.e[:, 0], lat.dim, dtype) * expand_q(u[0], lat)
    acc = acc + bcast_1d(lat.e[:, 1], lat.dim, dtype) * expand_q(u[1], lat)
    if lat.dim == 3:
        acc = acc + bcast_1d(lat.e[:, 2], lat.dim, dtype) * expand_q(u[2], lat)
    return acc
