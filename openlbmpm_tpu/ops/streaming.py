"""Pull streaming with fused half-way bounce-back.

Gather reformulation of the reference's push/scatter streaming
(``/root/reference/ShanChen2D/OptimizedD2Q9GPU.py:452-548``): the scatter
"push f_i to the neighbor, or reflect into the opposite slot when the
neighbor is solid" is exactly equivalent, in gather form, to

    f_i'(x) = f_i(x - e_i)        if x - e_i is fluid
            = f_opp(i)(x)         if x - e_i is solid   (half-way bounce-back)

which vectorizes as a rolled gather plus a select against the precomputed
upwind-solid mask.  Verified against a NumPy oracle of the reference kernel
in ``tests/test_streaming.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice
from .common import pull

__all__ = ["upwind_solid_masks", "stream", "stream_and_mask",
           "stream_moving_wall"]


def upwind_solid_masks(lat: Lattice, is_solid: np.ndarray) -> np.ndarray:
    """(Q, *spatial) bool: is the upwind source x - e_i a solid voxel?"""
    is_solid = np.asarray(is_solid, dtype=bool)
    masks = [np.zeros_like(is_solid)]  # rest population never bounces
    for i in range(1, lat.q):
        d = lat.e[i]
        if lat.dim == 2:
            m = np.roll(is_solid, shift=(int(d[1]), int(d[0])), axis=(0, 1))
        else:
            m = np.roll(is_solid, shift=(int(d[2]), int(d[1]), int(d[0])),
                        axis=(0, 1, 2))
        masks.append(m)
    return np.stack(masks)


def stream(f: jnp.ndarray, lat: Lattice, upwind_solid: jnp.ndarray) -> jnp.ndarray:
    """Stream one PDF stack.

    Args:
      f: (Q, *spatial) pre-stream populations.
      lat: lattice descriptor.
      upwind_solid: (Q, *spatial) bool from :func:`upwind_solid_masks`.

    Returns:
      (Q, *spatial) post-stream populations (values on solid voxels are
      not meaningful; mask downstream or use :func:`stream_and_mask`).
    """
    qax = -1 - lat.dim  # the Q axis, supporting leading batch axes
    outs = [jnp.take(f, 0, axis=qax)]
    for i in range(1, lat.q):
        d = lat.e[i]
        fi = jnp.take(f, i, axis=qax)
        fopp = jnp.take(f, int(lat.opp[i]), axis=qax)
        if lat.dim == 2:
            pulled = pull(fi, int(d[0]), int(d[1]))
        else:
            pulled = pull(fi, int(d[0]), int(d[1]), int(d[2]))
        outs.append(jnp.where(upwind_solid[i], fopp, pulled))
    return jnp.stack(outs, axis=qax)


def stream_and_mask(f: jnp.ndarray, lat: Lattice, upwind_solid: jnp.ndarray,
                    fluid_mask: jnp.ndarray) -> jnp.ndarray:
    """Stream and zero out populations on solid voxels."""
    return stream(f, lat, upwind_solid) * fluid_mask


def stream_moving_wall(f: jnp.ndarray, lat: Lattice,
                       upwind_solid: jnp.ndarray, rho: jnp.ndarray,
                       u_wall, upwind_moving: jnp.ndarray | None = None
                       ) -> jnp.ndarray:
    """Pull streaming with moving-wall link bounce-back.

    Bounced populations pick up the wall-momentum term
    -6 w_i rho (e_i . u_wall) (device fn ``calLinkBounceBack`` inside
    ``calStreaming1withLinkGPU``, ``OptimizedD2Q9GPU.py:1664-1692``: the
    push form subtracts the term from the reflected opposite slot; in pull
    form the bounced f_opp(i) at x gains -6 w_opp(i) rho (e_opp(i).u_wall)
    = +6 w_i rho (e_i . u_wall) for the incoming direction i).

    Args:
      rho: (..., *spatial) density of the bouncing fluid.
      u_wall: tuple of wall-velocity components (scalars or fields).
      upwind_moving: optional (Q, *spatial) bool — links whose upwind solid
        voxel belongs to the MOVING wall (``upwind_solid_masks`` of the
        moving-wall subset).  When given, only those links pick up the
        momentum term; other solid links bounce plainly.  Default: every
        solid wall moves.
    """
    qax = -1 - lat.dim
    outs = [jnp.take(f, 0, axis=qax)]
    for i in range(1, lat.q):
        d = lat.e[i]
        fi = jnp.take(f, i, axis=qax)
        io = int(lat.opp[i])
        fopp = jnp.take(f, io, axis=qax)
        e_dot_uw = sum(float(lat.e[i, k]) * u_wall[k]
                       for k in range(lat.dim))
        term = 6.0 * float(lat.w[i]) * rho * e_dot_uw
        if upwind_moving is not None:
            term = jnp.where(upwind_moving[i], term, 0.0)
        bounced = fopp + term
        if lat.dim == 2:
            pulled = pull(fi, int(d[0]), int(d[1]))
        else:
            pulled = pull(fi, int(d[0]), int(d[1]), int(d[2]))
        outs.append(jnp.where(upwind_solid[i], bounced, pulled))
    return jnp.stack(outs, axis=qax)
