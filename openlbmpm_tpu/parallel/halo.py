"""Explicit halo exchange over the device mesh with shard_map + ppermute.

Two multi-chip modes coexist in this framework (SURVEY.md section 2.12):

1. **XLA-auto** (default): the jnp step is jitted with `NamedSharding`s and
   the SPMD partitioner lowers every rolled gather into collective-permute
   boundary exchanges — zero code changes, proven equivalent to 1e-12 in
   ``tests/test_multichip.py``.
2. **Explicit** (this module): `shard_map` gives each device its local
   block; :func:`exchange_halo` ships the one-to-H-cell rim to the two x
   neighbors with `jax.lax.ppermute` (NVLink between GPUs of one host),
   and the local compute runs on the padded block.  It lets the halo
   exchange be scheduled, overlapped or fused explicitly.

:func:`make_sharded_stepper` wraps a radius-bounded periodic step function
into a shard_map step: pad with neighbor columns -> run the local step on
the padded block -> crop.  Exact for any step whose x-dependence has
stencil radius <= halo and whose only x coupling is through those stencils
(true for every model here: BC rows are full x-lines and stay local).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["exchange_halo", "make_sharded_stepper"]


def exchange_halo(f, halo: int, axis_name: str = "x"):
    """Pad the trailing (x) axis of a local block with `halo` columns from
    the left/right mesh neighbors (periodic ring of `ppermute`s).

    f: (..., nx_local) -> (..., nx_local + 2 * halo).
    """
    n = jax.lax.psum(1, axis_name)
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    # my left ghost = right edge of my left neighbor
    left_ghost = jax.lax.ppermute(f[..., -halo:], axis_name, right)
    right_ghost = jax.lax.ppermute(f[..., :halo], axis_name, left)
    return jnp.concatenate([left_ghost, f, right_ghost], axis=-1)


def make_sharded_stepper(local_step, mesh: Mesh, state_ndim: int,
                         halo: int, axis_name: str = "x"):
    """Wrap `local_step` (a pure step on a full periodic array) into an
    explicitly halo-exchanged shard_map step over `mesh`'s x axis.

    local_step must be correct on any x-window whose rim of `halo` columns
    carries valid neighbor data (interior results then equal the global
    step; the wrap-around it applies inside the padded window only pollutes
    the rim, which is cropped).

    Args:
      local_step: state -> state, radius <= halo in x.
      state_ndim: rank of each state array (x last).
      halo: rim width in columns.
    Returns a jitted step operating on globally-sharded arrays.
    """
    spec = P(*((None,) * (state_ndim - 1) + (axis_name,)))

    def padded_step(*state):
        padded = tuple(exchange_halo(s, halo, axis_name) for s in state)
        out = local_step(*padded)
        single = not isinstance(out, tuple)
        if single:
            out = (out,)
        out = tuple(o[..., halo:-halo] for o in out)
        return out[0] if single else out

    def wrapper(*state):
        probe_single = len(state) == 1
        out_specs = spec if probe_single else (spec,) * len(state)
        fn = shard_map(padded_step, mesh=mesh,
                       in_specs=(spec,) * len(state),
                       out_specs=out_specs)
        return fn(*state)

    return jax.jit(wrapper)
