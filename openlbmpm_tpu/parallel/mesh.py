"""Domain decomposition over a device mesh.

The reference's only parallelism is a single-GPU CUDA thread grid
(SURVEY.md section 2.12); here the domain is decomposed in 1D/2D over a
``jax.sharding.Mesh``.  Because every stencil access in this framework is a
``jnp.roll`` / shifted gather on the dense grid, the XLA SPMD partitioner
lowers the one-cell (iso-4) / up-to-three-cell (iso-10) halo reads of a
sharded axis into ``collective-permute`` boundary exchanges automatically —
the "annotate shardings, let XLA insert collectives" recipe.  The same step
function runs unmodified on one device (mesh 1x1) or several.  The GPUs of
one host are joined all to all by NVLink, so no mesh axis order is cheaper
than another.

Sharding layout: fields are (..., ny, nx); we shard the trailing spatial
axes.  By default only x is sharded ("x" mesh axis) so the row-wise
boundary conditions (inlet/outlet rows are full x-lines) stay local; a 2D
("y", "x") mesh is supported as well.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "domain_sharding", "shard_domain", "replicated"]


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
              devices=None) -> Mesh:
    """Build a ("y", "x") mesh.  With `n_devices` (or by default all
    devices), makes a 1 x N mesh (x-only decomposition)."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        n = n_devices if n_devices is not None else len(devices)
        shape = (1, n)
    n = shape[0] * shape[1]
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, axis_names=("y", "x"))


def domain_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for an ndim array whose trailing two axes are (ny, nx)."""
    spec = (None,) * (ndim - 2) + ("y", "x")
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_domain(tree, mesh: Mesh):
    """Place every array of a state pytree with the domain sharding (scalars
    and 1D arrays are replicated)."""
    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 2:
            return jax.device_put(x, domain_sharding(mesh, x.ndim))
        return jax.device_put(x, replicated(mesh))
    return jax.tree_util.tree_map(place, tree)
