"""openlbmpm_tpu: a multicomponent/multiphase lattice Boltzmann framework
for flow and solute transport in porous media.

A from-scratch JAX/XLA rebuild with the capabilities of
PorousMediaSimulation/openLBMPM:
Shan-Chen pseudopotential MCMP (original + explicit-forcing high-isotropy),
Rothman-Keller color-gradient (Perturbation and CSF variants), and
phase-confined reactive solute transport, with SRT/TRT/MRT collisions,
Zou-He/convective/periodic boundaries, pore-image geometry, HDF5/PNG output,
checkpoint/resume with drainage-imbibition cycles, and multi-device domain
decomposition over a ``jax.sharding.Mesh``.
"""

from . import lattice, geometry
from .lattice import D2Q9, D2Q5, D3Q19, D3Q7

__version__ = "0.1.0"
