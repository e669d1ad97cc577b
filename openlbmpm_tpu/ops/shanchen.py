"""Shan-Chen pseudopotential MCMP ops: psi EOS, interaction forces, adhesion.

Dense masked-grid reformulation of the reference's sparse gather kernels:
  - psi = rho            (``OptimizedD2Q9GPU.calFluidPotentialGPUEql:99-105``)
  - psi via P-R EOS      (``calFluidPotentialGPUPR:112-127``, Yuan & Schaefer)
  - original SC force    (``calInteractionForce:186-313`` and the fused
                          ``interactionCollisionProcess:1274-1446``)
  - explicit-forcing-scheme (EFS) gradient force with iso-4/8/10 stencils
                         (``ExplicitD2Q9GPU.calExplicit{4,8,10}thOrderScheme``)

With psi set to zero on solid voxels, the fluid-fluid sums over "existing
neighbors" reduce to plain weighted rolled sums; the solid-adhesion
contribution becomes a per-geometry constant vector field (the "adhesion
stencil") multiplied by G_s psi_k(x).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..lattice import D2Q9, IsoStencil, ISO_STENCILS
from . import common
from .common import shift

__all__ = ["psi_identity", "psi_peng_robinson", "InteractionFields",
           "build_interaction_fields", "stencil_weighted_grad",
           "interaction_force_sc", "interaction_force_efs"]


def psi_identity(rho):
    return rho


def psi_peng_robinson(rho, const_r=1.0, temperature=0.06, coeff_a=1.0,
                      coeff_b=4.0, alpha=1.0, c0=6.0, g=-1.0):
    """psi = sqrt(2 (P_PR - rho/3) / (c0 g)) (``calFluidPotentialGPUPR``)."""
    p = (rho * const_r * temperature) / (1.0 - coeff_b * rho) - \
        (coeff_a * alpha * rho * rho) / \
        (1.0 + 2.0 * coeff_b * rho - coeff_b * coeff_b * rho * rho)
    arg = 2.0 / (c0 * g) * (p - rho / 3.0)
    return jnp.sqrt(jnp.maximum(arg, 0.0))


@dataclasses.dataclass(frozen=True)
class InteractionFields:
    """Per-geometry constants for the interaction force.

    adhesion: (2, ny, nx) float, sum_dir w_dir * e_dir * [solid at x+e] with
      the *base D2Q9 weights* (original SC solid term uses 1/9 and 1/36,
      ``OptimizedD2Q9GPU.py:209-312``).
    adhesion_st: same but with the interaction-stencil weights (EFS solid
      term uses the stencil weight, ``ExplicitD2Q9GPU.py:71-206``).
    fluid_vec: (2, ny, nx) float, sum_dir w_dir * e_dir * [fluid at x+e]
      over the interaction stencil (needed by the EFS difference form).
    """

    stencil: IsoStencil
    adhesion: np.ndarray
    adhesion_st: np.ndarray
    fluid_vec: np.ndarray


def _vec_stencil_sum(mask: np.ndarray, offsets, weights) -> np.ndarray:
    out = np.zeros((2,) + mask.shape, dtype=np.float64)
    m = mask.astype(np.float64)
    for (dx, dy), w in zip(offsets, weights):
        s = np.roll(np.roll(m, -int(dy), axis=0), -int(dx), axis=1)
        out[0] += w * dx * s
        out[1] += w * dy * s
    return out


def build_interaction_fields(is_solid: np.ndarray,
                             order: int = 4) -> InteractionFields:
    st = ISO_STENCILS[order]
    is_solid = np.asarray(is_solid, bool)
    # Base D2Q9 nearest-neighbor weights for the original SC solid term.
    d2q9_off = D2Q9.e[1:]
    d2q9_w = D2Q9.w[1:]
    adhesion = _vec_stencil_sum(is_solid, d2q9_off, d2q9_w)
    adhesion_st = _vec_stencil_sum(is_solid, st.offsets, st.weights)
    fluid_vec = _vec_stencil_sum(~is_solid, st.offsets, st.weights)
    return InteractionFields(stencil=st, adhesion=adhesion,
                             adhesion_st=adhesion_st, fluid_vec=fluid_vec)


def stencil_weighted_grad(field: jnp.ndarray, st: IsoStencil):
    """(sum_dir w e_x field(x+e), sum_dir w e_y field(x+e)) via rolled gathers.

    `field` must be zero on solid voxels so solid neighbors drop out.
    Accepts leading batch axes: (..., ny, nx).
    """
    gx = jnp.zeros_like(field)
    gy = jnp.zeros_like(field)
    for (dx, dy), w in zip(st.offsets, st.weights):
        s = shift(field, int(dx), int(dy))
        # float(w): np.float64 scalars are strongly typed and would promote
        # f32 fields to f64 under jax_enable_x64
        if dx:
            gx = gx + (float(w) * float(dx)) * s
        if dy:
            gy = gy + (float(w) * float(dy)) * s
    return gx, gy


def interaction_force_sc(psi_k: jnp.ndarray, g_matrix: np.ndarray,
                         g_solid: np.ndarray, fields: InteractionFields):
    """Original Shan-Chen interaction force (nearest-neighbor stencil).

    F_k = -psi_k(x) sum_j G_kj sum_dir w_dir psi_j(x+e) e
          - G_ks psi_k(x) * adhesion(x)

    Args:
      psi_k: (K, ny, nx), zero on solid voxels.
    Returns: (fx, fy) each (K, ny, nx).
    """
    dtype = psi_k.dtype
    # nearest-neighbor weighted gradient of each psi_j with D2Q9 weights
    st4 = ISO_STENCILS[4]
    # Original SC uses the D2Q9 weights (1/9, 1/36), not the iso-4 (1/3, 1/12)
    d2q9_st = IsoStencil(order=0, offsets=D2Q9.e[1:], weights=D2Q9.w[1:])
    del st4
    vx, vy = stencil_weighted_grad(psi_k, d2q9_st)  # (K, ny, nx)
    g = jnp.asarray(np.asarray(g_matrix, np.float64), dtype)
    prec = common.CONTRACTION_PRECISION
    gvx = jnp.einsum("kj,jyx->kyx", g, vx, precision=prec)
    gvy = jnp.einsum("kj,jyx->kyx", g, vy, precision=prec)
    gs = jnp.asarray(np.asarray(g_solid, np.float64), dtype).reshape(-1, 1, 1)
    adh = jnp.asarray(fields.adhesion, dtype)
    fx = -psi_k * (gvx + gs * adh[0])
    fy = -psi_k * (gvy + gs * adh[1])
    return fx, fy


def interaction_force_efs(psi_k: jnp.ndarray, g_matrix: np.ndarray,
                          g_solid: np.ndarray, fields: InteractionFields):
    """Explicit-forcing-scheme force (Porter et al. 2012, iso-4/8/10).

    F_k = -6 psi_k(x) sum_j G_kj sum_dir(fluid) w (psi_j(x+e) - psi_j(x)) e
          - G_ks psi_k(x) * adhesion_st(x)
    """
    dtype = psi_k.dtype
    st = fields.stencil
    vx, vy = stencil_weighted_grad(psi_k, st)
    fvec = jnp.asarray(fields.fluid_vec, dtype)
    # difference form over fluid neighbors: sum w (psi(x+e) - psi(x)) e
    dvx = vx - psi_k * fvec[0]
    dvy = vy - psi_k * fvec[1]
    g = jnp.asarray(np.asarray(g_matrix, np.float64), dtype)
    prec = common.CONTRACTION_PRECISION
    gvx = jnp.einsum("kj,jyx->kyx", g, dvx, precision=prec)
    gvy = jnp.einsum("kj,jyx->kyx", g, dvy, precision=prec)
    gs = jnp.asarray(np.asarray(g_solid, np.float64), dtype).reshape(-1, 1, 1)
    adh = jnp.asarray(fields.adhesion_st, dtype)
    fx = -6.0 * psi_k * gvx - gs * psi_k * adh[0]
    fy = -6.0 * psi_k * gvy - gs * psi_k * adh[1]
    return fx, fy
