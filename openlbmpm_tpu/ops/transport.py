"""Solute-transport ops: D2Q5/D2Q9 tracer lattices confined to one fluid
phase, with semi-permeable or bounce-back interfaces and bilinear reaction.

Dense reformulations of ``RKCG2D/AccelerateTransport2DRK.py``:
  - J-scheme/linear/quadratic equilibria (see ``ops.equilibrium``)
  - anisotropic-diffusion MRT relaxation matrices
    (``Transport2DRK.py:316-391``)
  - semi-permeable interface with partition coefficient beta
    (``calTransportWithInterfaceD2Q5:976-1011``, ``...D2Q9:1019-1045``)
  - hard interface bounce-back returning escaped populations
    (``calTransportInterfaceGPU:310-381``, Q9 ``:839-923``)
  - transport-domain masks from the red density
    (``calUpdateDistributionGPU:197-207``, ``calValueTransportDomain:956-968``)
  - bilinear reaction A + B -> C (``calReactionTracersGPU:95-109``)
  - boundary conditions: Inamuro constant-concentration inlet
    (``calInamuroConstConcBoundary:682-696``), anti-bounce-back
    (``calAntiCollisionConcBoundary:661-675``), zero-concentration
    (``calZeroConcenBoundary:480-496``), free-flow outlet
    (``calFreeConcBoundary1/2/3:419-476``)
  - concentration renormalization on interface motion
    (``calUpdateConcInTransportDomainByV:500-527``)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..lattice import D2Q5, D2Q9, Lattice
from . import common
from .common import bcast_1d, shift

__all__ = [
    "j_coefficients", "mrt_matrices_d2q5", "mrt_matrices_d2q9",
    "transport_domain_mask", "interface_partition", "interface_bounce_back",
    "bilinear_reaction", "inamuro_inlet", "anti_bounce_back_inlet",
    "zero_concentration_inlet", "free_flow_outlet",
    "redistribute_on_interface_motion", "renormalize_concentration",
]

_EPS = 1.0e-8


def j_coefficients(j0: np.ndarray) -> np.ndarray:
    """(T, 5) J-scheme coefficients: J_0 = j0, J_i = (1 - j0)/4
    (``Transport2DRK.py:404-410``).  Diffusion D = (1 - J0)(tau - 1/2)/2."""
    j0 = np.atleast_1d(np.asarray(j0, np.float64))
    out = np.empty((j0.size, 5))
    out[:, 0] = j0
    out[:, 1:] = ((1.0 - j0) / 4.0)[:, None]
    return out


def mrt_matrices_d2q5(diff_x, diff_y, diff_xy, diff_yx) -> np.ndarray:
    """(T, 5, 5) transport MRT update matrices -M^-1 S^-1 M.

    The relaxation-time matrix S has tau_D = 1/2 + 3 D on the flux moments
    with off-diagonal coupling for anisotropic tensors
    (``Transport2DRK.py:330-347``); the collision applied is
    f += (-M^-1 S^-1 M)(f - feq).
    """
    diff_x, diff_y, diff_xy, diff_yx = map(
        lambda a: np.atleast_1d(np.asarray(a, np.float64)),
        (diff_x, diff_y, diff_xy, diff_yx))
    t = diff_x.size
    out = np.empty((t, 5, 5))
    for i in range(t):
        S = np.eye(5)
        S[1, 1] = 0.5 + 3.0 * diff_x[i]
        S[2, 2] = 0.5 + 3.0 * diff_y[i]
        S[1, 2] = 3.0 * diff_xy[i]
        S[2, 1] = 3.0 * diff_yx[i]
        out[i] = -(D2Q5.M_inv @ np.linalg.inv(S) @ D2Q5.M)
    return out


def mrt_matrices_d2q9(diff_x, diff_y, diff_xy, diff_yx) -> np.ndarray:
    """(T, 9, 9) transport MRT update matrices for the D2Q9 scheme
    (``Transport2DRK.py:373-391``)."""
    diff_x, diff_y, diff_xy, diff_yx = map(
        lambda a: np.atleast_1d(np.asarray(a, np.float64)),
        (diff_x, diff_y, diff_xy, diff_yx))
    t = diff_x.size
    out = np.empty((t, 9, 9))
    for i in range(t):
        S = np.eye(9)
        S[3, 3] = S[4, 4] = 0.5 + 3.0 * diff_x[i]
        S[5, 5] = S[6, 6] = 0.5 + 3.0 * diff_y[i]
        S[3, 5] = 3.0 * diff_xy[i]
        S[5, 3] = 3.0 * diff_yx[i]
        out[i] = -(D2Q9.M_inv @ np.linalg.inv(S) @ D2Q9.M)
    return out


def mrt_collide(g, geq, update_matrices: np.ndarray):
    """g += U (g - geq) per tracer with U = -M^-1 S^-1 M.

    g: (T, Q, ny, nx); update_matrices: (T, Q, Q).
    """
    u = jnp.asarray(update_matrices, g.dtype)
    df = g - geq
    t, q = df.shape[0], df.shape[1]
    flat = df.reshape(t, q, -1)
    upd = jnp.einsum("tab,tbn->tan", u, flat,
                     precision=common.CONTRACTION_PRECISION).reshape(df.shape)
    return g + upd


def transport_domain_mask(rho_r, criteria: float = 0.5):
    """(in_domain bool, value field): tracers live where rho_R < criteria;
    value = -1 inside the transport domain, 0 outside
    (``calValueTransportDomain:956-968``)."""
    inside = rho_r < criteria
    value = jnp.where(inside, -1.0, 0.0).astype(rho_r.dtype)
    return inside, value


def _unit_inward_gradient(gx, gy):
    norm = jnp.sqrt(gx * gx + gy * gy)
    safe = norm > _EPS
    n = jnp.where(safe, norm, 1.0)
    return jnp.where(safe, -gx / n, 0.0), jnp.where(safe, -gy / n, 0.0), safe


def interface_partition(g, conc, gx, gy, value_domain, beta, lat: Lattice):
    """Semi-permeable interface: g_i += beta_t * value * w_i C * cos(theta_i)
    with cos(theta_i) against the inward color-gradient direction
    (``calTransportWithInterfaceD2Q5:976-1011``)."""
    dtype = g.dtype
    ux, uy, safe = _unit_inward_gradient(gx, gy)
    e_norm = lat.e_norm.copy()
    e_norm[e_norm == 0] = 1.0
    ex = bcast_1d(lat.e[:, 0], 2, dtype)   # (Q, 1, 1)
    ey = bcast_1d(lat.e[:, 1], 2, dtype)
    en = bcast_1d(e_norm, 2, dtype)
    cos_t = (ex * ux[None] + ey * uy[None]) / en          # (Q, ny, nx)
    cos_t = jnp.where(safe[None], cos_t, 0.0)
    moving = np.ones(lat.q)
    moving[0] = 0.0                                        # rest direction
    cos_t = cos_t * bcast_1d(moving, 2, dtype)
    w = bcast_1d(lat.w, 2, dtype)
    beta_b = jnp.asarray(np.atleast_1d(np.asarray(beta, np.float64)),
                         dtype).reshape(-1, 1, 1, 1)
    return g + beta_b * value_domain[None, None] * \
        (w * cos_t)[None] * conc[:, None]


def interface_bounce_back(g, in_domain, lat: Lattice):
    """Hard interface: post-streaming, populations that leaked from a
    transport-domain node x into an outside neighbor y = x + e_i are pulled
    back into the opposite slot at x and zeroed at y
    (``calTransportInterfaceGPU:310-381``).

    g: (T, Q, ny, nx); in_domain: (ny, nx) bool.
    """
    dom = in_domain
    out = g
    for i in range(1, lat.q):
        dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
        opp = int(lat.opp[i])
        nbr_out = jnp.logical_and(dom, ~shift(dom, dx, dy))
        leaked_at_x = shift(g[:, i], dx, dy)  # value of g_i at y = x + e_i
        cur = out[:, opp]
        out = out.at[:, opp].set(jnp.where(nbr_out[None], leaked_at_x, cur))
        # zero g_i at outside nodes that received from an inside node
        recv_from_inside = jnp.logical_and(
            ~dom, jnp.roll(jnp.roll(dom, dy, axis=0), dx, axis=1))
        out = out.at[:, i].set(
            jnp.where(recv_from_inside[None], 0.0, out[:, i]))
    return out


def bilinear_reaction(g, conc, rate: float, j_coeffs: np.ndarray,
                      stoich: np.ndarray):
    """A + B -> C source: S_t = stoich_t * k C_0 C_1, distributed with the
    J weights (``calReactionTracersGPU:95-109``)."""
    dtype = g.dtype
    r = rate * conc[0] * conc[1]
    st = jnp.asarray(np.asarray(stoich, np.float64), dtype).reshape(-1, 1, 1)
    src = st * r[None]  # (T, ny, nx)
    j = jnp.asarray(j_coeffs, dtype)[:, :, None, None]  # (T, Q, 1, 1)
    return g + j * src[:, None]


def inamuro_inlet(g, conc_target, row, mask):
    """Constant-concentration inlet: the unknown population (index 4 on the
    D2Q5 lattice, pointing -y) absorbs the deficit
    (``calInamuroConstConcBoundary:682-696``)."""
    known = g[:, 0, row, :] + g[:, 1, row, :] + g[:, 2, row, :] + \
        g[:, 3, row, :]
    target = jnp.asarray(conc_target, g.dtype).reshape(-1, 1)
    new4 = target - known
    cur = g[:, 4, row, :]
    return g.at[:, 4, row, :].set(jnp.where(mask, new4, cur))


def anti_bounce_back_inlet(g, conc_target, row, mask, w3: float = 1.0 / 6.0):
    """Anti-bounce-back constant concentration: the row above gets
    g_4 = -g_3(row) + 2 w_3 C (``calAntiCollisionConcBoundary:661-675``)."""
    target = jnp.asarray(conc_target, g.dtype).reshape(-1, 1)
    new = -g[:, 3, row, :] + 2.0 * w3 * target
    cur = g[:, 4, row + 1, :]
    return g.at[:, 4, row + 1, :].set(jnp.where(mask, new, cur))


def zero_concentration_inlet(g, row, mask):
    """Copy the full PDF set from the row below (``calZeroConcenBoundary``)."""
    src = g[:, :, row - 1, :]
    cur = g[:, :, row, :]
    return g.at[:, :, row, :].set(jnp.where(mask, src, cur))


def free_flow_outlet(g, rows, mask_rows):
    """Free-flow outlet: rows copy the full PDF set from the row above
    (``calFreeConcBoundary1/2/3:419-476``)."""
    for row, m in zip(rows, mask_rows):
        src = g[:, :, row + 1, :]
        cur = g[:, :, row, :]
        g = g.at[:, :, row, :].set(jnp.where(m, src, cur))
    return g


def redistribute_on_interface_motion(g, in_domain_new, in_domain_old,
                                     j_coeffs: np.ndarray, lat: Lattice):
    """Concentration repair when the phase interface moves
    (``calUpdateConcOnNewNodesGPU:216-239``, ``calUpdateConcOnOldNodesGPU:
    245-257``, ``calUpdatedPDFWithNewRho:389-414`` semantics, mask-based):

    - nodes that LEFT the transport domain hand their concentration to
      adjacent in-domain nodes (equal split over the available neighbors);
    - nodes that ENTERED the domain are initialized from the average
      concentration of their old-domain neighbors, with the borrowed mass
      deducted from those donors (the reference repairs the imbalance with
      a separate renormalization pass; here the exchange itself conserves).

    Total tracer mass is conserved exactly as long as every exited node has
    at least one in-domain neighbor and every entered node a donor.

    Args:
      g: (T, Q, ny, nx) tracer PDFs; in_domain_new/old: (ny, nx) bool.
    Returns the repaired g.
    """
    dtype = g.dtype
    conc = jnp.sum(g, axis=1)
    exited = jnp.logical_and(in_domain_old, ~in_domain_new)
    entered = jnp.logical_and(in_domain_new, ~in_domain_old)
    dom_new_f = in_domain_new.astype(dtype)
    dom_old_f = in_domain_old.astype(dtype)

    # exits: equal split over new-domain neighbors
    nbr_new = jnp.zeros_like(dom_new_f)
    for i in range(1, lat.q):
        dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
        nbr_new = nbr_new + shift(dom_new_f, dx, dy)
    share = jnp.where(jnp.logical_and(exited, nbr_new > 0),
                      conc / jnp.where(nbr_new > 0, nbr_new, 1.0), 0.0)
    received = jnp.zeros_like(conc)
    for i in range(1, lat.q):
        dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
        received = received + shift(share, dx, dy)
    received = received * dom_new_f

    # entries: borrow the average donor concentration, deduct from donors
    # (donors = nodes staying in the domain; exited nodes already gave
    # everything away above)
    remain_f = dom_old_f * dom_new_f
    nbr_old = jnp.zeros_like(dom_old_f)
    donor_sum = jnp.zeros_like(conc)
    for i in range(1, lat.q):
        dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
        nbr_old = nbr_old + shift(remain_f, dx, dy)
        donor_sum = donor_sum + shift(conc * remain_f, dx, dy)
    n_don = jnp.where(nbr_old > 0, nbr_old, 1.0)
    borrowed = jnp.where(jnp.logical_and(entered, nbr_old > 0)[None],
                         donor_sum / n_don, 0.0)
    per_donor = borrowed / n_don
    deduction = jnp.zeros_like(conc)
    for i in range(1, lat.q):
        dx, dy = int(lat.e[i, 0]), int(lat.e[i, 1])
        deduction = deduction + shift(per_donor, -dx, -dy)
    deduction = deduction * remain_f

    conc_new = jnp.where(in_domain_new[None],
                         conc + received + borrowed - deduction, 0.0)
    j = jnp.asarray(j_coeffs, dtype)[:, :, None, None]
    geq = conc_new[:, None] * j
    out = jnp.where(exited[None, None], 0.0, g)
    out = jnp.where(entered[None, None], geq, out)
    delta = (received + borrowed - deduction)[:, None] * j
    interior = jnp.logical_and(in_domain_new, ~entered)
    out = jnp.where(interior[None, None], out + delta, out)
    return out


def renormalize_concentration(g, conc, mass0, in_domain, u_norm_sq,
                              j_or_w: np.ndarray, u, lat: Lattice,
                              quadratic: bool = False):
    """Mass-conservation repair on interface motion: rescale C so the total
    tracer mass in the (moving) transport domain stays at `mass0`, and
    rebuild the PDFs from the equilibrium
    (``calUpdateConcInTransportDomainByV:500-527``).

    Only applied where the flow is active (|u| > 1e-10), like the reference.
    Returns (g, conc).
    """
    dtype = g.dtype
    total = jnp.sum(conc * in_domain[None], axis=(-2, -1))
    total = jnp.where(total != 0, total, 1.0)
    extra = conc * (mass0 / total).reshape(-1, 1, 1)
    active = jnp.logical_and(in_domain, u_norm_sq > 1e-20)
    conc_new = jnp.where(active[None], conc + extra, conc)
    w = bcast_1d(lat.w, 2, dtype)                       # (Q, 1, 1)
    eu = (bcast_1d(lat.e[:, 0], 2, dtype) * u[0][None] +
          bcast_1d(lat.e[:, 1], 2, dtype) * u[1][None])  # (Q, ny, nx)
    eq_factor = w * (1.0 + 3.0 * eu)
    if quadratic:
        uu = (u[0] * u[0] + u[1] * u[1])[None]
        eq_factor = w * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * uu)
    geq = conc_new[:, None] * eq_factor[None]            # (T, Q, ny, nx)
    g_new = jnp.where(active[None, None], geq, g)
    return g_new, conc_new
