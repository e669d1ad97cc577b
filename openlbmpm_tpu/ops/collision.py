"""Collision operators: BGK/SRT, TRT, MRT (moment space).

MRT runs as a per-site Q x Q matrix product batched over the grid.
Moment-space relaxation matches the reference's M^-1 S M applications
(``ShanChenD2Q9.py:484-498``, ``AcceleratedRKGPU2D.py:1986-2017``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice
from . import common

__all__ = ["bgk", "bgk_field_tau", "mrt", "mrt_variable_nu", "trt",
           "mrt_relaxation_d2q9_sc", "mrt_relaxation_d2q9_rk"]


def bgk(f, feq, tau: float):
    """f - (f - feq)/tau  (``OptimizedD2Q9GPU.calCollisionSRTGPU:434-445``)."""
    return f - (f - feq) / tau


def bgk_field_tau(f, feq, tau_field):
    """BGK with a per-node relaxation time (color-gradient tau(phi))."""
    return f - (f - feq) / tau_field[None]


def _moments(M: np.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """(Q, *spatial) -> (Q, *spatial) moment transform."""
    Mj = jnp.asarray(M, dtype=x.dtype)
    q = x.shape[0]
    flat = x.reshape(q, -1)
    return jnp.matmul(Mj, flat, precision=common.CONTRACTION_PRECISION
                      ).reshape(x.shape)


def mrt(f, feq, lat: Lattice, s: np.ndarray):
    """f - M^-1 diag(s) M (f - feq) with a constant relaxation vector s."""
    C = lat.M_inv @ (np.diag(np.asarray(s, np.float64)) @ lat.M)
    return f - _moments(C, f - feq)


def mrt_variable_nu(f, feq, lat: Lattice, s_base: np.ndarray,
                    inv_tau_field, nu_indices: tuple[int, ...] = (7, 8)):
    """MRT with the shear-moment rates set per-node to 1/tau(x).

    Used by the color-gradient MRT collision where s_7 = s_8 = 1/tau(phi)
    varies with the local phase field
    (``AcceleratedRKGPU2D.calRKCollision1TotalGPU2DMRTM:1982``).
    """
    df = f - feq
    m = _moments(lat.M, df)
    s = np.asarray(s_base, np.float64).copy()
    s[list(nu_indices)] = 0.0
    sm = jnp.asarray(s, f.dtype).reshape((-1,) + (1,) * (f.ndim - 1)) * m
    nu_sel = np.zeros(lat.q, np.float64)
    nu_sel[list(nu_indices)] = 1.0
    nu_sel = jnp.asarray(nu_sel, f.dtype).reshape((-1,) + (1,) * (f.ndim - 1))
    sm = sm + nu_sel * inv_tau_field[None] * m
    return f - _moments(lat.M_inv, sm)


def trt(f, feq, lat: Lattice, tau: float, magic: float = 3.0 / 16.0):
    """Two-relaxation-time collision.

    The reference stubs TRT (``OptimizedD2Q9GPU.collisionTRTProcess:1638-1659``
    computes against zeroed equilibria and is never launched); we implement
    the standard symmetric/antisymmetric split with the magic parameter
    Lambda = (tau_+ - 1/2)(tau_- - 1/2).
    """
    omega_p = 1.0 / tau
    tau_m = magic / (tau - 0.5) + 0.5
    omega_m = 1.0 / tau_m
    f_opp = f[np.asarray(lat.opp)]
    feq_opp = feq[np.asarray(lat.opp)]
    f_sym = 0.5 * (f + f_opp)
    f_asym = 0.5 * (f - f_opp)
    feq_sym = 0.5 * (feq + feq_opp)
    feq_asym = 0.5 * (feq - feq_opp)
    return f - omega_p * (f_sym - feq_sym) - omega_m * (f_asym - feq_asym)


def mrt_force_transform(src, lat: Lattice, s: np.ndarray):
    """Apply the MRT Guo-force correction M^-1 (I - S/2) M to a source term.

    With per-moment relaxation rates, the discrete-lattice force correction
    is (1 - s_i/2) per moment, not the scalar (1 - 1/(2 tau)).
    """
    C = lat.M_inv @ ((np.eye(lat.q) - 0.5 * np.diag(np.asarray(s, np.float64)))
                     @ lat.M)
    return _moments(C, src)


def mrt_force_transform_variable(src, lat: Lattice, s_base: np.ndarray,
                                 inv_tau_field,
                                 nu_indices: tuple[int, ...] = (7, 8)):
    """M^-1 (I - S/2) M src with per-node shear rates s_nu = 1/tau(x)."""
    m = _moments(lat.M, src)
    s = np.asarray(s_base, np.float64).copy()
    s[list(nu_indices)] = 0.0
    sm = jnp.asarray(s, src.dtype).reshape((-1,) + (1,) * (src.ndim - 1)) * m
    nu_sel = np.zeros(lat.q, np.float64)
    nu_sel[list(nu_indices)] = 1.0
    nu_sel = jnp.asarray(nu_sel, src.dtype).reshape(
        (-1,) + (1,) * (src.ndim - 1))
    sm = sm + nu_sel * inv_tau_field[None] * m
    return src - 0.5 * _moments(lat.M_inv, sm)


def trt_force_transform(src, lat: Lattice, tau: float,
                        magic: float = 3.0 / 16.0):
    """TRT force correction: even part scaled by (1 - omega_+/2), odd part by
    (1 - omega_-/2)."""
    omega_p = 1.0 / tau
    tau_m = magic / (tau - 0.5) + 0.5
    omega_m = 1.0 / tau_m
    src_opp = src[np.asarray(lat.opp)]
    even = 0.5 * (src + src_opp)
    odd = 0.5 * (src - src_opp)
    return (1.0 - 0.5 * omega_p) * even + (1.0 - 0.5 * omega_m) * odd


def mrt_relaxation_d2q9_sc(tau: float) -> np.ndarray:
    """EFS/SC MRT diagonal: conserved moments 0, shear 1/tau.

    s_1 = 0.6, s_2 = 1.5, s_4 = s_6 = 1.2, s_7 = s_8 = 1/tau
    (``ShanChenD2Q9.py:100-106,484-498``).
    """
    s = np.zeros(9, np.float64)
    s[1] = 0.6
    s[2] = 1.5
    s[4] = s[6] = 1.2
    s[7] = s[8] = 1.0 / tau
    return s


def mrt_relaxation_d2q9_rk(tau: float | None = None) -> np.ndarray:
    """RK color-gradient MRT vector: s1=1.64, s2=1.54, s4=s6=1.9
    (``RKD2Q9.py:338-340``); shear rates filled with 1/tau when given."""
    s = np.zeros(9, np.float64)
    s[1] = 1.64
    s[2] = 1.54
    s[4] = s[6] = 1.9
    if tau is not None:
        s[7] = s[8] = 1.0 / tau
    return s
