"""Generate the relative-permeability showcase figure
(docs/relperm_layered.png).

Layered two-phase Poiseuille flow is the standard quantitative
relative-permeability benchmark for two-phase LBM (the flow regime the
reference's MCMP models target but never validate): a non-wetting core
of half-width a flows between wetting films against the channel walls,
driven by a uniform body force.  The shear stress is -G x independent of
the fluid layout, so the fluxes have closed forms; with s = a/h (the
non-wetting saturation) and M = nu_n / nu_w:

    kr_w(s) = (2 - 3 s + s^3) / 2
    kr_n(s) = (3/2) M s (1 - s^2) + s^3

The CSF color-gradient model is run to steady state at several
saturations and the phase fluxes are compared against these curves.

Run on CPU (f64):  python docs/make_relperm_figure.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from openlbmpm_tpu import geometry as geo  # noqa: E402
from openlbmpm_tpu.models.base import run_chunked  # noqa: E402
from openlbmpm_tpu.models.colorgradient import (  # noqa: E402
    CGBoundaryConfig, ColorGradientParams, ColorGradientRK)


def kr_analytic(s: float, m_visc: float):
    kr_w = (2.0 - 3.0 * s + s ** 3) / 2.0
    kr_n = 1.5 * m_visc * s * (1.0 - s * s) + s ** 3
    return kr_w, kr_n


def run_point(s_n: float, tau_n: float = 1.1, tau_w: float = 0.7,
              nx: int = 66, ny: int = 8, g: float = 1.0e-7,
              num_steps: int = 40000):
    """Steady layered Poiseuille at non-wetting saturation ``s_n``;
    returns (measured saturation, measured kr_w, kr_n, analytic kr_w,
    kr_n).  The analytic curves are evaluated at the *measured*
    saturation (the phi > 0 column fraction) so the diffuse-interface
    width does not masquerade as a permeability error; convergence needs
    ~3x the momentum diffusion time h^2/nu."""
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    width = nx - 2
    half = width / 2.0
    a = s_n * half
    xc = (nx - 1) / 2.0
    xx = np.arange(nx)[None, :] + np.zeros((ny, 1))
    core = np.abs(xx - xc) <= a

    params = ColorGradientParams(
        variant="CSF", collision="MRT", tau_r=tau_n, tau_b=tau_w,
        surface_tension=1.0e-4, contact_angle_deg=90.0, tau_type=2,
        wetting_type=2, beta=0.9, body_force=(0.0, g))
    model = ColorGradientRK(geo.from_solid_mask(solid), params,
                            CGBoundaryConfig(), dtype=jnp.float64)
    fl = model.geo.is_fluid
    rho_r = np.where(core & fl, 1.0, 0.0)
    rho_b = np.where(~core & fl, 1.0, 0.0)
    state = model._feq_init(rho_r, rho_b)
    state = run_chunked(model.step, state, num_steps=num_steps,
                        io_interval=num_steps)
    _, _, phi, (ux, uy) = model.macro(state)
    phi = np.asarray(phi)
    uy = np.asarray(uy)
    in_n = (phi > 0) & fl
    in_w = (phi < 0) & fl
    s_meas = float(in_n[0].sum()) / width
    q_n = abs(float(uy[in_n].sum())) / ny
    q_w = abs(float(uy[in_w].sum())) / ny

    # single-phase Poiseuille flux at each fluid's viscosity:
    # Q0 = 2 G h^3 / (3 nu) with h the channel half-width
    def q0(tau):
        nu = (tau - 0.5) / 3.0
        return 2.0 * g * half ** 3 / (3.0 * nu)

    kr_w_m = q_w / q0(tau_w)
    kr_n_m = q_n / q0(tau_n)
    m_visc = (tau_n - 0.5) / (tau_w - 0.5)
    kr_w_a, kr_n_a = kr_analytic(s_meas, m_visc)
    return s_meas, kr_w_m, kr_n_m, kr_w_a, kr_n_a


def main():
    sats = [0.25, 0.45, 0.65, 0.85]
    rows = []
    for s in sats:
        sm, kw, kn, kwa, kna = run_point(s)
        rows.append((sm, kw, kn, kwa, kna))
        print(f"S_n={sm:.3f}: kr_w {kw:.4f} (analytic {kwa:.4f}), "
              f"kr_n {kn:.4f} (analytic {kna:.4f})", flush=True)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4.2))
    ss = np.linspace(0, 1, 200)
    m_visc = (1.1 - 0.5) / (0.7 - 0.5)
    ax.plot(ss, [(2 - 3 * s + s ** 3) / 2 for s in ss], "C0-",
            label="kr_w analytic")
    ax.plot(ss, [1.5 * m_visc * s * (1 - s * s) + s ** 3 for s in ss],
            "C1-", label="kr_n analytic")
    arr = np.array(rows)
    ax.plot(arr[:, 0], arr[:, 1], "C0o", label="kr_w LBM")
    ax.plot(arr[:, 0], arr[:, 2], "C1s", label="kr_n LBM")
    ax.set_xlabel("non-wetting saturation $S_n$")
    ax.set_ylabel("relative permeability")
    ax.set_title("Layered two-phase Poiseuille, CSF color-gradient "
                 f"(M = {m_visc:.0f})")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "relperm_layered.png")
    fig.savefig(out, dpi=130)
    print("wrote", out)


if __name__ == "__main__":
    main()
