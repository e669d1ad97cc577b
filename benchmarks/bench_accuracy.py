"""Accuracy companion to bench.py: what f32 costs in physics against f64,
for the flagship CSF MRT configuration.

Two measurements, in one process (BASELINE.json's metric is "MLUPS/chip at
fixed steps-to-breakthrough ... matching reference physics to 1e-6
relative density error"):

1. ``--part density``: the flagship configuration (n^2 D2Q9 CSF MRT,
   Neumann inlet / Dirichlet outlet; 1024^2 and 600 steps by default)
   advanced by the same jnp step in f32 on the default device and in f64
   on the CPU backend, reporting max/percentile relative total-density
   error of f32 against f64.

2. ``--part breakthrough``: a reduced drainage variant (128^2 pore-throat
   image, same BC family, v_in = -2e-3) run to breakthrough in f32 on the
   default device and in f64 on the CPU backend, reporting the
   steps-to-breakthrough of each.  Breakthrough = invading phase reaching
   the outlet band (metrics.flow_diagnostics; reference semantics:
   IniFiles/RKtwophasesetup2D.ini drainage with fixed outlet densities).

Usage:  python benchmarks/bench_accuracy.py [--part density|breakthrough|all]
Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bench_model(dtype, n):
    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    params = ColorGradientParams(
        tau_r=1.0, tau_b=1.0, surface_tension=0.1, contact_angle_deg=60.0,
        beta=0.7, delta=0.98, tau_type=2, wetting_type=2, variant="CSF",
        collision="MRT")
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    return ColorGradientRK(geo.from_solid_mask(solid), params, bcs,
                           dtype=dtype)


def _pore_throat_solid(ny, nx):
    """Deterministic 2D pore-throat image: side walls plus two rows of
    staggered rectangular grains leaving ~nx/8-wide throats (a reduced
    stand-in for the reference's imaged pore spaces)."""
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    gy = ny // 4
    gh = max(2, ny // 16)
    gw = nx // 4
    # row of grains at y ~ ny/2 with throats at x = nx/8, 3nx/8, ...
    for x0 in range(nx // 8, nx - 1, nx // 4):
        solid[2 * gy - gh:2 * gy + gh, x0:x0 + gw // 2] = True
    # staggered row at y ~ ny/4
    for x0 in range(nx // 4, nx - 1, nx // 4):
        solid[gy - gh:gy + gh, x0:x0 + gw // 2] = True
    solid[:, 0] = solid[:, -1] = True
    return solid


def _drainage_model(dtype, n, v_in):
    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    params = ColorGradientParams(
        tau_r=1.0, tau_b=1.0, surface_tension=0.01, contact_angle_deg=60.0,
        beta=0.7, delta=0.98, tau_type=2, wetting_type=2, variant="CSF",
        collision="MRT")
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=v_in, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    return ColorGradientRK(geo.from_solid_mask(_pore_throat_solid(n, n)),
                           params, bcs, dtype=dtype)


def _runner(model):
    """Jitted (k, state) -> state after k steps (k static)."""
    import jax

    def loop(k, s):
        return jax.lax.fori_loop(0, k, lambda _, x: model._step_impl(*x), s)

    return jax.jit(loop, static_argnums=0, donate_argnums=1)


def _err(a, ref):
    rel = np.abs(a - ref) / np.maximum(np.abs(ref), 1e-30)
    rel = rel[np.isfinite(rel)]
    return {"max": float(rel.max()),
            "p999": float(np.percentile(rel, 99.9)),
            "p99": float(np.percentile(rel, 99.0)),
            "p50": float(np.percentile(rel, 50.0)),
            "mean": float(rel.mean()),
            "frac_le_1e-6": float((rel <= 1e-6).mean())}


def part_density(n, steps, cpu, device):
    import jax
    import jax.numpy as jnp
    out = {"part": "density", "config": f"flagship {n}^2 CSF MRT",
           "steps": steps, "device": device}
    rho = {}
    for name, dtype, dev in (("f32", jnp.float32, jax.devices()[0]),
                             ("f64", jnp.float64, cpu)):
        with jax.default_device(dev):
            m = _bench_model(dtype, n)
            f_r, f_b = _runner(m)(steps, m.init_state_layers(
                1.0, 1.0, invading_rows=100))
            rho[name] = np.asarray(jnp.sum(f_r + f_b, axis=0), np.float64)
    fl = rho["f64"] > 0
    out["f32_vs_f64_rho"] = _err(rho["f32"][fl], rho["f64"][fl])
    print(json.dumps(out), flush=True)


def _steps_to_breakthrough(model, state, max_steps, check_every):
    import jax.numpy as jnp

    from openlbmpm_tpu.metrics import flow_diagnostics
    run = _runner(model)
    done = 0
    while done < max_steps:
        state = run(check_every, state)
        done += check_every
        rho_r = jnp.sum(state[0], axis=0)
        rho_b = jnp.sum(state[1], axis=0)
        zero = jnp.zeros_like(rho_r)
        met = flow_diagnostics(rho_r, rho_b, zero, zero, model.geo.is_fluid,
                               breakthrough_row=3)
        if met["breakthrough"]:
            return done
    return -1


def part_breakthrough(n, cpu, device, check_every=200):
    """Steps-to-breakthrough of f32 and f64 on the reduced drainage
    variant; paths agreeing at ``check_every`` resolution are equal."""
    import jax
    import jax.numpy as jnp
    v_in = -2e-3
    out = {"part": "breakthrough",
           "config": f"{n}x{n} pore-throat drainage, v_in={v_in}",
           "check_every": check_every, "device": device}
    for name, dtype, dev in (("f32", jnp.float32, jax.devices()[0]),
                             ("f64", jnp.float64, cpu)):
        with jax.default_device(dev):
            m = _drainage_model(dtype, n, v_in)
            st = m.init_state_layers(1.0, 1.0, invading_rows=n // 8)
            out[name] = _steps_to_breakthrough(m, st, 200_000, check_every)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=["density", "breakthrough", "all"],
                    default="all")
    ap.add_argument("--n", type=int, default=1024,
                    help="lattice side of the density part")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n-breakthrough", type=int, default=128)
    args = ap.parse_args()
    import jax

    from openlbmpm_tpu.backend import device_summary, require_gpu
    device = device_summary(require_gpu())
    jax.config.update("jax_enable_x64", True)   # the f64 reference
    cpu = jax.devices("cpu")[0]
    if args.part in ("density", "all"):
        part_density(args.n, args.steps, cpu, device)
    if args.part in ("breakthrough", "all"):
        part_breakthrough(args.n_breakthrough, cpu, device)


if __name__ == "__main__":
    main()
