"""Benchmark harness over the five BASELINE.json configs.

Prints one JSON line per config: {"config", "metric", "value", "unit",
plus a physics sanity scalar}.  The headline single-number benchmark stays
in ``bench.py`` (the driver contract); this harness establishes the full
baseline the reference never published (BASELINE.md).

Run on the GPU:  python benchmarks/bench_all.py [--quick]
(one process; every config runs the model's jnp step)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

# runnable as `python benchmarks/bench_all.py` from the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _throughput(step_fn, state, n_steps, sites, unpack=False):
    import jax

    def loop(k, s):
        def body(_, s):
            out = step_fn(*s) if unpack else step_fn(s)
            if unpack and type(out) is not tuple:  # NamedTuple states stay
                out = (out,)
            return out
        return jax.lax.fori_loop(0, k, body, s)

    run = jax.jit(loop, static_argnums=0, donate_argnums=1)
    state = run(n_steps, state)    # compiles outside the timed windows
    jax.block_until_ready(state)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = run(n_steps, state)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
    # median of the timed windows
    return sites * n_steps / statistics.median(times) / 1e6, state


def bench_single_phase(quick):
    """Config 1: single-component D2Q9 channel flow, 1024x512."""
    import jax.numpy as jnp

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.single_phase import (BoundaryConfig,
                                                   SinglePhaseD2Q9)
    nx, ny = 512, 1024
    m = SinglePhaseD2Q9(geo.box_with_walls(nx, ny), tau=0.9,
                        collision="MRT", body_force=(0.0, -1e-6),
                        dtype=jnp.float32)
    f = m.init_state()
    mlups, f = _throughput(m._step_impl, (f,), 200 if quick else 1200,
                           nx * ny, unpack=True)
    rho, (ux, uy) = m.macro(f[0])
    return {"config": "1 single-phase D2Q9 channel 1024x512 MRT",
            "value": round(mlups, 1), "unit": "MLUPS",
            "max_u": round(float(jnp.max(jnp.abs(uy))), 6)}


def _sc_model(n, dtype):
    import jax.numpy as jnp  # noqa: F401

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.shanchen import ShanChenMCMP, ShanChenParams
    solid = np.zeros((n, n), bool)
    solid[:2, :] = True
    p = ShanChenParams(g_matrix=((0.0, 3.8), (3.8, 0.0)),
                       g_solid=(-0.4, 0.4), tau=(1.0, 1.0))
    return ShanChenMCMP(geo.from_solid_mask(solid), p, dtype=dtype), p


def bench_sc_droplet(quick):
    """Config 2: original Shan-Chen two-phase droplet / contact angle.

    Throughput at 1024^2 (600 steps), then the physics ASSERTION on an
    equilibrated 256^2 droplet: the measured spherical-cap angle must
    match the Huang 2007 analytic prediction
    (``metrics.analytic_sc_contact_angle``) within 12 degrees AND be
    equilibrated (< 2 deg drift between consecutive window-averaged
    10k-step windows) — a 600-step angle is meaningless and drifted
    76/62.5/48.2 deg across earlier rounds."""
    import jax.numpy as jnp

    from openlbmpm_tpu.metrics import (analytic_sc_contact_angle,
                                       measured_contact_angle)
    n = 1024
    m, p = _sc_model(n, jnp.float32)
    f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                             center=(2.0, n / 2), radius=100.0)
    mlups, (f,) = _throughput(m._step_impl, (f,), 200 if quick else 600,
                              n * n, unpack=True)

    # equilibrated contact-angle validation (small domain, long run)
    n2 = 256
    m2, _ = _sc_model(n2, jnp.float32)
    f2 = m2.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                               center=(2.0, n2 / 2), radius=50.0)
    step2 = m2._step_impl
    n_equil = 10000 if quick else 50000
    import jax

    def loop(k, s):
        return jax.lax.fori_loop(0, k, lambda _, x: step2(x), s)

    run = jax.jit(loop, static_argnums=0, donate_argnums=1)
    f2 = run(n_equil, f2)

    def angle(ff):
        rho_k, _ = m2.macro(ff)
        drop = np.asarray(rho_k[0]) > 0.5
        return measured_contact_angle(drop, wall_row=2), rho_k

    # Window-averaged drift check: the cap fit counts whole cells (base
    # chord / height are integers), so single samples quantize at ~±2
    # deg, and SC droplets carry a persistent spurious-current
    # oscillation of similar size.  Each window averages 5 samples 2000
    # steps apart; consecutive 10k-step window means must agree to 2 deg.
    def window(ff):
        thetas = []
        for _ in range(5):
            ff = run(2000, ff)
            th, rk = angle(ff)
            thetas.append(th)
        return float(np.mean(thetas)), ff, rk

    theta_a, f2, _ = window(f2)
    theta, f2, rho_k = window(f2)
    rho0 = np.asarray(rho_k[0])
    drop = rho0 > 0.5
    rho_main = float(rho0[drop].mean())
    rho_diss = float(rho0[~drop & np.asarray(m2.geo.is_fluid)].mean())
    theta_pred = analytic_sc_contact_angle(-0.4, 0.4, 3.8, rho_main,
                                           rho_diss)
    assert abs(theta - theta_a) < 2.0, \
        f"angle not equilibrated: {theta_a:.1f} -> {theta:.1f}"
    assert abs(theta - theta_pred) < 12.0, \
        f"angle {theta:.1f} vs analytic {theta_pred:.1f}"
    return {"config": "2 Shan-Chen droplet contact angle 1024^2",
            "value": round(mlups, 1), "unit": "MLUPS",
            "contact_angle_deg": round(theta, 1),
            "contact_angle_analytic_deg": round(theta_pred, 1),
            "angle_check": "PASS (window-averaged, equilibrated 256^2, "
                           "tol 12 deg)"}


def bench_efs_mrt(quick):
    """Config 3: explicit-forcing MRT Shan-Chen, viscosity contrast."""
    import jax.numpy as jnp

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.shanchen import ShanChenMCMP, ShanChenParams
    n = 1024
    p = ShanChenParams(g_matrix=((0.0, 0.2), (0.2, 0.0)),
                       g_solid=(0.0, 0.0), tau=(1.0, 0.55),
                       scheme="EFS", iso_order=8, collision="MRT")
    m = ShanChenMCMP(geo.from_solid_mask(np.zeros((n, n), bool)), p,
                     dtype=jnp.float32)
    f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02), radius=120.0)
    import jax.numpy as _j
    m0 = np.asarray(_j.sum(f, axis=(1, 2, 3)), np.float64)
    mlups, (f,) = _throughput(m._step_impl, (f,), 200 if quick else 600,
                              n * n, unpack=True)
    rho_k, (ux, uy) = m.macro(f)
    # physics assertions: per-fluid mass exactly conserved (periodic, no
    # open boundaries; f32 summation noise only), phases still separated,
    # spurious currents bounded
    m1 = np.asarray(_j.sum(f, axis=(1, 2, 3)), np.float64)
    mass_drift = float(np.abs(m1 / m0 - 1.0).max())
    assert mass_drift < 2e-5, f"per-fluid mass drift {mass_drift:.2e}"
    r0 = np.asarray(rho_k[0])
    assert r0.max() > 0.9 and float(np.asarray(rho_k[1]).max()) > 0.9, \
        "phases collapsed"
    umax = float(np.max(np.sqrt(np.asarray(ux) ** 2 + np.asarray(uy) ** 2)))
    assert umax < 0.05, f"spurious currents {umax:.3f}"
    return {"config": "3 EFS iso-8 MRT viscosity contrast 1024^2",
            "value": round(mlups, 1), "unit": "MLUPS",
            "mass_drift_rel": float(f"{mass_drift:.2e}"),
            "umax": round(umax, 5),
            "mass_check": "PASS (tol 2e-5)"}


def bench_csf_transport(quick):
    """Config 4: CSF color-gradient two-phase + passive transport."""
    import jax.numpy as jnp

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.colorgradient import (CGBoundaryConfig,
                                                    ColorGradientParams)
    from openlbmpm_tpu.models.transport import TransportParams, TransportRK
    n = 1024
    solid = np.zeros((n, n), bool)
    solid[:, 0] = solid[:, -1] = True
    fp = ColorGradientParams(variant="CSF", collision="MRT", tau_type=2,
                             wetting_type=2)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    tp = TransportParams(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
                         interface_mode="permeable", beta_interface=(0.5,))
    m = TransportRK(geo.from_solid_mask(solid), fp, tp, bcs,
                    dtype=jnp.float32)
    fs = m.flow.init_state_layers(1.0, 1.0, invading_rows=100)
    # tracer band placed interior: the inlet/outlet rows carry transport
    # BC rewrites that exchange mass by design, so conservation only
    # holds for mass that never reaches them.  Band edge sits 120 cells
    # (~7 diffusion lengths at D=1/6 over the benched horizon) from the
    # inlet rows.
    conc0 = np.zeros((1, n, n))
    conc0[0, n - 280:n - 120, :] = 1.0
    st = m.init_state(fs, conc0)
    # mass0 from the post-init state: init masks the solid wall columns,
    # so conc0.sum() over-counts by exactly 2/n.
    mass0 = float(np.asarray(m.concentration(st.g), np.float64).sum())
    mlups, (st,) = _throughput(m._step_impl, (st,), 100 if quick else 400,
                               n * n, unpack=True)
    conc = np.asarray(m.concentration(st.g))
    flow_s = np.asarray(st.f_r)
    # physics assertions: tracer mass conserved (no tracer inlet, no
    # reaction), flow state finite.  The scheme is exactly conservative —
    # f64 conserves to 1e-14 over 800 steps (and the CPU tier pins 1e-12,
    # tests/test_transport.py); in f32 a ~3e-8/step rounding bias
    # accumulates linearly, so the bound scales with the stepped horizon
    # (warmup + 3 timed regions) with ~3x headroom.
    steps_total = 4 * (100 if quick else 400)
    tol = 1e-7 * steps_total
    mass_drift = abs(float(np.asarray(conc, np.float64).sum()) / mass0 - 1.0)
    assert mass_drift < tol, \
        f"tracer mass drift {mass_drift:.2e} over {steps_total} steps"
    assert np.isfinite(flow_s).all(), "flow state not finite"
    assert conc.min() > -1e-4, f"negative concentration {conc.min():.1e}"
    return {"config": "4 CSF two-phase + transport 1024^2",
            "value": round(mlups, 1), "unit": "MLUPS (flow+transport)",
            "tracer_mass_drift_rel": float(f"{mass_drift:.2e}"),
            "tracer_mass_check": f"PASS (f32 rounding-bias bound "
                                 f"{tol:.1e} over {steps_total} steps; "
                                 f"f64 conserves to 1e-14)"}


def bench_cg3d_pore(quick):
    """Config 5: D3Q19 color-gradient drainage in a grain-pack pore
    structure at 128^3 with inlet/outlet BC slabs (see
    benchmarks/bench_cg3d.py for the standalone version)."""
    from bench_cg3d import run_bench
    return run_bench(n=96 if quick else 128)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    from openlbmpm_tpu.backend import (card_line, device_summary,
                                       require_gpu)
    device = device_summary(require_gpu())
    print(f"# card (nvidia-smi name, power.limit): {card_line()}",
          flush=True)
    failed = 0
    for fn in (bench_single_phase, bench_sc_droplet, bench_efs_mrt,
               bench_csf_transport, bench_cg3d_pore):
        try:
            rec = fn(args.quick)
        except Exception as ex:  # keep the harness going, fail at exit
            rec = {"config": fn.__name__, "error": str(ex)[:300]}
            failed += 1
        rec["device"] = device
        print(json.dumps(rec), flush=True)
    if failed:
        print(f"# {failed} config(s) FAILED physics assertions",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
