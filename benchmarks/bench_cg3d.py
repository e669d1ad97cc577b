"""3D CSF drainage benchmark: D3Q19 color-gradient in a grain-pack pore
structure (BASELINE.json config 5; reference config
``IniFiles/RKtwophasesetup3D.ini:5-7``).

Generates a deterministic grain-pack cross-section from a seed, extrudes it
along the flow axis with open buffer slabs, and times the D3Q19 step with
velocity inlet + convective outlet; then checks that the invading front
advances through the pore space.

Usage: python benchmarks/bench_cg3d.py [N]   (default 128)
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pore_section(n=128, n_grains=60, seed=7):
    """Deterministic grain-pack cross-section (True = solid)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    solid = np.zeros((n, n), bool)
    for _ in range(n_grains):
        cy, cx = rng.randint(0, n, 2)
        r = rng.randint(n // 24, n // 10)
        solid |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    # keep a connected open path: carve a channel band
    band = slice(n // 2 - n // 10, n // 2 + n // 10)
    w = band.stop - band.start
    solid[:, band] &= rng.rand(n, w) > 0.6
    return solid


def run_bench(n=128, windows=3, steps=30):
    import jax
    import jax.numpy as jnp

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.flow3d import (CG3DBoundaryConfig,
                                             ColorGradientParams3D,
                                             ColorGradientRK3D)

    solid = geo.extrude_image_3d(pore_section(n), n, buffer_slabs=8)
    g = geo.from_solid_mask(solid)
    params = ColorGradientParams3D(
        tau_r=1.0, tau_b=1.0, surface_tension=0.05, contact_angle_deg=45.0,
        beta=0.7, tau_type=2)
    bcs = CG3DBoundaryConfig(inlet="velocity", outlet="convective",
                             inlet_velocity=-2e-3)
    model = ColorGradientRK3D(g, params, bcs, dtype=jnp.float32)
    s = model.init_state_layers(1.0, 1.0, invading_slabs=16)

    def loop(k, s):
        return jax.lax.fori_loop(0, k, lambda _, x: model._step_impl(*x), s)

    run = jax.jit(loop, static_argnums=0, donate_argnums=1)
    t0 = time.perf_counter()
    s = jax.block_until_ready(run(steps, s))
    setup = time.perf_counter() - t0
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        s = jax.block_until_ready(run(steps, s))
        times.append(time.perf_counter() - t0)
    mlups = sorted(n ** 3 * steps / t / 1e6 for t in times)

    # physics assertions: porosity sanity bounds catch a broken geometry
    # pipeline; then a longer drainage phase checks the invading (red)
    # front advances through the pore space at roughly the injection speed
    porosity = float(g.porosity)
    assert 0.2 < porosity < 0.9, f"porosity {porosity:.3f} out of band"

    def _front(state):
        occ = (np.asarray(jnp.sum(state[0], axis=0)) > 0.5).any(axis=(1, 2))
        idx = np.where(occ)[0]
        return int(idx.min()) if idx.size else occ.shape[0]

    front0 = _front(s)
    physics_steps = 4000
    s = run(physics_steps, s)
    front1 = _front(s)
    advance = front0 - front1
    # mean front speed = injection velocity (2e-3); pore throats locally
    # faster, trapped regions slower -- require at least 40% of ballistic
    expected = 2e-3 * physics_steps
    assert advance >= 0.4 * expected, \
        f"front advanced {advance} slabs in {physics_steps} steps " \
        f"(expected ~{expected:.0f})"
    assert bool(jnp.isfinite(s[0]).all()), "state not finite"
    return {
        "config": f"5 D3Q19 CSF drainage, grain-pack pore structure {n}^3",
        "metric": "velocity-in/convective-out, split f32 state",
        "value": statistics.median(mlups),
        "unit": "MLUPS",
        "min": mlups[0], "max": mlups[-1], "setup_s": setup,
        "porosity": round(porosity, 3),
        "front_advance_slabs": advance,
        "front_check": f"PASS (>= 0.4 x {expected:.0f} in "
                       f"{physics_steps} steps)",
    }


def main(n=128):
    from openlbmpm_tpu.backend import device_summary, require_gpu
    rec = run_bench(n)
    rec["device"] = device_summary(require_gpu())
    print(json.dumps(rec))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
