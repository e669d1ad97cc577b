"""Flagship benchmark: MLUPS of the CSF color-gradient two-phase step on one
GPU, with the physics of configs/rk_csf2d.ini (MRT, wetting side walls,
Neumann inlet, Dirichlet outlet) on an n x n lattice.

    python bench.py [--n 4096] [--steps 100] [--windows 5]

Prints the card's name and power limit, then one JSON line: the median
MLUPS over the timed windows with their spread, the set-up time (model
build and compilation, outside the windows), the device's peak bytes in
use, and the device keys.  Fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096, help="lattice side")
    ap.add_argument("--steps", type=int, default=100,
                    help="steps per timed window")
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from openlbmpm_tpu.backend import (card_line, device_summary,
                                       enable_compile_cache, require_gpu)
    from openlbmpm_tpu.cli import _build_geometry
    from openlbmpm_tpu.config import load_colorgradient
    from openlbmpm_tpu.models.colorgradient import ColorGradientRK

    devices = require_gpu()
    enable_compile_cache()
    print(f"# card (nvidia-smi name, power.limit): {card_line()}",
          flush=True)

    t0 = time.perf_counter()
    params, bcs, domain, _ = load_colorgradient(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "configs",
        "rk_csf2d.ini"))
    domain = dataclasses.replace(domain, nx=args.n, ny=args.n)
    model = ColorGradientRK(_build_geometry(domain), params, bcs,
                            dtype=jnp.float32)
    state = model.init_state_layers(
        1.0, 1.0, invading_rows=max(domain.buffer_layers, 10))

    def loop(s):
        return jax.lax.fori_loop(0, args.steps,
                                 lambda _, x: model._step_impl(*x), s)

    run = jax.jit(loop, donate_argnums=0)
    state = jax.block_until_ready(run(state))   # compiles + one window
    setup = time.perf_counter() - t0
    times = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state))
        times.append(time.perf_counter() - t0)
    if not bool(jnp.isfinite(state[0]).all()):
        raise FloatingPointError("flagship state not finite")
    if state[0].dtype != jnp.float32:
        raise TypeError(f"state dtype {state[0].dtype}, expected float32")

    mlups = sorted(args.n * args.n * args.steps / t / 1e6 for t in times)
    stats = devices[0].memory_stats() or {}
    print(json.dumps({
        "metric": f"MLUPS, {args.n}^2 D2Q9 CSF color-gradient two-phase, "
                  "MRT, f32 (configs/rk_csf2d.ini physics)",
        "value": statistics.median(mlups),
        "unit": "MLUPS",
        "min": mlups[0], "max": mlups[-1], "windows": args.windows,
        "steps_per_window": args.steps,
        "setup_s": setup,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "device": device_summary(devices),
    }))


if __name__ == "__main__":
    main()
