"""Non-interactive CLI: ``python -m openlbmpm_tpu run <config.ini> [...]``.

Replaces the reference's interactive ``input()`` menu driver
(``/root/reference/main.py:40-81``) with flags: model family, step count,
output directory, dtype, and platform are explicit; nothing blocks on a
prompt (SURVEY.md section 0 lists the reference's interactive gates).

Subcommands:
  run        run a simulation from a legacy-dialect INI file
  bench      quick MLUPS measurement of a model family
  inspect    parse a config and print the resolved typed parameters
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _build_geometry(domain, geometry_kind: str = "box"):
    from . import geometry as geo
    if domain.use_image and domain.image_path:
        solid = geo.load_structure_image(domain.image_path)
        if domain.duplicate != (1, 1):
            solid = geo.duplicate_domain(solid, *domain.duplicate)
        if domain.buffer_layers:
            solid = geo.add_buffer_layers(solid, domain.buffer_layers)
        return geo.from_solid_mask(solid)
    if geometry_kind == "channel":
        return geo.open_channel(domain.nx, domain.ny)
    g = geo.box_with_walls(domain.nx, domain.ny)
    if domain.buffer_layers:
        return geo.from_solid_mask(
            geo.add_buffer_layers(g.is_solid, domain.buffer_layers,
                                  seal_sides=True))
    return g


def _run_colorgradient(args):
    import jax.numpy as jnp

    from .checkpoint import (config_fingerprint, load_checkpoint,
                             save_checkpoint)
    from .config import load_colorgradient
    from .io import ResultWriter, save_png_field
    from .metrics import (MetricsLogger, flow_diagnostics,
                          steady_state_criterion)
    from .models.base import run_chunked
    from .models.colorgradient import ColorGradientRK

    params, bcs, domain, run = load_colorgradient(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _build_geometry(domain)
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = ColorGradientRK(geometry, params, bcs, dtype=dtype)
    state = model.init_state_layers(
        1.0, 1.0, invading_rows=max(domain.buffer_layers, 10))
    fingerprint = config_fingerprint(params)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
        if run.is_cycle:
            from .checkpoint import di_cycle_swap
            state = di_cycle_swap(*state,
                                  buffer_rows=max(domain.buffer_layers, 10))
            print("D-I cycle: fluids swapped in the buffer layers")

    writer = ResultWriter(args.output, basename="SimulationResultsRK")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)
    prev_u = {"u": None}

    def callback(step, s):
        f_r, f_b = s
        rho_r, rho_b, phi, (ux, uy) = model.macro(s)
        writer.write_rk(start_step + step, np.asarray(rho_r),
                        np.asarray(rho_b), np.asarray(ux), np.asarray(uy),
                        f_r=np.asarray(f_r), f_b=np.asarray(f_b))
        if args.png:
            save_png_field(
                os.path.join(args.output,
                             f"phi_{start_step + step:08d}.png"),
                np.asarray(phi), title=f"phi @ {start_step + step}")
        d = flow_diagnostics(rho_r, rho_b, ux, uy, geometry.is_fluid)
        # steady-state criterion: relative L2 velocity change between
        # observations (``ShanChenD2Q9.__calSteadyStateCritiria:831-850``)
        if prev_u["u"] is not None and step > 0:
            d["steady_criterion"] = steady_state_criterion(
                ux, uy, *prev_u["u"])
        prev_u["u"] = (ux, uy)
        rec = logger.log(start_step + step, **d)
        # checkpointing every interval would dominate the I/O budget;
        # save every ~10 intervals and at the end of the run
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, s, start_step + step, fingerprint)
        if args.stop_at_breakthrough and d["breakthrough"]:
            print(f"breakthrough at step {rec['step']}")
            return True
        if args.stop_at_steady and d.get("steady_criterion") is not None \
                and d["steady_criterion"] < args.stop_at_steady:
            print(f"steady state at step {rec['step']} "
                  f"(criterion {d['steady_criterion']:.2e})")
            return True
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _run_shanchen(args):
    import jax.numpy as jnp

    from .checkpoint import (config_fingerprint, di_cycle_swap_sc,
                             load_checkpoint, save_checkpoint)
    from .config import load_shanchen
    from .io import ResultWriter
    from .metrics import MetricsLogger, flow_diagnostics
    from .models.base import run_chunked
    from .models.shanchen import ShanChenMCMP

    params, bcs, domain, run, extras = load_shanchen(args.config,
                                                     args.physics_config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _build_geometry(domain, geometry_kind="channel")
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = ShanChenMCMP(geometry, params, bcs, dtype=dtype)
    state = model.init_state_layers(
        extras.get("initial_densities", (1.0, 1.0)),
        extras.get("background_densities", (0.02, 0.02)))
    fingerprint = config_fingerprint(params)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
        if run.is_cycle:
            state = di_cycle_swap_sc(state, buffer_rows=10)
            print("D-I cycle: fluids swapped in the buffer layers")
    writer = ResultWriter(args.output, basename="SimulationResults")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, f):
        rho_k, (ux, uy) = model.macro(f)
        writer.write_sc(start_step + step, np.asarray(rho_k),
                        np.asarray(ux), np.asarray(uy))
        logger.log(start_step + step,
                   **flow_diagnostics(rho_k[0], rho_k[1], ux, uy,
                                      geometry.is_fluid))
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, f, start_step + step, fingerprint)
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _run_transport(args):
    import jax.numpy as jnp

    from .config import load_colorgradient, load_transport
    from .io import ResultWriter
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    from .models.transport import TransportRK

    tparams = load_transport(args.config)
    flow_params, bcs, domain, run = load_colorgradient(
        args.physics_config or args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _build_geometry(domain)
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = TransportRK(geometry, flow_params, tparams, bcs, dtype=dtype)
    flow_state = model.flow.init_state_layers(
        1.0, 1.0, invading_rows=max(domain.buffer_layers, 10))
    ny, nx = geometry.shape
    conc0 = np.zeros((tparams.num_tracers, ny, nx))
    state = model.init_state(flow_state, conc0)
    writer = ResultWriter(args.output, basename="ConcentrationResults")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)

    def callback(step, s):
        conc = model.concentration(s.g)
        writer.write_transport(step, np.asarray(conc))
        masses = {f"tracer{i}_mass": float(np.asarray(conc[i]).sum())
                  for i in range(conc.shape[0])}
        logger.log(step, **masses)
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                profile_dir=args.profile)
    logger.close()
    return 0


def _run_colorgradient3d(args):
    import jax.numpy as jnp

    from . import geometry as geo
    from .config import load_colorgradient3d
    from .io import ResultWriter
    from .metrics import MetricsLogger, flow_diagnostics
    from .models.base import run_chunked
    from .models.flow3d import ColorGradientRK3D

    params, dom, run, extras = load_colorgradient3d(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    solid = np.zeros((dom["nz"], dom["ny"], dom["nx"]), bool)
    solid[:, :, 0] = solid[:, :, -1] = True
    solid[:, 0, :] = solid[:, -1, :] = True
    geometry = geo.from_solid_mask(solid)
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = ColorGradientRK3D(geometry, params,
                              boundaries=extras["bcs"], dtype=dtype)
    state = model.init_state_layers(extras["rho_r"], extras["rho_b"],
                                    invading_slabs=max(8, dom["nz"] // 10))
    writer = ResultWriter(args.output, basename="SimulationResultsRK3D")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)

    from .checkpoint import (config_fingerprint, load_checkpoint,
                             save_checkpoint)
    fingerprint = config_fingerprint(params)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, s):
        step = start_step + step
        rho_r, rho_b, phi, u = model.macro(s)
        writer.write(step, {
            f"FluidMacro/FluidDensityRin{step}": np.asarray(rho_r),
            f"FluidMacro/FluidDensityBin{step}": np.asarray(rho_b),
        })
        # front position along -z (3D drainage direction)
        d = flow_diagnostics(rho_r.reshape(rho_r.shape[0], -1),
                             rho_b.reshape(rho_b.shape[0], -1),
                             u[0].reshape(u[0].shape[0], -1),
                             u[2].reshape(u[2].shape[0], -1),
                             geometry.is_fluid.reshape(
                                 geometry.is_fluid.shape[0], -1))
        logger.log(step, **d)
        if (step - start_step) % ckpt_every == 0 or \
                step - start_step >= run.num_steps:
            save_checkpoint(ckpt_path, s, step, fingerprint)
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                profile_dir=args.profile)
    logger.close()
    return 0


def _box3d(dom):
    """3D box geometry: solid walls on the x and y faces, open z."""
    from . import geometry as geo
    solid = np.zeros((dom["nz"], dom["ny"], dom["nx"]), bool)
    solid[:, :, 0] = solid[:, :, -1] = True
    solid[:, 0, :] = solid[:, -1, :] = True
    return geo.from_solid_mask(solid)


def _run_shanchen3d(args):
    """3D Shan-Chen MCMP run (D3Q19; the reference driver imports 3D SC
    modules absent from its snapshot, ``main.py:15-22``)."""
    import jax.numpy as jnp

    from .checkpoint import (config_fingerprint, load_checkpoint,
                             save_checkpoint)
    from .config import load_shanchen3d
    from .io import ResultWriter
    from .metrics import MetricsLogger, flow_diagnostics
    from .models.base import run_chunked
    from .models.flow3d import ShanChenMCMP3D

    params, dom, run, extras = load_shanchen3d(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _box3d(dom)
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = ShanChenMCMP3D(geometry, params, dtype=dtype)
    state = model.init_state_droplet(extras["initial_densities"],
                                     extras["background_densities"],
                                     radius=extras["radius"])
    fingerprint = config_fingerprint(params)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")

    writer = ResultWriter(args.output, basename="SimulationResultsSC3D")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, f):
        rho_k, u = model.macro(f)
        writer.write(start_step + step, {
            f"FluidMacro/FluidDensity{k}in{start_step + step}":
                np.asarray(rho_k[k]) for k in range(model.k)})
        d = flow_diagnostics(
            rho_k[0].reshape(rho_k.shape[1], -1),
            rho_k[1].reshape(rho_k.shape[1], -1),
            u[0].reshape(u[0].shape[0], -1),
            u[2].reshape(u[2].shape[0], -1),
            geometry.is_fluid.reshape(geometry.is_fluid.shape[0], -1))
        logger.log(start_step + step, **d)
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, f, start_step + step, fingerprint)
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _run_basic3d(args):
    """3D single-phase run (D3Q19 SRT/TRT)."""
    import jax.numpy as jnp

    from .checkpoint import (config_fingerprint, load_checkpoint,
                             save_checkpoint)
    from .config import load_basic3d
    from .io import ResultWriter
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    from .models.flow3d import SinglePhaseD3Q19

    solver_kw, dom, run = load_basic3d(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _box3d(dom)
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = SinglePhaseD3Q19(geometry, dtype=dtype, **solver_kw)
    state = model.init_state(1.0)
    fingerprint = config_fingerprint(solver_kw)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")

    writer = ResultWriter(args.output, basename="SimulationResults3D")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, f):
        rho, u = model.macro(f)
        writer.write(start_step + step, {
            f"FluidMacro/FluidDensityin{start_step + step}":
                np.asarray(rho)})
        logger.log(start_step + step, mass=float(jnp.sum(rho)),
                   umax=float(jnp.max(jnp.sqrt(
                       u[0] ** 2 + u[1] ** 2 + u[2] ** 2))))
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, f, start_step + step, fingerprint)
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _run_transport3d(args):
    """Coupled 3D flow + D3Q7 tracer transport (the reference promises
    3D transport but ships none, ``main.py:72-81``).  The transport INI
    rides in ``config``; the 3D flow INI in ``--physics-config`` (or the
    same file)."""
    import jax.numpy as jnp

    from .config import load_colorgradient3d, load_transport
    from .io import ResultWriter
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    from .models.flow3d import TransportRK3D

    tparams = load_transport(args.config)
    flow_params, dom, run, extras = load_colorgradient3d(
        args.physics_config or args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    geometry = _box3d(dom)
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = TransportRK3D(
        geometry, flow_params, num_tracers=tparams.num_tracers,
        tau=tparams.tau, j0=tparams.j0,
        interface_mode=("bounceback"
                        if tparams.beta_interface[0] == 0.0 else "none"),
        boundaries=extras["bcs"], dtype=dtype)
    flow_state = model.flow.init_state_layers(
        extras["rho_r"], extras["rho_b"],
        invading_slabs=max(8, dom["nz"] // 10))
    nz, ny, nx = geometry.shape
    conc0 = np.zeros((tparams.num_tracers, nz, ny, nx))
    conc0[:, nz - max(8, nz // 10):] = 1.0
    state = model.init_state(flow_state, conc0)

    writer = ResultWriter(args.output, basename="ConcentrationResults3D")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           geometry.num_fluid_nodes, echo=True)

    def callback(step, s):
        conc = model.concentration(s[2])
        writer.write_transport(step, np.asarray(conc))
        logger.log(step, **{f"tracer{i}_mass":
                            float(np.asarray(conc[i]).sum())
                            for i in range(conc.shape[0])})
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                profile_dir=args.profile)
    logger.close()
    return 0


def _run_basic(args):
    """Single-phase D2Q9 channel run (the reference's BasicD2Q9 /
    basicsetup.ini surface, ``SimpleD2Q9.py:221-331``)."""
    import jax.numpy as jnp

    from . import geometry as geo
    from .checkpoint import (config_fingerprint, load_checkpoint,
                             save_checkpoint)
    from .config import load_basic
    from .io import ResultWriter, save_png_field
    from .metrics import MetricsLogger
    from .models.base import run_chunked
    from .models.single_phase import SinglePhaseD2Q9

    solver_kw, u0, (xext, yext), dom, run = load_basic(args.config)
    if args.steps:
        run = dataclasses.replace(run, num_steps=args.steps)
    solid = np.ones((dom.ny, dom.nx), bool)
    solid[yext[0]:yext[1] + 1, xext[0]:xext[1] + 1] = False
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    model = SinglePhaseD2Q9(geo.from_solid_mask(solid), dtype=dtype,
                            **solver_kw)
    state = model.init_state(1.0, u0)
    fingerprint = config_fingerprint(solver_kw)
    start_step = 0
    ckpt_path = os.path.join(args.output, "checkpoint.npz")
    if args.resume and os.path.exists(ckpt_path):
        state, start_step = load_checkpoint(ckpt_path, state, fingerprint)
        print(f"resumed from step {start_step}")

    writer = ResultWriter(args.output, basename="SimulationResults")
    logger = MetricsLogger(os.path.join(args.output, "metrics.jsonl"),
                           model.geo.num_fluid_nodes, echo=True)
    ckpt_every = max(1, 10 * run.io_interval)

    def callback(step, f):
        rho, (ux, uy) = model.macro(f)
        writer.write(start_step + step, {
            f"FluidMacro/FluidDensityin{start_step + step}":
                np.asarray(rho),
            f"FluidVelocity/FluidVelocityXin{start_step + step}":
                np.asarray(ux),
            f"FluidVelocity/FluidVelocityYin{start_step + step}":
                np.asarray(uy),
        })
        if args.png:
            save_png_field(
                os.path.join(args.output,
                             f"u_{start_step + step:08d}.png"),
                np.asarray(jnp.sqrt(ux * ux + uy * uy)),
                title=f"|u| @ {start_step + step}")
        logger.log(start_step + step,
                   mass=float(jnp.sum(rho)),
                   umax=float(jnp.max(jnp.sqrt(ux * ux + uy * uy))))
        if step % ckpt_every == 0 or step >= run.num_steps:
            save_checkpoint(ckpt_path, f, start_step + step, fingerprint)
        return False

    run_chunked(model.step, state, num_steps=run.num_steps,
                io_interval=run.io_interval, callback=callback,
                nan_guard=True, profile_dir=args.profile)
    logger.close()
    return 0


def _inspect(args):
    from .config import (load_basic, load_colorgradient,
                         load_colorgradient3d, load_shanchen,
                         load_transport)
    from .config import load_basic3d, load_shanchen3d
    loaders = {"cg": lambda: load_colorgradient(args.config)[:2],
               "cg3d": lambda: (load_colorgradient3d(args.config)[0],),
               "sc": lambda: load_shanchen(args.config,
                                           args.physics_config)[:2],
               "sc3d": lambda: (load_shanchen3d(args.config)[0],),
               "transport": lambda: (load_transport(args.config),),
               "transport3d": lambda: (load_transport(args.config),),
               "basic": lambda: (load_basic(args.config)[0],),
               "basic3d": lambda: (load_basic3d(args.config)[0],)}
    out = loaders[args.model]()
    for obj in out:
        if dataclasses.is_dataclass(obj):
            obj = dataclasses.asdict(obj)
        print(json.dumps(obj, default=str, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="openlbmpm-tpu",
        description="Multicomponent/multiphase lattice Boltzmann for "
                    "porous media")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("config", help="legacy-dialect INI file")
        sp.add_argument("--model", choices=("cg", "cg3d", "sc", "sc3d",
                                            "transport", "transport3d",
                                            "basic", "basic3d"),
                        default="cg", help="model family")
        sp.add_argument("--physics-config", default=None,
                        help="secondary INI (SC physics / transport flow)")
        sp.add_argument("--steps", type=int, default=0,
                        help="override step count")
        sp.add_argument("--output", default="results")
        sp.add_argument("--dtype", choices=("f32", "f64"), default="f32")
        sp.add_argument("--png", action="store_true",
                        help="write PNG snapshots at the I/O cadence")
        sp.add_argument("--resume", action="store_true",
                        help="resume from <output>/checkpoint.npz")
        sp.add_argument("--stop-at-breakthrough", action="store_true")
        sp.add_argument("--stop-at-steady", type=float, default=0.0,
                        help="stop when the relative L2 velocity change "
                             "between outputs drops below this tolerance")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a jax.profiler trace of the first "
                             "post-compile chunk into DIR (phases carry "
                             "named_scope annotations: bc/fields/collide/"
                             "stream)")

    runp = sub.add_parser("run", help="run a simulation")
    common(runp)
    insp = sub.add_parser("inspect", help="print resolved parameters")
    common(insp)
    sub.add_parser("bench", help="flagship MLUPS benchmark (bench.py)")

    args = p.parse_args(argv)
    if args.cmd == "bench":
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py")
        spec = importlib.util.spec_from_file_location("bench", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main([])
        return 0
    if args.cmd == "inspect":
        return _inspect(args)
    import jax

    from .backend import enable_compile_cache
    enable_compile_cache()
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    os.makedirs(args.output, exist_ok=True)
    return {"cg": _run_colorgradient, "cg3d": _run_colorgradient3d,
            "sc": _run_shanchen, "sc3d": _run_shanchen3d,
            "transport": _run_transport, "transport3d": _run_transport3d,
            "basic": _run_basic, "basic3d": _run_basic3d}[args.model](args)


if __name__ == "__main__":
    sys.exit(main())
