"""Smoke test of the whole program on NVIDIA GPUs.

    python chip_smoke.py          # one card: phases 1-7 below
    python chip_smoke.py --four   # four cards: the sharded paths only

One process drives every phase.  Each phase raises on failure and the first
failure ends the run with a non-zero exit code; without a GPU the script
stops in phase 1 and prints no result.  The last line of standard output is
one JSON object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Phases (one card):
  1 device      the default backend is a GPU; print its kind, count and
                ``nvidia-smi`` name and power limit
  2 flagship    ``cli.main run --model cg`` on configs/rk_csf2d.ini at
                4096^2 (CSF MRT, wetting walls, Neumann inlet, Dirichlet
                outlet), 400 steps in two I/O intervals
  3 cg3d        ``cli.main run --model cg3d`` on configs/rk_csf3d.ini at 256^3
  4 families    every other ``--model`` through the CLI (2D at 1024^2, 3D at
                128^3, 100 steps), with finiteness and mass checks
  5 throughput  MLUPS of the jitted flagship and cg3d steps (median and
                spread of timed windows, compilation outside them)
  6 reference   the f32 steps on the GPU against the same steps in f64 on
                the CPU backend of this process
  7 profiler    the flagship once more with ``--profile``; a trace is written

Phases (``--four``): the SPMD flagship step on 4 cards against 1 card, the
explicit shard_map halo stepper on the Shan-Chen model, and cg3d sharded in
z, each compared with its 1-card run.

Outputs go to a temporary directory outside the checkout, removed at exit.
"""

from __future__ import annotations

import argparse
import configparser
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

# Reference comparison (phase 6): an f32 step against the same step in f64.
# The mean bounds accumulated f32 rounding over the run; the max is set by
# the contact-line cells, where the wetting rotation's distance tie-breaks
# flip under 1-ulp differences (DEVIATIONS.md, "f32 reduction order").
REF_MEAN_TOL = 1e-5
REF_MAX_TOL = 1e-3
# Sharded against unsharded f32 (--four): the same f32 arithmetic in another
# reduction order; same contact-line reason for the max.
SHARD_MEAN_TOL = 1e-6
SHARD_MAX_TOL = 1e-3
# Mass checks of the CLI runs: closed domains conserve mass up to f32
# summation; open inlet/outlet rows exchange mass by design, so those runs
# are only held to a sanity bound over their 100-400 steps.
CLOSED_MASS_TOL = 1e-5
OPEN_MASS_TOL = 5e-2
# H100 SXM HBM bandwidth (NVIDIA data sheet, at the 700 W power limit).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def ini_copy(src: str, dst: str, changes: dict) -> str:
    """Copy a legacy INI, overriding ``{section: {key: value}}``."""
    cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
    with open(src) as fh:
        cp.read_string(fh.read())
    for section, kv in changes.items():
        if not cp.has_section(section):
            cp.add_section(section)
        for key, value in kv.items():
            cp.set(section, key, str(value))
    with open(dst, "w") as fh:
        cp.write(fh)
    return dst


def read_metrics(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def check_state_file(path: str) -> None:
    """Every float leaf of a checkpoint is finite."""
    import numpy as np
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("leaf") and z[key].dtype.kind == "f":
                if not np.isfinite(z[key]).all():
                    raise AssertionError(f"{path}:{key} is not finite")


def check_mass(name: str, recs: list, keys: tuple, closed: bool) -> dict:
    """Relative drift first -> last record of each mass key, and of their
    sum; the sum is held to the closed or open bound."""
    import math
    first, last = recs[0], recs[-1]
    drift = {}
    for k in keys:
        a, b = float(first[k]), float(last[k])
        if not (math.isfinite(a) and math.isfinite(b)):
            raise AssertionError(f"{name}: {k} not finite ({a}, {b})")
        drift[k] = (b - a) / a if a else float("nan")
    tot0 = sum(float(first[k]) for k in keys)
    tot1 = sum(float(last[k]) for k in keys)
    total = (tot1 - tot0) / tot0 if tot0 else float("nan")
    tol = CLOSED_MASS_TOL if closed else OPEN_MASS_TOL
    log(f"  {name}: mass drift per key {drift}, total {total:.3e} "
        f"(bound {tol:g}, {'closed' if closed else 'open'} domain)")
    if tot0 and not abs(total) <= tol:
        raise AssertionError(f"{name}: total mass drift {total:.3e} > {tol}")
    return drift


def cli_run(name: str, argv: list, out_dir: str, steps: int) -> list:
    from openlbmpm_tpu import cli
    t0 = time.perf_counter()
    rc = cli.main(["run", *argv, "--output", out_dir])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{name}: cli.main returned {rc}")
    recs = read_metrics(out_dir)
    if not recs or recs[-1]["step"] < steps:
        raise AssertionError(f"{name}: metrics end before step {steps}")
    log(f"  {name}: {steps} steps through cli.main in {dt:.1f} s "
        "(compilation and I/O included)")
    return recs


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(n_cards: int = 1) -> tuple:
    """(device summary, nvidia-smi card line)."""
    import jax

    from openlbmpm_tpu.backend import card_line, device_summary, require_gpu
    devices = require_gpu()
    if len(devices) < n_cards:
        raise AssertionError(f"needs {n_cards} GPUs, JAX sees {len(devices)}")
    summary = device_summary(devices)
    log(f"device: platform={summary['platform']} kind={summary['kind']} "
        f"count={summary['count']} jax={jax.__version__}")
    card = card_line()
    log(f"card (nvidia-smi name, power.limit): {card}")
    return summary, card


# ---------------------------------------------------------------------------
# phases 2-4, 7: the CLI
# ---------------------------------------------------------------------------

def flagship_cfg(work: str, n: int, steps: int, io: int) -> str:
    return ini_copy(os.path.join(CONFIGS, "rk_csf2d.ini"),
                    os.path.join(work, f"rk_csf2d_{n}.ini"),
                    {"DomainSize": {"xDomain": n, "yDomain": n},
                     "TimeSetup": {"TimeSteps": steps,
                                   "TimeInterval": io}})


def cg3d_cfg(work: str, n: int, steps: int, io: int) -> str:
    return ini_copy(os.path.join(CONFIGS, "rk_csf3d.ini"),
                    os.path.join(work, f"rk_csf3d_{n}.ini"),
                    {"DomainSize": {"xDomain": n, "yDomain": n,
                                    "zDomain": n},
                     "TimeSteps": {"TimeSteps": steps, "TimeInterval": io}})


def phase_flagship(work: str, n: int = 4096, steps: int = 400,
                   io: int = 200, profile_dir: str | None = None) -> None:
    cfg = flagship_cfg(work, n, steps, io)
    out = os.path.join(work, "flagship" if profile_dir is None
                       else "flagship_profile")
    argv = [cfg, "--model", "cg"]
    if profile_dir is not None:
        argv += ["--profile", profile_dir]
    recs = cli_run(f"cg {n}^2", argv, out, steps)
    ckpt = os.path.join(out, "checkpoint.npz")
    if not os.path.exists(ckpt):
        raise AssertionError("flagship: no checkpoint written")
    check_state_file(ckpt)
    check_mass(f"cg {n}^2", recs, ("mass_invading", "mass_defending"),
               closed=False)
    shutil.rmtree(out)


def phase_cg3d(work: str, n: int = 256, steps: int = 50,
               io: int = 25) -> None:
    out = os.path.join(work, "cg3d")
    recs = cli_run(f"cg3d {n}^3", [cg3d_cfg(work, n, steps, io), "--model",
                                   "cg3d"], out, steps)
    check_state_file(os.path.join(out, "checkpoint.npz"))
    check_mass(f"cg3d {n}^3", recs, ("mass_invading", "mass_defending"),
               closed=False)
    shutil.rmtree(out)


def family_runs(work: str, n2: int, n3: int, steps: int) -> dict:
    """name -> (argv, mass keys, closed domain) for every other family,
    as the README's usage block runs them."""
    half = max(1, steps // 2)
    c = lambda f: os.path.join(CONFIGS, f)  # noqa: E731
    w = lambda f: os.path.join(work, f)  # noqa: E731
    sc_main = ini_copy(c("twophasesetup.ini"), w("sc_main.ini"),
                       {"SeparationBorder": {"xGrid": n2, "yGrid": n2}})
    efs_main = ini_copy(c("twophasesetup.ini"), w("efs_main.ini"),
                        {"SeparationBorder": {"xGrid": n2, "yGrid": n2},
                         "InterType": {"InteractionType": "'EFS'"}})
    sc_phys = ini_copy(c("shanchen2D.ini"), w("sc_phys.ini"),
                       {"Time": {"numberTimeStep": steps}})
    efs_phys = ini_copy(c("efs2D.ini"), w("efs_phys.ini"),
                        {"Time": {"numberTimeStep": steps}})
    basic = ini_copy(c("basicsetup.ini"), w("basic.ini"),
                     {"Geometry": {"nx": n2, "ny": n2},
                      "Time": {"TimeLength": steps, "TimeInterval": half},
                      "FlowDomain": {"xDomain": f"1,{n2 - 2}",
                                     "yDomain": f"0,{n2 - 1}"}})
    flow2d = ini_copy(c("rk_csf2d.ini"), w("flow2d.ini"),
                      {"DomainSize": {"xDomain": n2, "yDomain": n2},
                       "TimeSetup": {"TimeSteps": steps,
                                     "TimeInterval": half}})
    sc3d = ini_copy(c("shanchen3d.ini"), w("sc3d.ini"),
                    {"DomainSize": {"xDomain": n3, "yDomain": n3,
                                    "zDomain": n3},
                     "Time": {"numberTimeStep": steps, "TimeInterval": half},
                     "InitialCondition": {"DropletRadius": n3 // 4}})
    basic3d = ini_copy(c("basic3d.ini"), w("basic3d.ini"),
                       {"Geometry": {"nx": n3, "ny": n3, "nz": n3},
                        "Time": {"TimeLength": steps,
                                 "TimeInterval": half}})
    flow3d = cg3d_cfg(work, n3, steps, half)
    transport = c("transportsetup.ini")
    two = ("mass_invading", "mass_defending")
    return {
        "sc": ([sc_main, "--model", "sc", "--physics-config", sc_phys],
               two, False),
        "efs": ([efs_main, "--model", "sc", "--physics-config", efs_phys],
                two, False),
        "basic": ([basic, "--model", "basic"], ("mass",), True),
        "transport": ([transport, "--model", "transport",
                       "--physics-config", flow2d], ("tracer0_mass",), None),
        "sc3d": ([sc3d, "--model", "sc3d"], two, True),
        "basic3d": ([basic3d, "--model", "basic3d"], ("mass",), True),
        "transport3d": ([transport, "--model", "transport3d",
                         "--physics-config", flow3d], ("tracer0_mass",),
                        None),
    }


def phase_families(work: str, n2: int = 1024, n3: int = 128,
                   steps: int = 100, only: tuple | None = None) -> None:
    import math
    for name, (argv, keys, closed) in family_runs(work, n2, n3,
                                                   steps).items():
        if only is not None and name not in only:
            continue
        out = os.path.join(work, name)
        recs = cli_run(name, argv, out, steps)
        if closed is None:
            # tracers enter through the inlet or start in one phase: check
            # finiteness and sign, and print the totals
            vals = [float(r[k]) for r in recs for k in keys]
            if not all(math.isfinite(v) and v >= -1e-3 for v in vals):
                raise AssertionError(f"{name}: tracer mass {vals}")
            log(f"  {name}: tracer mass {vals[0]:.6g} -> {vals[-1]:.6g}")
        else:
            check_mass(name, recs, keys, closed)
        shutil.rmtree(out)


def phase_profile(work: str, n: int = 4096, steps: int = 40,
                  io: int = 20) -> str:
    trace = os.path.join(work, "trace")
    phase_flagship(work, n, steps, io, profile_dir=trace)
    found = [os.path.join(dp, f) for dp, _, fs in os.walk(trace)
             for f in fs if f.endswith(".xplane.pb")]
    if not found or not all(os.path.getsize(p) > 0 for p in found):
        raise AssertionError(f"no non-empty .xplane.pb under {trace}")
    log(f"  profile: {found[0]} ({os.path.getsize(found[0])} bytes)")
    return found[0]


# ---------------------------------------------------------------------------
# phases 5-6: models built from the same configs
# ---------------------------------------------------------------------------

def flagship_model(work: str, n: int, dtype):
    from openlbmpm_tpu.cli import _build_geometry
    from openlbmpm_tpu.config import load_colorgradient
    from openlbmpm_tpu.models.colorgradient import ColorGradientRK
    params, bcs, domain, _ = load_colorgradient(flagship_cfg(work, n, 1, 1))
    model = ColorGradientRK(_build_geometry(domain), params, bcs,
                            dtype=dtype)
    state = model.init_state_layers(
        1.0, 1.0, invading_rows=max(domain.buffer_layers, 10))
    return model, state, lambda s: model._step_impl(*s)


def cg3d_model(work: str, n: int, dtype):
    from openlbmpm_tpu.cli import _box3d
    from openlbmpm_tpu.config import load_colorgradient3d
    from openlbmpm_tpu.models.flow3d import ColorGradientRK3D
    params, dom, _, extras = load_colorgradient3d(cg3d_cfg(work, n, 1, 1))
    model = ColorGradientRK3D(_box3d(dom), params, boundaries=extras["bcs"],
                              dtype=dtype)
    state = model.init_state_layers(extras["rho_r"], extras["rho_b"],
                                    invading_slabs=max(8, dom["nz"] // 10))
    return model, state, lambda s: model._step_impl(*s)


def efs_model(n: int, dtype):
    """EFS iso-8 MRT droplet with a viscosity contrast (periodic)."""
    import numpy as np

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.shanchen import ShanChenMCMP, ShanChenParams
    p = ShanChenParams(g_matrix=((0.0, 0.2), (0.2, 0.0)),
                       g_solid=(0.0, 0.0), tau=(1.0, 0.55), scheme="EFS",
                       iso_order=8, collision="MRT")
    model = ShanChenMCMP(geo.from_solid_mask(np.zeros((n, n), bool)), p,
                         dtype=dtype)
    state = model.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                     radius=0.12 * n)
    return model, state, model._step_impl


def densities(state):
    """Per-component densities (K, *spatial) of a split CG or SC state."""
    import jax.numpy as jnp
    if isinstance(state, tuple):
        return jnp.stack([jnp.sum(f, axis=0) for f in state])
    return jnp.sum(state, axis=1)


def looped(step, steps: int, **jit_kw):
    """``steps`` applications of ``step`` in one jitted ``fori_loop``
    (the state is donated unless ``donate_argnums=()`` is passed)."""
    import jax
    jit_kw.setdefault("donate_argnums", 0)
    return jax.jit(lambda s: jax.lax.fori_loop(0, steps,
                                               lambda _, x: step(x), s),
                   **jit_kw)


def advance(step, state, steps: int):
    return looped(step, steps)(state)


def timed_windows(step, state, steps: int, windows: int, **jit_kw):
    """(state, set-up seconds, window seconds): the first call compiles and
    runs one window; the timed ones follow it."""
    import jax
    run = looped(step, steps, **jit_kw)
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state))
    setup = time.perf_counter() - t0
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state))
        times.append(time.perf_counter() - t0)
    return state, setup, times


def report_rate(name: str, sites: int, steps: int, setup: float, times: list,
                bytes_per_update: int, device) -> float:
    mlups = [sites * steps / t / 1e6 for t in times]
    med = statistics.median(mlups)
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not available")
    line = (f"  {name}: median {med:.1f} MLUPS over {len(times)} windows of "
            f"{steps} steps (min {min(mlups):.1f}, max {max(mlups):.1f}); "
            f"set-up incl. compilation {setup:.1f} s; peak_bytes_in_use "
            f"{peak}")
    hbm = HBM_BYTES_PER_S.get(device.device_kind)
    if hbm is not None:
        share = med * 1e6 * bytes_per_update / hbm
        line += (f"; state-size floor {bytes_per_update} B/update = "
                 f"{share:.3f} of {hbm / 1e12:.2f} TB/s")
    log(line)
    return med


def phase_throughput(work: str, n2: int = 4096, n3: int = 256,
                     windows: int = 5, steps2: int = 100,
                     steps3: int = 30, card: str = "") -> dict:
    import jax
    import jax.numpy as jnp
    device = jax.devices()[0]
    if card:
        log(f"  card (nvidia-smi name, power.limit): {card}")
    out = {}
    # split f32 state in and out per site update: 2D 18 planes, 3D 38
    for name, build, n, steps, planes in (
            (f"cg CSF MRT {n2}^2", flagship_model, n2, steps2, 18),
            (f"cg3d D3Q19 CSF {n3}^3", cg3d_model, n3, steps3, 38)):
        model, state, step = build(work, n, jnp.float32)
        state, setup, times = timed_windows(step, state, steps, windows)
        for leaf in jax.tree_util.tree_leaves(state):
            if leaf.dtype != jnp.float32:
                raise AssertionError(f"{name}: state dtype {leaf.dtype}")
        if not bool(jnp.isfinite(densities(state)).all()):
            raise AssertionError(f"{name}: state not finite")
        sites = int(jnp.size(state[0][0]))
        out[name] = report_rate(name, sites, steps, setup, times,
                                planes * 8, device)
        del model, state
    return out


def compare(name: str, a, b, fluid, mean_tol: float, max_tol: float,
            enforce: bool = True) -> tuple:
    import numpy as np
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = d[:, np.asarray(fluid, bool)]
    if not np.isfinite(d).all():
        raise AssertionError(f"{name}: non-finite densities")
    mx, mean = float(d.max()), float(d.mean())
    ok = mean <= mean_tol and mx <= max_tol
    log(f"  {name}: max |drho| {mx:.3e}, mean |drho| {mean:.3e} over fluid "
        f"cells (tolerance mean <= {mean_tol:g}, max <= {max_tol:g}"
        f"{'' if enforce else ', recorded only'}): "
        f"{'PASS' if ok else 'FAIL'}")
    if enforce and not ok:
        raise AssertionError(f"{name}: outside tolerance")
    return mx, mean


def reference_pair(build, steps: int, ref_device):
    """f32 on the default device and f64 on ``ref_device``, from the same
    initial condition; returns (rho32, rho64, fluid mask)."""
    import jax
    import jax.numpy as jnp
    model, state, step = build(jnp.float32)
    rho32 = densities(advance(step, state, steps))
    fluid = model.geo.is_fluid
    del model, state
    with jax.default_device(ref_device):
        model, state, step = build(jnp.float64)
        rho64 = densities(advance(step, state, steps))
    return rho32, rho64, fluid


def phase_reference(work: str, n2: int = 1024, steps2: int = 100,
                    n3: int = 96, steps3: int = 50, ref_device=None) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from openlbmpm_tpu.ops import common
    if ref_device is None:
        ref_device = jax.devices("cpu")[0]
    log(f"  f32 on {jax.devices()[0].device_kind} with contractions at "
        f"{common.CONTRACTION_PRECISION}; f64 reference on the "
        f"{ref_device.platform} backend (deliberate CPU use)")
    cases = (
        (f"flagship CSF MRT {n2}^2, {steps2} steps",
         lambda dt: flagship_model(work, n2, dt), steps2),
        (f"EFS iso-8 MRT {n2}^2, {steps2} steps",
         lambda dt: efs_model(n2, dt), steps2),
        (f"cg3d D3Q19 CSF {n3}^3, {steps3} steps",
         lambda dt: cg3d_model(work, n3, dt), steps3),
    )
    flagship64 = None
    for name, build, steps in cases:
        rho32, rho64, fluid = reference_pair(build, steps, ref_device)
        compare(name, rho32, rho64, fluid, REF_MEAN_TOL, REF_MAX_TOL)
        if flagship64 is None:
            flagship64 = (rho64, fluid)
    # the same flagship f32 run with the backend's default contraction
    # precision (TF32 on the GPU), recorded for comparison
    from unittest import mock
    with mock.patch.object(common, "CONTRACTION_PRECISION",
                           lax.Precision.DEFAULT):
        model, state, step = flagship_model(work, n2, jnp.float32)
        rho_default = densities(advance(step, state, steps2))
    compare(f"flagship at DEFAULT precision {n2}^2, {steps2} steps",
            rho_default, flagship64[0], flagship64[1], REF_MEAN_TOL,
            REF_MAX_TOL, enforce=False)


# ---------------------------------------------------------------------------
# --four: the sharded paths
# ---------------------------------------------------------------------------

def step_time(step, state, steps: int, **jit_kw):
    """(state, median seconds per step over 3 timed windows); the input
    state is not donated, so it can seed the other run."""
    state, _, times = timed_windows(step, state, steps, 3,
                                    donate_argnums=(), **jit_kw)
    return state, statistics.median(times) / steps


def one_vs_four(name, build, n_steps, sharding_of, devices):
    """Run ``build()``'s state on one card and sharded on four; compare the
    densities after the same number of steps and print per-step times."""
    import jax
    model, state, step = build()
    fluid = model.geo.is_fluid
    one = jax.device_put(state, devices[0])
    one, t1 = step_time(step, one, n_steps)
    sharding = sharding_of(state)
    four = jax.device_put(state, sharding)
    four, t4 = step_time(step, four, n_steps, in_shardings=(sharding,),
                         out_shardings=sharding)
    log(f"  {name}: per step {t1 * 1e3:.3f} ms on 1 card, {t4 * 1e3:.3f} ms "
        f"on {len(devices)} cards")
    compare(f"{name} 4 cards vs 1", densities(four), densities(one), fluid,
            SHARD_MEAN_TOL, SHARD_MAX_TOL)


def phase_four(work: str, n2: int = 4096, n3: int = 256, n_sc: int = 1024,
               steps: int = 20, devices=None) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from openlbmpm_tpu import geometry as geo
    from openlbmpm_tpu.models.shanchen import ShanChenMCMP, ShanChenParams
    from openlbmpm_tpu.parallel.halo import make_sharded_stepper
    from openlbmpm_tpu.parallel.mesh import domain_sharding, make_mesh

    devices = jax.devices()[:4] if devices is None else devices
    xmesh = make_mesh(len(devices), devices=devices)   # (1, 4): x split
    zmesh = make_mesh(shape=(len(devices), 1), devices=devices)

    # SPMD flagship: XLA inserts the halo collectives
    one_vs_four(f"SPMD flagship CSF MRT {n2}^2 (x-sharded)",
                lambda: flagship_model(work, n2, jnp.float32), steps,
                lambda s: domain_sharding(xmesh, s[0].ndim), devices)
    # cg3d split in z (the flow axis): BC slabs land on the end shards
    one_vs_four(f"cg3d {n3}^3 (z-sharded)",
                lambda: cg3d_model(work, n3, jnp.float32), steps,
                lambda s: NamedSharding(zmesh, P(None, "y", None, None)),
                devices)

    # explicit shard_map + ppermute halo on the Shan-Chen droplet: the
    # local step runs on the halo-padded block of each card
    halo = 2   # force stencil radius 1 + streaming radius 1
    params = ShanChenParams(g_matrix=((0.0, 3.8), (3.8, 0.0)),
                            g_solid=(-0.4, 0.4), tau=(1.0, 1.0))

    def sc_model(nx):
        solid = np.zeros((n_sc, nx), bool)
        solid[:2, :] = True   # x-invariant wall: every block sees the same
        return ShanChenMCMP(geo.from_solid_mask(solid), params,
                            dtype=jnp.float32)

    glob = sc_model(n_sc)
    local = sc_model(n_sc // len(devices) + 2 * halo)
    f0 = glob.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                 center=(2.0, n_sc / 2), radius=n_sc / 10)
    one, t1 = step_time(glob._step_impl, jax.device_put(f0, devices[0]),
                        steps)
    stepper = make_sharded_stepper(local._step_impl, xmesh, state_ndim=4,
                                   halo=halo)
    four = jax.device_put(f0, domain_sharding(xmesh, 4))
    four, t4 = step_time(stepper, four, steps)
    log(f"  explicit-halo SC {n_sc}^2: per step {t1 * 1e3:.3f} ms on 1 card,"
        f" {t4 * 1e3:.3f} ms on {len(devices)} cards")
    compare(f"explicit-halo SC {n_sc}^2 4 cards vs 1", densities(four),
            densities(one), glob.geo.is_fluid, SHARD_MEAN_TOL, SHARD_MAX_TOL)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    import jax
    from openlbmpm_tpu.backend import enable_compile_cache
    # f64 for the CPU reference of phase 6; phase 5 asserts the f32 steps
    # stay f32 under it
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    n_cards = 4 if args.four else 1
    t_start = time.perf_counter()
    log("phase 1: device")
    summary, card = phase_device(n_cards)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            log("four cards: sharded paths against one card")
            phase_four(work)
        else:
            for title, fn in (
                    ("phase 2: flagship through the CLI", phase_flagship),
                    ("phase 3: cg3d through the CLI", phase_cg3d),
                    ("phase 4: every other family through the CLI",
                     phase_families),
                    ("phase 5: throughput",
                     lambda w: phase_throughput(w, card=card)),
                    ("phase 6: reference comparison", phase_reference),
                    ("phase 7: profiler", phase_profile)):
                t0 = time.perf_counter()
                log(title)
                fn(work)
                log(f"  ({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
