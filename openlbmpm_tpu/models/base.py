"""Shared model infrastructure: the chunked run harness.

Divergence from the reference: the reference re-launches ~12-15
CUDA kernels per time step from the Python host (SURVEY.md section 3) — the
single biggest performance bug to not replicate.  Here every model exposes a
pure ``step(state) -> state`` compiled once with ``jax.jit``; the harness
batches ``io_interval`` steps into one ``lax.fori_loop`` on device so host
sync happens only at the I/O cadence (SURVEY.md section 7, decision 6).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import jax
from jax import lax

__all__ = ["RunMetrics", "run_chunked"]


class RunMetrics:
    """Throughput meter: wall clock, steps/s, MLUPS (million lattice-site
    updates per second).  Replaces the reference's started-but-never-reported
    timer (``ShanChenD2Q9.py:1080,1493``)."""

    def __init__(self, active_sites: int):
        self.active_sites = int(active_sites)
        self.steps = 0
        self.elapsed = 0.0

    def update(self, steps: int, seconds: float):
        self.steps += steps
        self.elapsed += seconds

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.active_sites * self.steps / self.elapsed / 1e6

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0


def run_chunked(
    step_fn: Callable[[Any], Any],
    state: Any,
    num_steps: int,
    io_interval: int,
    callback: Callable[[int, Any], bool | None] | None = None,
    metrics: RunMetrics | None = None,
    donate: bool = True,
    profile_dir: str | None = None,
    nan_guard: bool = False,
):
    """Advance `state` by `num_steps`, syncing to host every `io_interval`.

    callback(step, state) is invoked at the I/O cadence with the *device*
    state; returning True stops the run early (steady-state / breakthrough
    criteria).  With `profile_dir`, the second chunk (first post-compile)
    is captured with ``jax.profiler`` and each chunk carries a
    ``StepTraceAnnotation`` — the observability the reference starts but
    never reports (``ShanChenD2Q9.py:1080,1493``, SURVEY.md section 5).
    `nan_guard` checks the state for non-finite values at the I/O cadence
    and raises with the offending step range (failure detection the
    reference lacks; a diverged LBM run otherwise produces NaN fields
    silently).  Returns the final state.
    """
    io_interval = max(1, min(io_interval, num_steps)) if num_steps else 1

    def chunk_body(_, s):
        return step_fn(s)

    def run_chunk(s, n):
        return lax.fori_loop(0, n, chunk_body, s)

    jit_kwargs = {"static_argnums": (1,)}
    if donate:
        jit_kwargs["donate_argnums"] = (0,)
    run_chunk = jax.jit(run_chunk, **jit_kwargs)

    done = 0
    chunk_idx = 0
    profiling = False
    if callback is not None and callback(0, state):
        return state
    while done < num_steps:
        n = min(io_interval, num_steps - done)
        if profile_dir is not None and chunk_idx == 1 and not profiling:
            jax.profiler.start_trace(profile_dir)
            profiling = True
        t0 = time.perf_counter()
        with jax.profiler.StepTraceAnnotation("lbm_chunk", step_num=done):
            state = run_chunk(state, n)
            jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        if profiling:
            jax.profiler.stop_trace()
            profiling = False
        done += n
        chunk_idx += 1
        if nan_guard:
            leaves = jax.tree_util.tree_leaves(state)
            finite = all(bool(jax.numpy.isfinite(x).all()) for x in leaves
                         if hasattr(x, "dtype") and
                         jax.numpy.issubdtype(x.dtype, jax.numpy.floating))
            if not finite:
                raise FloatingPointError(
                    f"non-finite state between steps {done - n} and {done} "
                    "(diverged run: check tau > 0.5, interaction strength, "
                    "and inlet velocity)")
        if metrics is not None:
            metrics.update(n, dt)
        if callback is not None and callback(done, state):
            break
    return state
