"""Checkpoint / resume and drainage-imbibition (D-I) cycles.

First-class replacement for the reference's restart mechanism, where regular
HDF5 output doubles as checkpoint state (PDFs are saved,
``RKD2Q9.py:950-951``) and a new cycle reloads
``~/LBMInitial/SimulationResults.h5`` at array index ``LastStep`` and
**swaps the two fluids inside the buffer layers** to reverse the
displacement direction (``ShanChenD2Q9.py:788-817``, ``RKD2Q9.py:532-575``).

Checkpoints are plain npz (no external deps): the full state pytree plus
the step counter and a config fingerprint that guards against resuming with
different physics.
"""

from __future__ import annotations

import hashlib
import json
import os

import jax
import numpy as np

__all__ = ["config_fingerprint", "save_checkpoint", "load_checkpoint",
           "di_cycle_swap"]


def config_fingerprint(obj) -> str:
    """Stable hash of a (nested) params object for resume validation."""
    def enc(o):
        if hasattr(o, "__dataclass_fields__"):
            return {k: enc(getattr(o, k)) for k in o.__dataclass_fields__}
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if isinstance(o, np.ndarray):
            return o.tolist()
        return o
    payload = json.dumps(enc(obj), sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_checkpoint(path: str, state, step: int, fingerprint: str = ""):
    """Write the state pytree (tuples/namedtuples of arrays) to npz."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    payload = {f"leaf{i}": np.asarray(v) for i, v in enumerate(leaves)}
    payload["__step__"] = np.asarray(step)
    payload["__fingerprint__"] = np.asarray(fingerprint)
    payload["__treedef__"] = np.asarray(str(treedef))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **payload)  # uncompressed, as ResultWriter.write


def load_checkpoint(path: str, like_state, fingerprint: str = ""):
    """Load a checkpoint into the structure of `like_state`.

    Returns (state, step).  Raises on fingerprint mismatch when both sides
    carry one (resuming with different physics is a silent-corruption bug in
    the reference's cycle restart; we refuse instead).
    """
    with np.load(path, allow_pickle=False) as z:
        saved_fp = str(z["__fingerprint__"])
        if fingerprint and saved_fp and saved_fp != fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {saved_fp} != config {fingerprint}")
        leaves, treedef = jax.tree_util.tree_flatten(like_state)
        new_leaves = []
        for i, ref in enumerate(leaves):
            arr = z[f"leaf{i}"]
            if hasattr(ref, "dtype"):
                arr = arr.astype(np.asarray(ref).dtype)
            new_leaves.append(arr)
        step = int(z["__step__"])
    return jax.tree_util.tree_unflatten(treedef, new_leaves), step


def di_cycle_swap(f_r, f_b, buffer_rows: int, top: bool = True):
    """Swap the two fluids inside the buffer layers to reverse the
    displacement direction for the next drainage/imbibition cycle
    (``RKD2Q9.py:550-557``: restart re-seeds the buffer rows with the
    invading fluid).

    Args:
      f_r, f_b: per-color PDFs (9, ny, nx).
      buffer_rows: number of buffer rows at the inlet side.
      top: True when the inlet (invasion side) is the top of the domain.
    """
    import jax.numpy as jnp
    f_r = jnp.asarray(f_r)
    f_b = jnp.asarray(f_b)
    ny = f_r.shape[-2]
    if top:
        sl = slice(ny - buffer_rows, ny)
    else:
        sl = slice(0, buffer_rows)
    new_r = f_r.at[..., sl, :].set(f_b[..., sl, :])
    new_b = f_b.at[..., sl, :].set(f_r[..., sl, :])
    return new_r, new_b


def di_cycle_swap_sc(f, buffer_rows: int, top: bool = True):
    """Shan-Chen variant of the D-I cycle swap: exchange fluid 0 and fluid 1
    inside the buffer rows of the stacked state f (K, 9, ny, nx)
    (``ShanChenD2Q9.py:788-817``: the restart re-seeds the last rows with
    the invading fluid)."""
    import jax.numpy as jnp
    f = jnp.asarray(f)
    ny = f.shape[-2]
    sl = slice(ny - buffer_rows, ny) if top else slice(0, buffer_rows)
    f0 = f[0, :, sl, :]
    f1 = f[1, :, sl, :]
    f = f.at[0, :, sl, :].set(f1)
    f = f.at[1, :, sl, :].set(f0)
    return f
