"""Result output: HDF5 (reference-compatible schema) with npz fallback + PNG.

The reference writes PyTables HDF5 files with per-step arrays
(``SimulationResults.h5``: /FluidMacro/FluidDensityType%gin%g,
/FluidVelocity/FluidVelocity{X,Y}At%g — ``ShanChenD2Q9.resultInHDF5:940-955``;
``SimulationResultsRK.h5``: adds /FluidPDF/FluidPDF{R,B}at%g —
``RKD2Q9.resultInHDF5:938-957``; ``ConcentrationResults.h5``:
/TransportMacro/TracerConcType%gin%g — ``Transport2DRK.py:651-661``) and
matplotlib-Agg PNG snapshots (``ShanChenD2Q9.py:888-938``).

This environment ships neither h5py nor PyTables, so the writer negotiates:
``fmt="h5"`` uses h5py when importable, otherwise ``fmt="npz"`` stores the
same logical keys ("FluidMacro/FluidDensityRin2500") in one npz per step.
Output paths are configurable — the reference hardcodes ``~/LBMResults``
(SURVEY.md section 0); we do not replicate that defect.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["ResultWriter", "save_png_field", "append_series"]


def _h5py():
    try:
        import h5py
        return h5py
    except ImportError:
        return None


class ResultWriter:
    """Per-step field writer with the reference's dataset naming.

    Usage::

        w = ResultWriter("results", basename="SimulationResultsRK")
        w.write(2500, {"FluidMacro/FluidDensityRin2500": rho_r, ...})
        # or the schema helpers:
        w.write_sc(step, rho_k, ux, uy)
        w.write_rk(step, rho_r, rho_b, ux, uy, f_r=None, f_b=None)
        w.write_transport(step, conc)
    """

    def __init__(self, out_dir: str, basename: str = "SimulationResults",
                 fmt: str = "auto"):
        self.out_dir = out_dir
        self.basename = basename
        os.makedirs(out_dir, exist_ok=True)
        if fmt == "auto":
            fmt = "h5" if _h5py() is not None else "npz"
        if fmt == "h5" and _h5py() is None:
            raise RuntimeError("h5py not available; use fmt='npz'")
        self.fmt = fmt

    # ------------------------------------------------------------------
    def write(self, step: int, datasets: dict):
        arrays = {k: np.asarray(v) for k, v in datasets.items()}
        if self.fmt == "h5":
            h5py = _h5py()
            path = os.path.join(self.out_dir, self.basename + ".h5")
            with h5py.File(path, "a") as fh:
                for key, arr in arrays.items():
                    if key in fh:
                        del fh[key]
                    fh.create_dataset(key, data=arr)
        else:
            path = os.path.join(self.out_dir,
                                f"{self.basename}_{step:08d}.npz")
            # uncompressed: zlib runs at a few MB/s on PDF fields whose low
            # bits are noise, minutes per write at 4096^2
            np.savez(path, **{k.replace("/", "__"): v
                              for k, v in arrays.items()})

    def read(self, step: int, key: str):
        """Read one dataset back (testing / restart helper)."""
        if self.fmt == "h5":
            h5py = _h5py()
            path = os.path.join(self.out_dir, self.basename + ".h5")
            with h5py.File(path, "r") as fh:
                return np.asarray(fh[key])
        path = os.path.join(self.out_dir, f"{self.basename}_{step:08d}.npz")
        with np.load(path) as z:
            return z[key.replace("/", "__")]

    # -- schema helpers --------------------------------------------------
    def write_sc(self, step: int, rho_k, ux, uy):
        """Shan-Chen layout (``ShanChenD2Q9.resultInHDF5``)."""
        d = {f"FluidMacro/FluidDensityType{i}in{step}": rho_k[i]
             for i in range(len(rho_k))}
        d[f"FluidVelocity/FluidVelocityXAt{step}"] = ux
        d[f"FluidVelocity/FluidVelocityYAt{step}"] = uy
        self.write(step, d)

    def write_rk(self, step: int, rho_r, rho_b, ux, uy,
                 f_r=None, f_b=None):
        """Color-gradient layout (``RKD2Q9.resultInHDF5``); PDFs make the
        output double as a restart checkpoint, as in the reference."""
        d = {
            f"FluidMacro/FluidDensityRin{step}": rho_r,
            f"FluidMacro/FluidDensityBin{step}": rho_b,
            f"FluidVelocity/FluidVelocityXAt{step}": ux,
            f"FluidVelocity/FluidVelocityYAt{step}": uy,
        }
        if f_r is not None:
            d[f"FluidPDF/FluidPDFRat{step}"] = f_r
            d[f"FluidPDF/FluidPDFBat{step}"] = f_b
        self.write(step, d)

    def write_transport(self, step: int, conc):
        """Transport layout (``Transport2DRK.saveConcentrationHDF5``)."""
        self.write(step, {
            f"TransportMacro/TracerConcType{i}in{step}": conc[i]
            for i in range(len(conc))})


def save_png_field(path: str, field, title: str = "", cmap: str = "viridis",
                   vmin=None, vmax=None):
    """PNG snapshot of a 2D field (Agg backend, like the reference's
    ``plotDensityDistributionOPT``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 5 * field.shape[0] / field.shape[1]))
    im = ax.imshow(np.asarray(field), origin="lower", cmap=cmap,
                   vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax, shrink=0.8)
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def append_series(path: str, step: int, *values):
    """Append a row to a .dat scalar time series (``ContactAngle.dat``
    style, ``ShanChenD2Q9.py:856-861``)."""
    with open(path, "a") as fh:
        fh.write(" ".join([str(step)] + [repr(float(v)) for v in values])
                 + "\n")
