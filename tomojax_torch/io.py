"""I/O: tilt-series loaders, HDF5 results and checkpoint files
(counterpart of ``tomojax/io.py``; numpy code, copied).

The reference's conventions, so that files interchange with it:
  * `load_h5_data`: h5 files with `tiltSeries` + `tiltAngles` datasets;
  * `save_results`: HDF5 with a `parameters` group of hyperparameter
    attrs, a `results` group of convergence curves and a
    `Reconstruction/recon` dataset;
  * checkpoint/resume for dynamic experiments (recon + dd/tv history).

Arrays are numpy, in the reference's layouts (recon (Nslice, Nray,
Nray)). h5py and PIL are imported inside the functions that need them.
The reference's orbax-sharded checkpoints (`save_sharded`,
`load_sharded`) are JAX-only and are not ported here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ loaders -----


def load_h5_data(path: str, series_key: str = "tiltSeries",
                 angles_key: str = "tiltAngles"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tilt_series (Nslice, Nray, Nangles), angles_deg)."""
    import h5py

    with h5py.File(path, "r") as f:
        series = np.asarray(f[series_key], np.float32)
        angles = np.asarray(f[angles_key], np.float64)
    return series, angles


def load_tilt_series(path: str) -> np.ndarray:
    """tiff/npy loaders with the reference's axis convention
    (its cpu/utils/pytvlib.py:147-169: tiff stacks arrive (z,y,x) and are
    swapped to put the tilt axis first)."""
    if path.endswith((".npy",)):
        return np.load(path).astype(np.float32)
    if path.endswith((".tif", ".tiff")):
        from PIL import Image

        im = Image.open(path)
        frames = []
        for k in range(getattr(im, "n_frames", 1)):
            im.seek(k)
            frames.append(np.asarray(im, np.float32))
        arr = np.stack(frames)
        return np.swapaxes(arr, 0, 2)
    raise ValueError(f"unsupported tilt-series file: {path}")


# ------------------------------------------------------------- savers -----


def save_results(
    path: str,
    meta: Optional[Dict] = None,
    results: Optional[Dict] = None,
    recon: Optional[np.ndarray] = None,
):
    """The reference's results-file layout (its pytvlib.py:120-139)."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        if meta:
            params = f.create_group("parameters")
            for key, item in meta.items():
                params.attrs[key] = item
        if results:
            conv = f.create_group("results")
            for key, item in results.items():
                conv.create_dataset(key, dtype=np.float32,
                                    data=np.asarray(item))
        if recon is not None:
            recon = np.asarray(recon)
            grp = f.create_group("Reconstruction")
            grp.create_dataset("recon", dtype=np.float32, data=recon)
            grp.attrs["Nslice"] = recon.shape[0]
            grp.attrs["Nray"] = recon.shape[1]


def load_results(path: str):
    """Returns (recon or None, results dict, parameters dict)."""
    import h5py

    with h5py.File(path, "r") as f:
        recon = None
        if "Reconstruction" in f:
            recon = np.asarray(f["Reconstruction"]["recon"], np.float32)
        results = {}
        if "results" in f:
            results = {k: np.asarray(v) for k, v in f["results"].items()}
        params = {}
        if "parameters" in f:
            params = dict(f["parameters"].attrs)
    return recon, results, params


# -------------------------------------------- checkpoint / resume ---------


def save_checkpoint(path: str, recon, history: Dict,
                    params: Optional[Dict] = None):
    """Dynamic-experiment checkpoint (the reference's logger.py:216-233):
    recon + metric history, resumable mid-acquisition. recon=None writes a
    history-only sidecar."""
    save_results(
        path, meta=params or {}, results=history,
        recon=None if recon is None else np.asarray(recon),
    )


def load_checkpoint(path: str):
    recon, results, params = load_results(path)
    return recon, results, params
