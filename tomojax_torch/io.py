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

The reference's sharded checkpoints (`save_sharded`, `load_sharded`)
write orbax/tensorstore shards; here each rank of a
`tomojax_torch.dist.SlabGroup` writes its slabs with `torch.save` into one
file of a directory and rank 0 a small JSON manifest, and a load cuts the
saved slabs anew for the loading group. Neither needs h5py.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tomojax_torch.dist import slab


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


# ------------------------------------------- sharded (slab-parallel) I/O --

_MANIFEST = "manifest.json"


def _shard_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"shard_{rank:05d}.pt")


def save_sharded(directory: str, arrays: Dict[str, torch.Tensor],
                 group=None):
    """Sharded checkpoint of slab tensors (the reference's orbax save; its
    MPI version writes parallel HDF5 hyperslabs): every rank writes its
    slabs to ``shard_<rank>.pt`` (on the CPU, with `torch.save`) and rank
    0 writes ``manifest.json``: the world size, the slab axis (0, the
    slice axis of the public layout) and each array's global shape and
    dtype.

    With a group (a `tomojax_torch.dist.SlabGroup`) it is a collective:
    every rank passes slabs of the same shapes, and the call returns when
    every file is written. Without one the arrays are whole (a world of
    one rank)."""
    rank, size = (0, 1) if group is None else (group.rank, group.size)
    os.makedirs(directory, exist_ok=True)
    slabs = {k: v.detach().cpu().contiguous() for k, v in arrays.items()}
    torch.save(slabs, _shard_path(directory, rank))
    if rank == 0:
        meta = {"world_size": size, "axis": 0, "arrays": {
            k: {"shape": [v.shape[0] * size, *v.shape[1:]],
                "dtype": str(v.dtype).removeprefix("torch.")}
            for k, v in slabs.items()}}
        tmp = os.path.join(directory, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(directory, _MANIFEST))
    if size > 1:
        dist.barrier()


def load_sharded(directory: str, group=None,
                 length: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's slab of every array that `save_sharded` wrote, on the
    group's device (without a group: the whole arrays, on the CPU). Only
    the files that overlap the slab are read, so a group of another size
    than the one that saved restores its own cut of the arrays, as orbax
    restores to a new sharding.

    length: the slab axis' length to restore (default: the saved one). The
    saved axis is first cut, or zero-padded at its high end, to `length`,
    which must divide by the group size."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        meta = json.load(f)
    saved, axis = meta["world_size"], meta["axis"]
    size = 1 if group is None else group.size
    device = torch.device("cpu") if group is None else group.device
    files = {}

    def saved_slab(r: int, name: str) -> torch.Tensor:
        if r not in files:
            files[r] = torch.load(_shard_path(directory, r),
                                  map_location="cpu", weights_only=True)
        return files[r][name]

    out = {}
    for name, info in meta["arrays"].items():
        shape, total = info["shape"], info["shape"][axis]
        n = total if length is None else length
        if n % size:
            raise ValueError(f"{name}: a slab axis of {n} does not divide "
                             f"into {size} slabs")
        s = slab(n, group)
        lo, hi = s.lo, s.lo + s.n
        end = min(hi, total)  # [lo, end) comes from the files
        s_loc = total // saved
        parts = []
        for r in range(lo // s_loc, math.ceil(end / s_loc) if end > lo
                       else lo // s_loc):
            a, b = max(lo, r * s_loc), min(end, (r + 1) * s_loc)
            parts.append(torch.narrow(saved_slab(r, name), axis,
                                      a - r * s_loc, b - a))
        pad = list(shape)
        pad[axis] = hi - max(lo, end)
        parts.append(torch.zeros(pad, dtype=getattr(torch, info["dtype"])))
        out[name] = torch.cat(parts, dim=axis).to(device)
    return out
