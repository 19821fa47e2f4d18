"""Compatibility helpers mirroring the reference's `pytvlib` modules
(counterpart of ``tomojax/pytvlib.py``).

Name-based algorithm dispatch, the filter and order lists, the device
check, and the data loaders and HDF5 savers, on top of ``TomoTorch`` and
``tomojax_torch.io``, so that driver scripts written against the
reference port mechanically. The dispatch is the reference's as it is,
including ``"fista"``, which runs SIRT (tomojax/pytvlib.py:53).
"""

from __future__ import annotations

import torch

from tomojax_torch import io as _io
from tomojax_torch.projector.filters import FILTERS

# ------------------------------------------------------ dispatch ----------

_ALG_ALIASES = {
    "sirt": "sirt",
    "cgls": "cgls",
    "fista": "fista",
    "poisson_ml": "kl_divergence",
    "kl-divergence": "kl_divergence",
    "sart": "sart",
    "asd-pocs": "asd_pocs",
    "fbp": "wbp",
    "wbp": "wbp",
    "art": "art",
    "randart": "randart",
    "cimminosirt": "cimmino_sirt",
}


def initialize_algorithm(tomo, alg: str, init_alg: str = ""):
    """Name-based dispatch (the reference's tomofusion/pytvlib.py:5-19).
    The reconstructors fuse initialise and run, so this only checks the
    name and keeps the sub-option (SART order or FBP filter) for `run`."""
    key = alg.lower()
    if key not in _ALG_ALIASES:
        raise ValueError(f"unknown algorithm {alg!r}")
    tomo._alg = _ALG_ALIASES[key]
    tomo._alg_opt = init_alg
    return tomo


def run(tomo, alg: str, beta: float = 1.0, niter: int = 1, **kw):
    """Run `niter` iterations of the named algorithm on a TomoTorch (every
    alias `initialize_algorithm` takes). As in the reference, "fista" runs
    SIRT, beta is the relaxation of SART and ART, beta0 of ASD-POCS and
    the lambda of Poisson-ML, and the SART order or the FBP filter comes
    from `initialize_algorithm`'s init_alg."""
    key = _ALG_ALIASES[alg.lower()]
    opt = getattr(tomo, "_alg_opt", "")
    if key == "sirt" or key == "fista":
        return tomo.sirt(Niter=niter, show_convergence=False)
    if key == "cimmino_sirt":
        return tomo.sirt(Niter=niter, show_convergence=False,
                         variant="cimmino")
    if key == "cgls":
        return tomo.cgls(Niter=niter, show_convergence=False)
    if key == "sart":
        return tomo.sart(Niter=niter, init=opt or "sequential", beta=beta,
                         show_convergence=False)
    if key == "art":
        return tomo.art(Niter=niter, beta=beta, show_convergence=False)
    if key == "randart":
        return tomo.art(Niter=niter, beta=beta, random_order=True,
                        show_convergence=False)
    if key == "asd_pocs":
        return tomo.asd_pocs(Niter=niter, beta0=beta)
    if key == "kl_divergence":
        return tomo.kl_divergence(Niter=niter, lambda_param=beta)
    if key == "wbp":
        return tomo.wbp(opt or "ram-lak")
    raise ValueError(f"run() does not handle {alg!r}")


def wbp_filters():
    """The supported FBP filter bank (without "none")."""
    return [f for f in FILTERS if f != "none"]


def sart_orders():
    return ["sequential", "random"]


def check_cuda():
    """The CUDA devices torch finds (the reference's own `check_cuda`,
    its pytvlib.py:42-51); raises where there is none. The CPU is never
    offered: pass device="cpu" to the reconstructors to run their plain
    versions."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# ------------------------------------------------------ io shims ----------


def load_h5_data(vol_size, file_name, dir: str = "Tilt_Series/"):
    """The reference's cpu/utils/pytvlib.py:132-145 layout: returns (name,
    angles_deg, tilt_series)."""
    full = f"{vol_size}_{file_name}" if vol_size else file_name
    series, angles = _io.load_h5_data(dir + full)
    return (file_name.replace(".h5", ""), angles, series)


def load_data(vol_size, file_name, dir: str = "Tilt_Series/"):
    """tiff/npy loader with the reference's axis swap (its
    pytvlib.py:147-169): returns (name, tilt_series)."""
    series = _io.load_tilt_series(dir + vol_size + file_name)
    for suffix in ("_tiltser.tiff", "_tiltser.tif", "_tiltser.npy"):
        file_name = file_name.replace(suffix, "")
    return (file_name, series)


def save_results(fname, meta, results, tomo=None, save_recon: bool = False):
    """The reference's pytvlib.py:97-139 layout: results/<name>/<alg>.h5
    under the working directory; returns the path."""
    path = f"results/{fname[0]}/{fname[1]}.h5"
    recon = tomo.get_recon() if (save_recon and tomo is not None) else None
    _io.save_results(path, meta, results, recon)
    return path
