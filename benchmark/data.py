"""The inputs of a cell, made from the seed on the device.

The volume is the configuration's phantom (``phantoms/<kind>.py``, found
by the name its ``phantom`` gives), filled on the device. The tilt
series are its projections by the benchmark's own plain projector
(``reference.plain.Operator``), with Poisson noise drawn on the device from a
``torch.Generator`` seeded with ``--seed``: counts at a mean level of
``snr`` (scale = snr * size / sum, the repository's definition), scaled
back. A cell makes ``draws`` noise draws of every series; jobs cycle
through them, so no two consecutive jobs see the same input. The
phantom, the sizes and the angles are the same for every seed.

The series go to the host as the program's users hand them over:
(Nslice, Nray, Nangles) float32 numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import found
from benchmark.reference import PERIODIC_Z, plain


def angles(spec: dict) -> np.ndarray:
    return np.linspace(spec["start"], spec["stop"], spec["num"])


def _project(vols: list, angles_deg) -> list:
    """Each (Ns, N, N) volume -> its slice-last sinogram (Na, Nt, Ns),
    float32."""
    op = plain.Operator(plain.make_geom(vols[0].shape[1], angles_deg),
                        vols[0].device, torch.float32)
    return [op.fp(v.permute(1, 2, 0).contiguous()) for v in vols]


def _noisy(b: torch.Tensor, snr: float, gen: torch.Generator):
    scale = snr * b.numel() / float(torch.sum(b.double()))
    return torch.poisson(b * scale, generator=gen) / scale


def _series(b_sl: torch.Tensor) -> np.ndarray:
    """Slice-last (Na, Nt, Ns) -> host (Nslice, Nray, Nangles)."""
    return np.ascontiguousarray(b_sl.permute(2, 1, 0).cpu().numpy())


def make(cfg: dict, seed: int, draws: int, device,
         bench=found.HERE) -> list:
    """`draws` input sets of the configuration: for a single series
    {"angles", "series"}; for a fusion configuration {"haadf",
    "haadf_angles", "chem", "chem_angles"}."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ns, n = cfg["nslice"], cfg["n"]
    ph = cfg["phantom"]
    phantom = found.module("phantoms", ph["kind"], bench).make(ph, ns, n, device)
    sers = cfg["series"]
    if "elements" not in cfg:
        vol = phantom
        s = sers["haadf"]
        if s.get("background") is not None:
            vol = torch.where(vol == 0, float(s["background"]), vol)
        ang = angles(s["angles"])
        clean, = _project([vol], ang)
        return [{"angles": ang, "series": _series(_noisy(clean, s["snr"],
                                                         gen))}
                for _ in range(draws)]
    els = cfg["elements"]
    gt = phantom
    z = np.asarray([PERIODIC_Z[e.lower()] for e in els], np.float64)
    w = torch.as_tensor(z / z.sum(), dtype=torch.float32, device=device)
    model = torch.tensordot(w, gt ** cfg["gamma"], dims=1)
    sh, sc = sers["haadf"], sers["chem"]
    ang_h, ang_c = angles(sh["angles"]), angles(sc["angles"])
    clean_h, = _project([model], ang_h)
    clean_c = _project(list(gt), ang_c)
    out = []
    for _ in range(draws):
        out.append({
            "haadf": _series(_noisy(clean_h, sh["snr"], gen)),
            "haadf_angles": ang_h,
            "chem": {e: _series(_noisy(c, sc["snr"], gen))
                     for e, c in zip(els, clean_c)},
            "chem_angles": ang_c,
        })
    return out
