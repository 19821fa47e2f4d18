"""`ChemicalTomo.chemical_tomography` then `data_fusion`: the HAADF series
and the chemistry series of each element, clamped to >= 0 and normalised
to max 1, the element weights z / sum(z), the Poisson-ML loop, then the
fused loop."""

import numpy as np
import torch

from benchmark.reference import PERIODIC_Z, plain, sinogram, volume


def run(inp: dict, solvers: dict, device, dt) -> dict:
    haadf, chem = inp["haadf"], inp["chem"]
    n = haadf.shape[1]
    ct, kc = solvers["ChemicalTomo"], solvers["chemical_tomography"]
    kw = solvers["data_fusion"]

    def norm(a):
        a = np.maximum(np.asarray(a, np.float32), 0)
        return a / max(a.max(), 1e-30)

    elements = list(chem)
    z = np.asarray([PERIODIC_Z[e.lower()] for e in elements], np.float64)
    if ct["sigmaMethod"] != 3:
        raise ValueError("the reference weighs the elements by z / sum(z) "
                         "(sigma method 3) only")
    w = (z / z.sum()).astype(np.float32)
    fs = plain.make_fusion(n, inp["haadf_angles"], inp["chem_angles"], w,
                           ct["gamma"], device, dt)
    b_h = sinogram(norm(haadf), device, dt)
    b_c = torch.stack([sinogram(norm(chem[e]), device, dt)
                       for e in elements])
    x, _ = plain.chemical_tomography(b_c, fs, kc["Niter"],
                                     kc["lambdaCHEM"])
    x, ch, cc, tv = plain.data_fusion(
        x, b_h, b_c, fs, kw["Niter"], kw["lambdaHAADF"], kw["lambdaCHEM"],
        kw["lambdaTV"], kw["iterSIRT"], kw["tvIter"])
    return {"recon": volume(x), "costHAADF": ch, "costCHEM": cc,
            "costTV": tv}
