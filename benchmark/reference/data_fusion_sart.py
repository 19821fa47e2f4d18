"""`ChemicalTomo.chemical_tomography` then `data_fusion(method="sart")`:
as ``reference/data_fusion.py``, with the fused loop's inner HAADF solver
an ordered SART pass (beta 1, the angles in order) run iterSIRT times
from the HAADF model (multimodal.cpp:425-491, ``call_sart_data_fusion``).

`data_fusion` below is a copy of ``plain.data_fusion``'s loop with only
the inner solver swapped: ``plain.data_fusion`` runs SIRT and is frozen,
so the SART fusion has a loop of its own here. Every step it takes is
one of ``plain``'s, at the data type of the tensors it is given. Matrix
products in TF32 are off while it runs, so that the float32 reference is
float32.
"""

import numpy as np
import torch

from benchmark.reference import PERIODIC_Z, plain, sinogram, volume


def data_fusion(x, b_haadf, b_chem, fs: plain.Fusion, n_iter: int,
                lam_haadf: float, lam_chem: float, lam_tv: float,
                iter_sart: int, tv_iter: int):
    """The rescaling, then the fused loop with the host-side lam_chem
    decay, `iter_sart` SART sweeps from h a fused iteration. Returns (x,
    costHAADF, costCHEM, costTV)."""
    oh, oc = fs.haadf.op, fs.chem.op
    nel = x.shape[0]
    w_a = plain.sart_weights(fs.haadf)
    x = x * 10.0
    gmod = oh.fp(plain._model(x, fs))
    b_haadf = (b_haadf / torch.clamp_min(
        torch.amax(b_haadf, dim=(1, 2), keepdim=True), 1e-30)
        * torch.amax(gmod, dim=(1, 2), keepdim=True))
    m = np.zeros((n_iter, 3))
    for i in range(n_iter):
        h = plain._model(x, fs)
        gmod = oh.fp(h)
        u = h
        for _ in range(iter_sart):
            u = plain.sart_sweep(u, b_haadf, fs.haadf, w_a, 1.0)
        d_h = fs.w.reshape(nel, 1, 1, 1) * (u - h)[None]
        d_h = fs.gamma * torch.clamp_min(x, 0.0) ** (fs.gamma - 1.0) * d_h
        d_c, cc = [], 0.0
        for e in range(nel):
            ax = oc.fp(x[e])
            d_c.append(oc.bp((ax - b_chem[e]) / (ax + plain.POISSON_EPS)))
            cc += float(torch.sum(ax - b_chem[e]
                                  * torch.log(ax + plain.POISSON_EPS)))
        x = torch.clamp_min(x - (lam_chem / fs.l_aps) * torch.stack(d_c)
                            + lam_haadf * d_h, 0.0)
        ch = plain._norm(gmod - b_haadf)
        tv0 = sum(float(plain.tv_value(x[e])) for e in range(nel))
        x = torch.stack([plain.fgp(x[e], tv_iter, lam_tv)
                         for e in range(nel)])
        m[i] = ch, cc, tv0
        if i > 0 and m[i, 0] > m[i - 1, 0]:
            lam_chem *= 0.95
    return x, m[:, 0], m[:, 1], m[:, 2]


def run(inp: dict, solvers: dict, device, dt) -> dict:
    kw = solvers["data_fusion"]
    if kw.get("method") != "sart":
        raise ValueError(f"this reference fuses with SART only, not "
                         f"method {kw.get('method')!r}")
    haadf, chem = inp["haadf"], inp["chem"]
    n = haadf.shape[1]
    ct, kc = solvers["ChemicalTomo"], solvers["chemical_tomography"]

    def norm(a):
        a = np.maximum(np.asarray(a, np.float32), 0)
        return a / max(a.max(), 1e-30)

    elements = list(chem)
    z = np.asarray([PERIODIC_Z[e.lower()] for e in elements], np.float64)
    if ct["sigmaMethod"] != 3:
        raise ValueError("the reference weighs the elements by z / sum(z) "
                         "(sigma method 3) only")
    w = (z / z.sum()).astype(np.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fs = plain.make_fusion(n, inp["haadf_angles"], inp["chem_angles"],
                               w, ct["gamma"], device, dt)
        b_h = sinogram(norm(haadf), device, dt)
        b_c = torch.stack([sinogram(norm(chem[e]), device, dt)
                           for e in elements])
        x, _ = plain.chemical_tomography(b_c, fs, kc["Niter"],
                                         kc["lambdaCHEM"])
        x, ch, cc, tv = data_fusion(
            x, b_h, b_c, fs, kw["Niter"], kw["lambdaHAADF"],
            kw["lambdaCHEM"], kw["lambdaTV"], kw["iterSIRT"], kw["tvIter"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"recon": volume(x), "costHAADF": ch, "costCHEM": cc,
            "costTV": tv}
