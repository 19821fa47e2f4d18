"""`DynamicReconstructor.iterate_cs`: one streaming round from the state
the program held before it: x (Nslice, N, N) or None (zeros), dpocs, the
angles so far and their images (k, Nslice, Nray). A round from zero
returns its volume as ``recon_first``, any other as ``recon``."""

import numpy as np
import torch

from benchmark.reference import plain, volume


def run(inp: dict, solvers: dict, device, dt) -> dict:
    kw = solvers["iterate_cs"]
    images = np.asarray(inp["images"], np.float32)
    b = torch.as_tensor(np.ascontiguousarray(images.transpose(0, 2, 1)))
    b = b.to(device=device, dtype=dt)
    n = images.shape[2]
    s = plain.make_system(plain.make_geom(n, inp["angles"]), device, dt)
    if inp["x"] is None:
        x = torch.zeros((n, n, images.shape[1]), dtype=dt, device=device)
    else:
        x = torch.as_tensor(inp["x"]).to(device=device,
                                         dtype=dt).movedim(0, -1)
    x, dd, _ = plain.cs_round(x, inp["dpocs"], b, s, kw["n_iter"], kw["ng"],
                              kw["alpha"], kw["alpha_red"], kw["r_max"],
                              kw["eps"])
    vol = "recon_first" if inp["x"] is None else "recon"
    return {vol: volume(x), "dd": np.asarray([dd])}
