"""`TomoTorch.asd_pocs`: SART sweeps and TV descent from the host
series."""

from benchmark.reference import plain, sinogram, volume


def run(inp: dict, solvers: dict, device, dt) -> dict:
    kw = solvers["asd_pocs"]
    angles, series = inp["angles"], inp["series"]
    b = sinogram(series, device, dt)
    s = plain.make_system(plain.make_geom(series.shape[1], angles), device,
                          dt)
    w_a = plain.sart_weights(s)
    x, dd, tv = plain.asd_pocs(
        b, s, w_a, kw["Niter"], kw["eps"], kw["beta0"], kw["beta_reduce"],
        kw["r_max"], kw["nTViter"], kw["alpha"], kw["alpha_reduce"])
    return {"recon": volume(x), "dd_vec": dd, "tv_vec": tv}
