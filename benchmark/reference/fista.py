"""`TomoTorch.fista`: FISTA-TV from the host series."""

from benchmark.reference import plain, sinogram, volume


def run(inp: dict, solvers: dict, device, dt) -> dict:
    kw = solvers["fista"]
    angles, series = inp["angles"], inp["series"]
    b = sinogram(series, device, dt)
    s = plain.make_system(plain.make_geom(series.shape[1], angles), device,
                          dt)
    x, cost = plain.fista(b, s, kw["lambda_param"], kw["Niter"],
                          kw["nTViter"])
    return {"recon": volume(x), "cost": cost}
