"""`TomoTorch(angles, tilt_series)`: one HAADF tilt series."""


def make(inp: dict, kw: dict, device):
    from tomojax_torch import TomoTorch
    return TomoTorch(inp["angles"], inp["series"], device=device, **kw)
