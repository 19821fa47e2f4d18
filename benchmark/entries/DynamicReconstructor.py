"""`DynamicReconstructor(**kw)`: a streaming reconstructor that tilts are
handed to one at a time (it takes no inputs at construction)."""


def make(inp, kw: dict, device):
    from tomojax_torch import DynamicReconstructor
    return DynamicReconstructor(device=device, **kw)
