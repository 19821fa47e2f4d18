"""`ChemicalTomo(haadf, haadf_angles, chem, chem_angles)`: a HAADF series
fused with one chemical series per element."""


def make(inp: dict, kw: dict, device):
    from tomojax_torch import ChemicalTomo
    return ChemicalTomo(inp["haadf"], inp["haadf_angles"], inp["chem"],
                        inp["chem_angles"], device=device, **kw)
