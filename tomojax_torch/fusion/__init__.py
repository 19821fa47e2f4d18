"""Fused multi-modal chemical tomography (counterpart of
``tomojax.fusion``), in the port's slice-last layouts
(``fusion/multimodal.py``)."""

from tomojax_torch.fusion.sigma import (
    PERIODIC_TABLE,
    element_weights,
    weights_for_elements,
    sigma_apply,
    sigma_t_apply,
)
from tomojax_torch.fusion.multimodal import (
    FusionSystem,
    make_fusion_system,
    fp4d,
    bp4d,
    model_haadf,
    poisson_ml_step_4d,
    chemical_sirt_sweep,
    chemical_sart_sweep,
    data_fusion_step,
    data_fusion_run,
    rescale_tomograms,
    rescale_projections,
    data_distance_chem,
)

__all__ = [
    "PERIODIC_TABLE",
    "element_weights",
    "weights_for_elements",
    "sigma_apply",
    "sigma_t_apply",
    "FusionSystem",
    "make_fusion_system",
    "fp4d",
    "bp4d",
    "model_haadf",
    "poisson_ml_step_4d",
    "chemical_sirt_sweep",
    "chemical_sart_sweep",
    "data_fusion_step",
    "data_fusion_run",
    "rescale_tomograms",
    "rescale_projections",
    "data_distance_chem",
]
