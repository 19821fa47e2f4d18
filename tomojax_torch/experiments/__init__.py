"""Experiment drivers of the port: the counterparts of the reference's
``scripts/exp_*.py``, each asking a question about the projector or the
SART sweep on the card.

    python -m tomojax_torch.experiments.<name> [n] [ns] [--device cpu]

with <name> one of hat_model, projector_variants, projector_variants2,
pair_fp, sart_pipeline, sart_ablate. Their kernels are E1/E2
(``cuda_projector_variants``) and E3/E4 (``cuda_sart_variants``); the
timing helpers are in ``timing``.
"""
