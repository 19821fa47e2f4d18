"""Projector launches the fusion's per-element loops make a step, over
whole ChemicalTomo jobs: the program's ``element_launches`` counted in
the traced window (each K1 or K2 call of ``fp4d``, ``bp4d`` and of
Poisson-ML's per-element update, tomojax_torch.fusion.multimodal), over
its ``fusion.chem`` spans (one a Poisson-ML step or a fused step's
chemistry side). 2 Nel while each element takes a launch of its own each
way; 2 once one launch covers the element stack. None where no such span
was recorded (a port without them)."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    return (None if got is None
            else spans.per_span(got, "element_launches", "fusion.chem"))
