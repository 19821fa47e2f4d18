"""Angles a group of K1's blocks shares over whole reconstruction jobs:
the program's ``fp_angles`` over its ``fp_groups``, both counted in the
traced window (each K1 launch, tomojax_torch.projector.cuda_joseph.fp_sl
and fp_resid_sl, counts the angles it projects and its plan's angle
groups). A group stages its own window of x, so the fewer angles a group
holds, the more often K1 reads the volume for each angle. None where no
span carries the counts (a port without them)."""

from benchmark import spans


def read(ctx):
    got = spans.window_spans(ctx)
    if got is None:
        return None
    groups = sum(s.counts.get("fp_groups", 0) for s in got)
    if not groups:
        return None
    return sum(s.counts.get("fp_angles", 0) for s in got) / groups
