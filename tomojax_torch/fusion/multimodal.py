"""Fused multi-modal (HAADF + chemical) tomography (counterpart of
``tomojax/fusion/multimodal.py``).

Per outer iteration, over all slices and elements at once:

    h       = sigma(x^gamma)                      HAADF model (N, N, Ns)
    g       = A_h h                               its projections
    u       = SIRT_h(h -> b_h, iter_sirt)         HAADF-consistent h
    d_HAADF = gamma x^(gamma-1) sigma^T (u - h)
    Ax      = A_c x ;  d_CHEM = A_c^T((Ax - b_c)/(Ax + eps))
    x      <- max(x - lam_chem/L_Aps d_CHEM + lam_haadf d_HAADF, 0)
    costs: ||g - b_h||_F and sum(Ax - b_c log(Ax + eps)).

Layout: every function here takes and returns the port's slice-last
layouts, not the reference's: element stacks (Nel, N, N, Ns), the HAADF
volume (N, N, Ns), chemistry sinograms (Nel, Na_c, Nt, Ns) and the HAADF
sinogram (Na_h, Nt, Ns). Each element is a contiguous slice-last volume,
so the projector kernels (K1, K2) and the TV kernels (K3, K4, K5) run on
it as they are, one launch per element, and sigma is a weighted sum over
the leading axis; ``solvers.to_sl`` / ``from_sl`` convert from and to the
reference's (Nel, Ns, ...) layout. TV is the same under a permutation of
the three spatial axes (one boundary rule on every axis), so the
per-element TV of the slice-last volume is the reference's.

Slab-sharded runs (counterpart of the reference's fusion under a mesh):
with ``group=`` (a `tomojax_torch.dist.SlabGroup`) every stack holds this
rank's slices of the slice axis, the last one: x (Nel, N, N, n_loc), the
HAADF sinogram (Na_h, Nt, n_loc), the chemistry sinograms (Nel, Na_c, Nt,
n_loc). The data term couples no slices, so the projections, sigma and the
SIRT/SART solvers run on the slab as they are and take no group; the
functions that return a scalar or a maximum over the slices take the group
and all-reduce it (the costs, the per-angle maxima of
`rescale_projections`), and the FGP prox runs on the slabs (K9a/K9b per
element, ``tv.tv_fgp_4d(group=)``). Every rank then reads the same costs,
so the lam_chem decay of `data_fusion_run` takes the same branch on every
rank. `make_fusion_system` needs no collective: both Lipschitz constants
come from one slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tomojax_torch import profiling
from tomojax_torch.dist import SlabGroup, all_reduce_max, all_reduce_sum
from tomojax_torch.fusion.sigma import sigma_apply, sigma_t_apply
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import bp_sirt_sl, bp_sl, fp_sl
from tomojax_torch.solvers.base import System, make_system
from tomojax_torch.solvers.cuda_sart import sart_sweep_sl
from tomojax_torch.solvers.iterative import (
    POISSON_EPS, make_sart_weights, sirt_sweep_sl,
)
from tomojax_torch.tv import tv_fgp_4d, tv_gd_4d

F32 = torch.float32
METHODS = ("sirt", "sart")


@dataclasses.dataclass(frozen=True)
class FusionSystem:
    """The HAADF and chemistry systems, the element weights and the two
    Lipschitz constants (multimodal.cpp:259-265), all on one device."""

    haadf: System
    chem: System
    weights: torch.Tensor  # (Nel,)
    gamma: float
    l_aps: torch.Tensor  # 0-dim: the chemistry path's Lipschitz
    l_asig: torch.Tensor  # 0-dim: the HAADF path's Lipschitz

    @property
    def nel(self) -> int:
        return self.weights.shape[0]


def make_fusion_system(n: int, haadf_angles_rad, chem_angles_rad, weights,
                       gamma: float = 1.6, device="cuda") -> FusionSystem:
    """Both systems on `device`, L_Aps = the chemistry system's Lipschitz
    (the same for every element) and L_ASig = max(w) max(A^T A (sum(w) 1))
    on one HAADF slice (multimodal.cpp:261-264)."""
    device = torch.device(device)
    sh = make_system(Geometry.make(n, haadf_angles_rad), device)
    sc = make_system(Geometry.make(n, chem_angles_rad), device)
    w = torch.tensor(np.asarray(weights, np.float32), device=device)
    sig1 = torch.sum(w) * torch.ones((n, n, 1), dtype=F32, device=device)
    back = bp_sl(fp_sl(sig1, sh.geom), sh.geom)
    return FusionSystem(sh, sc, w, float(gamma), sc.lipschitz,
                        torch.max(w) * torch.max(back))


# ---------------------------------------------------------- projections


def fp4d(x: torch.Tensor, sys: System) -> torch.Tensor:
    """(Nel, N, N, Ns) -> (Nel, Na, Nt, Ns): K1 per element (counted in
    ``element_launches``)."""
    profiling.count("element_launches", x.shape[0])
    return torch.stack([fp_sl(xe, sys.geom) for xe in x])


def bp4d(y: torch.Tensor, sys: System) -> torch.Tensor:
    """(Nel, Na, Nt, Ns) -> (Nel, N, N, Ns): K2 per element (counted in
    ``element_launches``)."""
    profiling.count("element_launches", y.shape[0])
    return torch.stack([bp_sl(ye, sys.geom) for ye in y])


def model_haadf(x: torch.Tensor, fsys: FusionSystem) -> torch.Tensor:
    """h = sigma(x^gamma): (Nel, N, N, Ns) -> (N, N, Ns)
    (multimodal.cpp:427-428); x as it is when gamma = 1, else
    max(x, 0)^gamma."""
    xg = x if fsys.gamma == 1.0 else torch.clamp_min(x, 0.0) ** fsys.gamma
    return sigma_apply(fsys.weights, xg)


# -------------------------------------------------------------- solvers


def _sum(t: torch.Tensor, group: SlabGroup | None) -> torch.Tensor:
    """The sum of `t`, all-reduced over the slabs with a group."""
    s = torch.sum(t)
    return s if group is None else all_reduce_sum(s, group)


def poisson_ml_step_4d(x: torch.Tensor, b_chem: torch.Tensor,
                       fsys: FusionSystem, lam,
                       group: SlabGroup | None = None):
    """The chemistry-only Poisson-ML step and positivity
    (multimodal.cpp:277-304): returns (x, kl_cost), the cost all-reduced
    with a group. The update of each element is K2's epilogue with y = x
    and the constant C = -lam/L_Aps, as
    ``solvers.iterative.poisson_ml_step_sl`` runs it. The step is a
    ``fusion.chem`` span."""
    geom = fsys.chem.geom
    with profiling.annotate("fusion.chem"):
        ax = fp4d(x, fsys.chem)
        ratio = (ax - b_chem) / (ax + POISSON_EPS)
        neg = (-lam / fsys.l_aps).expand(geom.n, geom.n).contiguous()
        profiling.count("element_launches", x.shape[0])
        x_new = torch.stack([bp_sirt_sl(r, geom, xe, neg)
                             for r, xe in zip(ratio, x)])
        cost = _sum(ax - b_chem * torch.log(ax + POISSON_EPS), group)
    return x_new, cost


def chemical_sirt_sweep(x: torch.Tensor, b_chem: torch.Tensor,
                        fsys: FusionSystem, n_iter: int = 1) -> torch.Tensor:
    """ASTRA SIRT of every element on the chemistry geometry
    (multimodal.cpp:365-372)."""
    return torch.stack([sirt_sweep_sl(xe, be, fsys.chem, n_iter)
                        for xe, be in zip(x, b_chem)])


def _sart_sweeps(x, b, sys: System, n_iter: int, sart_weights):
    """`n_iter` sequential SART sweeps (K8), beta 1."""
    dev = x.device
    beta = torch.ones((), dtype=F32, device=dev)
    order = torch.arange(sys.geom.nproj, dtype=torch.int32, device=dev)
    for _ in range(n_iter):
        x = sart_sweep_sl(x, b, sys.geom, sys.inv_row, sart_weights, beta,
                          order)
    return x


def chemical_sart_sweep(x: torch.Tensor, b_chem: torch.Tensor,
                        fsys: FusionSystem, n_iter: int = 1,
                        sart_weights=None) -> torch.Tensor:
    """Ordered sequential SART of every element on the chemistry geometry
    (multimodal.cpp:416-423); sart_weights = make_sart_weights(fsys.chem),
    computed here when omitted."""
    if sart_weights is None:
        sart_weights = make_sart_weights(fsys.chem)
    return torch.stack([_sart_sweeps(xe, be, fsys.chem, n_iter, sart_weights)
                        for xe, be in zip(x, b_chem)])


def data_fusion_step(x: torch.Tensor, b_haadf: torch.Tensor,
                     b_chem: torch.Tensor, fsys: FusionSystem, lam_haadf,
                     lam_chem, iter_sirt: int = 5,
                     normalize_haadf: bool = False, method: str = "sirt",
                     sart_weights=None, group: SlabGroup | None = None):
    """One fused HAADF + chemistry update (multimodal.cpp:452-491).
    Returns (x, cost_haadf, cost_chem), the costs 0-dim tensors (with a
    group over the whole volume: one all-reduce of both sums).

    method 'sirt' runs iter_sirt ASTRA-SIRT iterations from the HAADF model
    h toward b_haadf (K1, K2); 'sart' runs iter_sirt ordered SART sweeps
    (K8; pass sart_weights = make_sart_weights(fsys.haadf) to reuse them).
    normalize_haadf divides the HAADF step by L_ASig (the reference's
    documented deviation; default False is the reference's step).
    lam_chem may be a 0-dim tensor on x's device.
    The HAADF side (h, g, the inner solve, sigma^T and the gamma chain
    rule) is a ``fusion.haadf`` span, the chemistry side (A_c x, the
    Poisson ratio, its backprojection) a ``fusion.chem`` span."""
    if method not in METHODS:
        raise ValueError(f"unknown fusion method {method!r}")
    with profiling.annotate("fusion.haadf"):
        h = model_haadf(x, fsys)
        # the model's projections, before the step
        g = fp_sl(h, fsys.haadf.geom)
        if method == "sart":
            if sart_weights is None:
                sart_weights = make_sart_weights(fsys.haadf)
            u = _sart_sweeps(h, b_haadf, fsys.haadf, iter_sirt,
                             sart_weights)
        else:
            u = sirt_sweep_sl(h, b_haadf, fsys.haadf, iter_sirt)
        d_haadf = sigma_t_apply(fsys.weights, u - h, fsys.nel)
        if fsys.gamma != 1.0:
            d_haadf = (fsys.gamma
                       * torch.clamp_min(x, 0.0) ** (fsys.gamma - 1.0)
                       * d_haadf)
    with profiling.annotate("fusion.chem"):
        ax = fp4d(x, fsys.chem)
        d_chem = bp4d((ax - b_chem) / (ax + POISSON_EPS), fsys.chem)
    h_scale = lam_haadf / fsys.l_asig if normalize_haadf else lam_haadf
    x = torch.clamp_min(x - (lam_chem / fsys.l_aps) * d_chem
                        + h_scale * d_haadf, 0.0)
    sq = torch.sum((g - b_haadf) ** 2)
    cost_chem = torch.sum(ax - b_chem * torch.log(ax + POISSON_EPS))
    if group is not None:
        sq, cost_chem = all_reduce_sum(torch.stack([sq, cost_chem]), group)
    return x, torch.sqrt(sq), cost_chem


def data_fusion_run(x: torch.Tensor, b_haadf: torch.Tensor,
                    b_chem: torch.Tensor, fsys: FusionSystem, lam_haadf,
                    lam_chem0, n_iter: int, iter_sirt: int = 5,
                    tv_iter: int = 5, lam_tv: float = 1e-4,
                    reduce_lambda: bool = True,
                    normalize_haadf: bool = False, method: str = "sirt",
                    sart_weights=None, group: SlabGroup | None = None):
    """`n_iter` outer iterations: the fused step, the per-element FGP and
    the adaptive lam_chem *= 0.95 when the HAADF cost rose
    (chemistry/reconstructor.py:206-209). lam_chem and the previous cost
    are carried as 0-dim device tensors, so the run issues no host read;
    with a group the decision compares the all-reduced HAADF costs, the
    same on every rank. Each iteration is a ``solvers.iteration`` span, as
    in the host loops.
    Returns (x, metrics), metrics the (n_iter, 3) device tensor of
    (cost_haadf, cost_chem, tv) per iteration."""
    if method == "sart" and sart_weights is None:
        sart_weights = make_sart_weights(fsys.haadf)
    lam_chem = torch.as_tensor(lam_chem0, dtype=F32, device=x.device)
    prev = torch.zeros((), dtype=F32, device=x.device)
    metrics = []
    for it in range(n_iter):
        with profiling.annotate("solvers.iteration"):
            x, ch, cc = data_fusion_step(x, b_haadf, b_chem, fsys, lam_haadf,
                                         lam_chem, iter_sirt, normalize_haadf,
                                         method, sart_weights, group)
            x, tv0 = tv_fgp_4d(x, tv_iter, lam_tv, group=group)
            if reduce_lambda and it > 0:
                lam_chem = torch.where(ch > prev, lam_chem * 0.95, lam_chem)
            prev = ch
            metrics.append(torch.stack([ch, cc, tv0]))
    if not metrics:
        return x, torch.zeros((0, 3), dtype=F32, device=x.device)
    return x, torch.stack(metrics)


def rescale_tomograms(x: torch.Tensor, scale) -> torch.Tensor:
    """multimodal.cpp:307-309."""
    return x * scale


def rescale_projections(x: torch.Tensor, b_haadf: torch.Tensor,
                        fsys: FusionSystem,
                        group: SlabGroup | None = None) -> torch.Tensor:
    """Per-angle max matching of the HAADF data to the model
    (multimodal.cpp:312-328): b_a <- b_a / max(b_a) * max(g_a); with a
    group both maxima over every rank's slices (one all-reduce)."""
    g = fp_sl(model_haadf(x, fsys), fsys.haadf.geom)
    bmax = torch.amax(b_haadf, dim=(1, 2), keepdim=True)
    gmax = torch.amax(g, dim=(1, 2), keepdim=True)
    if group is not None:
        bmax, gmax = all_reduce_max(torch.stack([bmax, gmax]), group)
    return b_haadf / torch.clamp_min(bmax, 1e-30) * gmax


def data_distance_chem(x: torch.Tensor, b_chem: torch.Tensor,
                       fsys: FusionSystem,
                       group: SlabGroup | None = None) -> torch.Tensor:
    """||A_c x - b_c||_F over all elements (multimodal.cpp:213-223), over
    every rank's slices with a group."""
    return torch.sqrt(_sum((fp4d(x, fsys.chem) - b_chem) ** 2, group))


__all__ = ["FusionSystem", "make_fusion_system", "fp4d", "bp4d",
           "model_haadf", "poisson_ml_step_4d", "chemical_sirt_sweep",
           "chemical_sart_sweep", "data_fusion_step", "data_fusion_run",
           "rescale_tomograms", "rescale_projections", "data_distance_chem",
           "tv_fgp_4d", "tv_gd_4d"]
