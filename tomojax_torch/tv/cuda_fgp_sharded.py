"""FGP TV prox on a z-slab of a sharded volume: kernels K9a, K9b and their
plain PyTorch versions (counterpart of ``tomojax/tv/pallas_fgp_sharded.py``).

Each rank runs the fused FGP iteration on its slab and swaps one plane per
dual field and direction with its neighbours before every iteration, the
traffic of the reference's MPI halo ring (mpi_astra_ctvlib.cpp:360-386).
The slab is slice-last (N, N, n_loc), so the slab axis is axis 2 and its
dual is P3 (the JAX kernels shard axis 0 and P1: FGP does not change under
a permutation of the axes).

* K9a ``fgp_iter_halo`` (``csrc/fgp.cu`` ``fgp_iter_kernel<T, true>``):
  one FGP iteration on the slab. The axis-2 neighbour of the last slice is
  the right rank's first slice (x, P1, P2, P3); P3 below the first slice is
  the left rank's last slice, zeros on rank 0. The top rank has no right
  halo: its forward difference at the last slice is 0.
* K9b ``fgp_obj_halo`` (``fgp_obj_kernel<T, MOM, true>``): the final
  d = max(x - lam div P, 0) with the left P3 halo, with K4's optional
  Nesterov epilogue y = d + beta (d - x_old).

The kernels share K3's and K4's bodies, so a slab chain computes bit for
bit what K3/K4 compute on the whole volume. The plain versions pad the
slab with its halo planes and run K3's and K4's plain versions. Dual halos
travel in the dual dtype, as ``lax.ppermute`` moves them. The wrappers run
the plain versions only for CPU tensors; on CUDA tensors they launch the
kernel or raise. Launches are counted in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build, profiling
from tomojax_torch import config
from tomojax_torch.dist import SlabGroup, halo_exchange
from tomojax_torch.tv.cuda_fgp import (
    F32, _check_duals, fgp_iter_ref, fgp_obj_mom_ref,
)


def _ext(t: torch.Tensor, lo: torch.Tensor | None, hi=None):
    """`t` with the planes `lo` / `hi` (zeros for None) before and after
    its slices on axis 2."""
    lo = torch.zeros_like(t[:, :, :1]) if lo is None else lo[:, :, None]
    parts = [lo, t] if hi is None else [lo, t, hi[:, :, None]]
    return torch.cat(parts, dim=2)


def fgp_iter_halo_ref(x, p1, p2, p3, lam: float, p3_lo, hi=None):
    """Plain K9a: the slab's duals after one FGP iteration, in p1's dtype.

    p3_lo: (n0, n1) P3 plane below slice 0 (zeros on rank 0). hi: the right
    rank's first slice as planes (x_hi, p1_hi, p2_hi, p3_hi), or None on
    the top rank."""
    n2 = x.shape[2]
    hx, h1, h2, h3 = (None,) * 4 if hi is None else hi
    q = fgp_iter_ref(_ext(x, None, hx), _ext(p1, None, h1),
                     _ext(p2, None, h2), _ext(p3, p3_lo, h3), lam)
    return tuple(t[:, :, 1:n2 + 1].contiguous() for t in q)


def fgp_obj_halo_ref(x, p1, p2, p3, lam: float, p3_lo, x_old=None,
                     beta=None):
    """Plain K9b: ``(d, y)`` of the slab, P3 below slice 0 from p3_lo; y as
    K4 gives it (None without momentum)."""
    mom = None if x_old is None else _ext(x_old, None)
    d, y = fgp_obj_mom_ref(_ext(x, None), _ext(p1, None), _ext(p2, None),
                           _ext(p3, p3_lo), lam, mom, beta)
    return (d[:, :, 1:].contiguous(),
            None if y is None else y[:, :, 1:].contiguous())


def _check_plane(t, name, x, dtype):
    _build.check_operand(t, name, x.shape[:2], dtype)


def fgp_iter_halo(x, p1, p2, p3, lam: float, p3_lo, hi=None):
    """K9a: as `fgp_iter_halo_ref` says. Every plane is a contiguous
    (n0, n1) tensor: x_hi float32, the duals' planes in the duals' dtype."""
    _check_duals(x, p1, p2, p3)
    _check_plane(p3_lo, "p3_lo", x, p1.dtype)
    halo = () if hi is None else tuple(hi)
    if hi is not None:
        for name, t, dt in zip(("x_hi", "p1_hi", "p2_hi", "p3_hi"), halo,
                               (F32, p1.dtype, p1.dtype, p1.dtype)):
            _check_plane(t, name, x, dt)
    if _build.on_cpu(x, p1, p2, p3, p3_lo, *halo):
        return fgp_iter_halo_ref(x, p1, p2, p3, lam, p3_lo, hi)
    q1, q2, q3 = (torch.empty_like(p1) for _ in range(3))
    hp = [None] * 4 if hi is None else [t.data_ptr() for t in halo]
    n0, n1, n2 = x.shape
    _build.check(_build.lib().tj_fgp_iter_halo(
        x.data_ptr(), p1.data_ptr(), p2.data_ptr(), p3.data_ptr(),
        q1.data_ptr(), q2.data_ptr(), q3.data_ptr(), p3_lo.data_ptr(), *hp,
        n0, n1, n2, int(p1.dtype == torch.bfloat16), float(lam),
        1.0 / (26.0 * float(lam)), _build.stream()), "tj_fgp_iter_halo")
    fgp_iter_halo.launches += 1
    return q1, q2, q3


def fgp_obj_halo(x, p1, p2, p3, lam: float, p3_lo, x_old=None, beta=None):
    """K9b: ``(d, y)`` as `fgp_obj_halo_ref` says; x_old (x's shape) and
    beta (0-dim float32, read on the device) come together."""
    _check_duals(x, p1, p2, p3)
    _check_plane(p3_lo, "p3_lo", x, p1.dtype)
    if (x_old is None) != (beta is None):
        raise ValueError("x_old and beta come together")
    mom = () if x_old is None else (x_old, beta)
    if x_old is not None:
        _build.check_operand(x_old, "x_old", x.shape, F32)
        _build.check_operand(beta, "beta", (), F32)
    if _build.on_cpu(x, p1, p2, p3, p3_lo, *mom):
        return fgp_obj_halo_ref(x, p1, p2, p3, lam, p3_lo, x_old, beta)
    d = torch.empty_like(x)
    y = None if x_old is None else torch.empty_like(x)
    ptr = [None if t is None else t.data_ptr() for t in (x_old, beta, y)]
    n0, n1, n2 = x.shape
    _build.check(_build.lib().tj_fgp_obj_halo(
        x.data_ptr(), p1.data_ptr(), p2.data_ptr(), p3.data_ptr(),
        p3_lo.data_ptr(), *ptr[:2], d.data_ptr(), ptr[2], n0, n1, n2,
        int(p1.dtype == torch.bfloat16), float(lam), _build.stream()),
        "tj_fgp_obj_halo")
    fgp_obj_halo.launches += 1
    return d, y


def _first(t: torch.Tensor) -> torch.Tensor:
    return t[:, :, 0].contiguous()


def _last(t: torch.Tensor) -> torch.Tensor:
    return t[:, :, -1].contiguous()


def tv_fgp_sharded(x, n_iter: int, lam: float, group: SlabGroup,
                   dual_dtype=None, mom=None):
    """FGP TV prox of this rank's slab (N, N, n_loc) of a z-sharded volume
    (``tomojax.tv.pallas_fgp_sharded.tv_fgp_sharded``): ``n_iter - 1`` K9a
    launches from P = 0, each after a halo exchange on the chain, then one
    K9b pass. Every rank of `group` calls it together.

    dual_dtype: as `tv_fgp_fused`; mom: optional (x_old, beta) for the
    fused Nesterov step. Returns d, or (d, y) with mom."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    dual_dtype = config.fgp_dual_dtype if dual_dtype is None else dual_dtype
    with profiling.annotate("tv.prox"):
        top = group.rank == group.size - 1
        p = tuple(torch.zeros(x.shape, dtype=dual_dtype, device=x.device)
                  for _ in range(3))
        # A chain of one rank has no neighbours: its halo below is zero, it has
        # none above, and no planes need copying out.
        solo = group.size == 1
        zero = torch.zeros(x.shape[:2], dtype=dual_dtype, device=x.device)
        # x's right halo is the same for every iteration
        x_hi = None
        if n_iter > 1 and not solo:
            _, x_hi = halo_exchange(_first(x), None, group)
        for _ in range(n_iter - 1):
            p3_lo, p_hi = (zero, None) if solo else halo_exchange(
                torch.stack([q[:, :, 0] for q in p]), _last(p[2]), group)
            p = fgp_iter_halo(x, *p, lam, p3_lo,
                              None if top else (x_hi, *p_hi))
        p3_lo = zero if solo else halo_exchange(None, _last(p[2]), group)[0]
        x_old, beta = (None, None) if mom is None else mom
        d, y = fgp_obj_halo(x, *p, lam, p3_lo, x_old, beta)
        return d if mom is None else (d, y)


fgp_iter_halo.launches = 0
fgp_obj_halo.launches = 0
