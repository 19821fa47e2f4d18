"""FGP TV-prox kernels on the card, with their plain PyTorch versions.

Counterpart of ``tomojax/tv/pallas_fgp.py`` (reference ``tv_fgp.cu``
semantics: zero divergence below the low boundary, zero forward
difference at the far boundary, nonnegativity clamp, dual step
1/(26 lam), isotropic projection of the duals onto the unit ball).

* K3 ``fgp_iter`` (``csrc/fgp.cu`` ``fgp_iter_kernel``): one FGP
  iteration, d = max(x - lam div P, 0) recomputed in registers,
  P <- project(P + grad(d) / (26 lam)).
* K4 ``fgp_obj_mom`` (``csrc/fgp.cu`` ``fgp_obj_kernel``): the final
  d = max(x - lam div P, 0) and, with momentum, the FISTA step
  y = d + beta (d - x_old).
* K11 ``fgp_iter2`` (``csrc/fgp.cu`` ``fgp_iter2_kernel``): two FGP
  iterations per launch, the intermediate duals float32 in shared memory
  (``tv_fgp_fused(..., fuse_pairs=True)``).
* K12 ``fgp_grad`` (``csrc/fgp.cu`` ``fgp_grad_kernel``): the dual pass of
  the two-pass FGP from a stored d (``tv_fgp_two_pass``, with K4's
  objective pass).

Volumes are contiguous (n0, n1, n2) float32; dual field k pairs with
axis k-1 of the array it is given. FGP does not change under a
permutation of the axes, so the slice-last FISTA state runs it as it
is. Duals are stored as ``dual_dtype`` (float32 or bfloat16) and all
arithmetic is float32: the plain version rounds the new duals to
``dual_dtype`` at the same point as the kernel. Wrappers run the plain
versions only for CPU tensors; on CUDA tensors they launch the kernel or
raise. Launches are counted in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from tomojax_torch import _build, profiling
from tomojax_torch import config
from tomojax_torch.tv.cuda_tv_value import tv_value

F32 = torch.float32
DUAL_DTYPES = (torch.float32, torch.bfloat16)


def _bdiff(p: torch.Tensor, axis: int) -> torch.Tensor:
    """p[i] - p[i-1] along `axis`, with p[-1] = 0."""
    prev = torch.narrow(p, axis, 0, p.shape[axis] - 1)
    lo = torch.zeros_like(torch.narrow(p, axis, 0, 1))
    return p - torch.cat([lo, prev], dim=axis)


def _fdiff(d: torch.Tensor, axis: int) -> torch.Tensor:
    """d[i] - d[i+1] along `axis`, zero at the far boundary."""
    n = d.shape[axis]
    diff = torch.narrow(d, axis, 0, n - 1) - torch.narrow(d, axis, 1, n - 1)
    return torch.cat([diff, torch.zeros_like(torch.narrow(d, axis, 0, 1))],
                     dim=axis)


def _objective(x, p1, p2, p3, lam: float) -> torch.Tensor:
    div = _bdiff(p1.to(F32), 0)
    div = div + _bdiff(p2.to(F32), 1)
    div = div + _bdiff(p3.to(F32), 2)
    return torch.clamp_min(x - lam * div, 0.0)


def _dual_step(d, p1, p2, p3, lam: float):
    """project(P + grad(d) / (26 lam)) in float32."""
    multip = 1.0 / (26.0 * lam)
    q1 = p1.to(F32) + multip * _fdiff(d, 0)
    q2 = p2.to(F32) + multip * _fdiff(d, 1)
    q3 = p3.to(F32) + multip * _fdiff(d, 2)
    den = q1 * q1 + q2 * q2 + q3 * q3
    scale = torch.where(den > 1.0, torch.rsqrt(den), 1.0)
    return q1 * scale, q2 * scale, q3 * scale


def fgp_iter_ref(x, p1, p2, p3, lam: float):
    """Plain K3: the duals after one FGP iteration, in p1's dtype."""
    q = _dual_step(_objective(x, p1, p2, p3, lam), p1, p2, p3, lam)
    return tuple(v.to(p1.dtype) for v in q)


def fgp_iter2_ref(x, p1, p2, p3, lam: float):
    """Plain K11: the duals after two FGP iterations, in p1's dtype. The
    intermediate duals stay float32 and are rounded nowhere; the result is
    rounded to p1's dtype once."""
    q = _dual_step(_objective(x, p1, p2, p3, lam), p1, p2, p3, lam)
    r = _dual_step(_objective(x, *q, lam), *q, lam)
    return tuple(v.to(p1.dtype) for v in r)


def fgp_grad_ref(d, p1, p2, p3, lam: float):
    """Plain K12: the float32 duals project(P + grad(d) / (26 lam)) from a
    stored objective d."""
    return _dual_step(d, p1, p2, p3, lam)


def fgp_obj_mom_ref(x, p1, p2, p3, lam: float, x_old=None, beta=None):
    """Plain K4: ``(d, y)``; y = d + beta (d - x_old) with momentum, else
    None."""
    d = _objective(x, p1, p2, p3, lam)
    if x_old is None:
        return d, None
    return d, d + beta * (d - x_old)


def _check_duals(x, p1, p2, p3):
    _build.check_operand(x, "x", x.shape, F32)
    if x.dim() != 3:
        raise ValueError(f"FGP takes a 3D volume, got {tuple(x.shape)}")
    if p1.dtype not in DUAL_DTYPES:
        raise ValueError(f"dual dtype {p1.dtype} not in {DUAL_DTYPES}")
    for name, p in (("p1", p1), ("p2", p2), ("p3", p3)):
        _build.check_operand(p, name, x.shape, p1.dtype)


def _iter_launch(entry: str, x, p1, p2, p3, lam: float):
    """Launch tj_fgp_iter (K3) or tj_fgp_iter2 (K11) into fresh duals."""
    q1, q2, q3 = (torch.empty_like(p1) for _ in range(3))
    n0, n1, n2 = x.shape
    _build.check(getattr(_build.lib(), entry)(
        x.data_ptr(), p1.data_ptr(), p2.data_ptr(), p3.data_ptr(),
        q1.data_ptr(), q2.data_ptr(), q3.data_ptr(), n0, n1, n2,
        int(p1.dtype == torch.bfloat16), float(lam),
        1.0 / (26.0 * float(lam)), _build.stream()), entry)
    return q1, q2, q3


def fgp_iter(x, p1, p2, p3, lam: float):
    """K3: one FGP iteration; returns new duals (q1, q2, q3) in p1's
    dtype. Reads P and writes fresh tensors, so no thread of the kernel
    reads a neighbour's updated dual."""
    _check_duals(x, p1, p2, p3)
    if _build.on_cpu(x, p1, p2, p3):
        return fgp_iter_ref(x, p1, p2, p3, lam)
    q = _iter_launch("tj_fgp_iter", x, p1, p2, p3, lam)
    fgp_iter.launches += 1
    return q


def fgp_iter2(x, p1, p2, p3, lam: float):
    """K11: two FGP iterations in one launch, as `fgp_iter2_ref` says;
    returns the new duals in p1's dtype."""
    _check_duals(x, p1, p2, p3)
    if _build.on_cpu(x, p1, p2, p3):
        return fgp_iter2_ref(x, p1, p2, p3, lam)
    q = _iter_launch("tj_fgp_iter2", x, p1, p2, p3, lam)
    fgp_iter2.launches += 1
    return q


def fgp_grad(d, p1, p2, p3, lam: float):
    """K12: the float32 duals project(P + grad(d) / (26 lam)) from the
    stored objective d of the same shape (float32 throughout)."""
    _build.check_operand(d, "d", d.shape, F32)
    if d.dim() != 3:
        raise ValueError(f"FGP takes a 3D volume, got {tuple(d.shape)}")
    for name, p in (("p1", p1), ("p2", p2), ("p3", p3)):
        _build.check_operand(p, name, d.shape, F32)
    if _build.on_cpu(d, p1, p2, p3):
        return fgp_grad_ref(d, p1, p2, p3, lam)
    q1, q2, q3 = (torch.empty_like(d) for _ in range(3))
    n0, n1, n2 = d.shape
    _build.check(_build.lib().tj_fgp_grad(
        d.data_ptr(), p1.data_ptr(), p2.data_ptr(), p3.data_ptr(),
        q1.data_ptr(), q2.data_ptr(), q3.data_ptr(), n0, n1, n2,
        1.0 / (26.0 * float(lam)), _build.stream()), "tj_fgp_grad")
    fgp_grad.launches += 1
    return q1, q2, q3


def fgp_obj_mom(x, p1, p2, p3, lam: float, x_old=None, beta=None):
    """K4: ``(d, y)`` as `fgp_obj_mom_ref` says. x_old (x's shape) and
    beta (a 0-dim float32 tensor, read on the device) come together."""
    _check_duals(x, p1, p2, p3)
    if (x_old is None) != (beta is None):
        raise ValueError("x_old and beta come together")
    mom = () if x_old is None else (x_old, beta)
    if x_old is not None:
        _build.check_operand(x_old, "x_old", x.shape, F32)
        _build.check_operand(beta, "beta", (), F32)
    if _build.on_cpu(x, p1, p2, p3, *mom):
        return fgp_obj_mom_ref(x, p1, p2, p3, lam, x_old, beta)
    d = torch.empty_like(x)
    y = None if x_old is None else torch.empty_like(x)
    n0, n1, n2 = x.shape
    ptr = [None if t is None else t.data_ptr() for t in (x_old, beta, y)]
    _build.check(_build.lib().tj_fgp_obj(
        x.data_ptr(), p1.data_ptr(), p2.data_ptr(), p3.data_ptr(), *ptr[:2],
        d.data_ptr(), ptr[2], n0, n1, n2, int(p1.dtype == torch.bfloat16),
        float(lam), _build.stream()), "tj_fgp_obj")
    fgp_obj_mom.launches += 1
    return d, y


def tv_fgp_fused(x, n_iter: int, lam: float, dual_dtype=None, mom=None,
                 fuse_pairs: bool = False):
    """FGP TV prox of a 3D volume: ``n_iter - 1`` iterations from P = 0,
    then one K4 pass (tomojax/tv/pallas_fgp.py tv_fgp_pallas_fused).

    The iterations are K3 launches; with fuse_pairs and m = n_iter - 1 >= 2
    they are m // 2 K11 launches, then one K3 launch if m is odd, in the
    reference's order but without its TPU VMEM gate (pallas_fgp.py:446-452),
    which falls back to K3's chain at 256^2 planes. K11 keeps the
    intermediate duals float32: with bf16 duals it rounds half as often as
    the K3 chain, so the two differ by up to one bf16 rounding of the duals
    propagated; with float32 duals they agree to float32 rounding.

    dual_dtype: storage type of the duals (default config.fgp_dual_dtype).
    mom: optional (x_old, beta) for the fused Nesterov step.
    Returns d, or (d, y) with mom. Unlike the reference function it does
    not compute the TV value of the input: the FISTA path discards it."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    dual_dtype = config.fgp_dual_dtype if dual_dtype is None else dual_dtype
    with profiling.annotate("tv.prox"):
        p = tuple(torch.zeros(x.shape, dtype=dual_dtype, device=x.device)
                  for _ in range(3))
        m = n_iter - 1
        pairs = m // 2 if fuse_pairs and m >= 2 else 0
        for _ in range(pairs):
            p = fgp_iter2(x, *p, lam)
        for _ in range(m - 2 * pairs):
            p = fgp_iter(x, *p, lam)
        x_old, beta = (None, None) if mom is None else mom
        d, y = fgp_obj_mom(x, *p, lam, x_old, beta)
        return d if mom is None else (d, y)


def tv_fgp_two_pass(x, n_iter: int, lam: float):
    """The two-pass FGP of tomojax/tv/pallas_fgp.py tv_fgp_pallas: each
    iteration stores d = max(x - lam div P, 0) (K4 with the momentum off)
    and then updates P from it (K12), with float32 duals. Returns
    (d, tv of x), d from the last iteration's objective pass. The
    reference's last dual pass, whose result it discards, is not run."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    with profiling.annotate("tv.prox"):
        p = tuple(torch.zeros_like(x) for _ in range(3))
        for i in range(n_iter):
            d, _ = fgp_obj_mom(x, *p, lam)
            if i < n_iter - 1:
                p = fgp_grad(d, *p, lam)
        return d, tv_value(x)


fgp_iter.launches = 0
fgp_iter2.launches = 0
fgp_grad.launches = 0
fgp_obj_mom.launches = 0
