"""Exact system-matrix oracles (counterpart of
``tomojax/projector/oracle.py``), for tests and for holding the
projector against a sparse product.

* `ray_matrix`, `fp_oracle`, `bp_oracle`: the reference's numpy/scipy
  Siddon-style exact-intersection-length parallel-beam matrix (the
  reference's CPU projector generator ``parallelRay``, its
  cpu/utils/pytvlib.py:8-121), copied, since the port cannot import
  ``tomojax``. Row index ``angle * Nray + ray``, angles in degrees, public
  slice-first layouts. The reference's C++ ``native`` module (its own
  Siddon builder and ``CpuEngine``) is not ported: its matrix is this one,
  and its reconstructions are what the port's plain PyTorch paths compute
  on the CPU.
* `joseph_csr`: the Joseph operator A of K1/K2 as a torch CSR matrix (and
  its transpose), from the closed form K2 gathers with, so that
  ``torch.sparse.mm`` can stand beside the kernels as the library
  yardstick.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from tomojax_torch.geometry import Geometry
from tomojax_torch.projector.cuda_joseph import angle_tables


def ray_matrix(n: int, angles_deg) -> sp.csr_matrix:
    """Build the (Nproj*Nray, N*N) exact parallel-beam matrix.

    Args:
      n: image side == number of rays (the reference fixes Nray = Nside,
         cpu/utils/pytvlib.py:10).
      angles_deg: projection angles in DEGREES (the reference converts
         inside, :34).
    """
    angles = np.asarray(angles_deg, dtype=np.float64).reshape(-1)
    nproj = angles.size
    half = n / 2.0
    # Ray offsets at unit spacing centered on the origin (:20-21).
    offsets = np.linspace(-(n - 1) / 2.0, (n - 1) / 2.0, n)
    # Grid lines (:23-24).
    grid = np.linspace(-half, half, n + 1)

    rows, cols, vals = [], [], []
    for i, ang_deg in enumerate(angles):
        ang = np.deg2rad(ang_deg)
        dx, dy = -np.sin(ang), np.cos(ang)  # ray direction
        if abs(dx) < 1e-10:
            dx = 0.0
        if abs(dy) < 1e-10:
            dy = 0.0
        ox_all = np.cos(ang) * offsets
        oy_all = np.sin(ang) * offsets
        ox_all[np.abs(ox_all) < 1e-8] = 0.0
        oy_all[np.abs(oy_all) < 1e-8] = 0.0

        for j in range(n):
            ox, oy = ox_all[j], oy_all[j]
            with np.errstate(all="ignore"):
                # Parameter values where the ray crosses vertical grid
                # lines (x = const) and horizontal ones (y = const).
                t_x = (grid - ox) / dx if dx != 0.0 else np.full(n + 1, np.inf)
                t_y = (grid - oy) / dy if dy != 0.0 else np.full(n + 1, np.inf)
            ts = np.concatenate([t_x, t_y])
            xs = np.concatenate([grid, ox + dx * t_y])
            ys = np.concatenate([oy + dy * t_x, grid])
            order = np.argsort(ts)
            xs, ys = xs[order], ys[order]
            keep = (
                (xs >= -half)
                & (xs <= half)
                & (ys >= -half)
                & (ys <= half)
                & np.isfinite(xs)
                & np.isfinite(ys)
            )
            xs, ys = xs[keep], ys[keep]
            if xs.size < 2:
                continue
            # Merge duplicate crossing points (:74-79).
            dup = (np.abs(np.diff(xs)) <= 1e-8) & (np.abs(np.diff(ys)) <= 1e-8)
            mask = np.concatenate([~dup, [True]])
            xs, ys = xs[mask], ys[mask]
            if xs.size < 2:
                continue
            # Rays grazing the top/right boundary are dropped (:88-92).
            if (dy == 0.0 and abs(oy - half) < 1e-15) or (
                dx == 0.0 and abs(ox - half) < 1e-15
            ):
                continue
            seg = np.sqrt(np.diff(xs) ** 2 + np.diff(ys) ** 2)
            mx = 0.5 * (xs[:-1] + xs[1:])
            my = 0.5 * (ys[:-1] + ys[1:])
            mx[np.abs(mx) < 1e-10] = 0.0
            my[np.abs(my) < 1e-10] = 0.0
            # Pixel index: row-major with row 0 at the TOP (max y), col 0
            # at min x (:101-103).
            pr = np.floor(half - my).astype(np.int64)
            pc = np.floor(mx + half).astype(np.int64)
            ok = (seg > 0) & (pr >= 0) & (pr < n) & (pc >= 0) & (pc < n)
            rows.append(np.full(ok.sum(), i * n + j, dtype=np.int64))
            cols.append((pr * n + pc)[ok])
            vals.append(seg[ok])

    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    vals = np.concatenate(vals) if vals else np.zeros(0, np.float64)
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(nproj * n, n * n), dtype=np.float64
    )


def fp_oracle(a: sp.csr_matrix, vol: np.ndarray) -> np.ndarray:
    """(Ns, N, N) -> (Ns, Nproj, Nray) via the exact matrix."""
    ns, n, _ = vol.shape
    nproj = a.shape[0] // n
    out = a @ vol.reshape(ns, n * n).T
    return out.T.reshape(ns, nproj, n)


def bp_oracle(a: sp.csr_matrix, sino: np.ndarray) -> np.ndarray:
    """(Ns, Nproj, Nray) -> (Ns, N, N) via the exact transpose."""
    ns = sino.shape[0]
    n = int(np.sqrt(a.shape[1]))
    out = a.T @ sino.reshape(ns, -1).T
    return out.T.reshape(ns, n, n)


def joseph_taps(geom: Geometry, device):
    """Both taps of every (angle, pixel), (Na, N, N) each, from the Joseph
    closed form that K2 gathers with (the tables of
    ``cuda_joseph.angle_tables``): yields (bin j, weight w, keep) per tap,
    keep marking the nonzeros of A (j in [0, Nt), w != 0)."""
    n, nt = geom.n, geom.nray
    t = angle_tables(geom, torch.device(device)).bp
    c, s, invd = (t[:, i, None, None] for i in range(3))
    ctr = (n - 1) / 2.0
    xc = torch.arange(n, dtype=torch.float32, device=t.device) - ctr
    yr = ctr - torch.arange(n, dtype=torch.float32, device=t.device)
    jstar = c * xc[None, None, :] + s * yr[None, :, None] + (nt - 1) / 2.0
    f = torch.floor(jstar)
    j0 = f.long()
    for j, fj in ((j0, f), (j0 + 1, f + 1.0)):
        w = torch.clamp_min(1.0 - torch.abs(fj - jstar) * invd, 0.0) * invd
        yield j, w, (j >= 0) & (j < nt) & (w != 0)


def joseph_nnz(geom: Geometry, device) -> int:
    """The nonzeros of A at this geometry, as `joseph_csr` counts them."""
    return sum(int(keep.sum()) for _, _, keep in joseph_taps(geom, device))


def joseph_csr(geom: Geometry, device):
    """(A, A^T, nonzeros): A (Na Nt x N^2, row a * Nt + j, column the pixel
    r * N + c) and A^T as torch CSR matrices on `device`, from
    `joseph_taps`. ``torch.sparse.mm(A, x.reshape(N * N, Ns))`` is K1's
    ``fp_sl(x)`` (slice-last), A^T likewise K2's ``bp_sl``."""
    device = torch.device(device)
    n, nt, na = geom.n, geom.nray, geom.nproj
    pix = torch.arange(n * n, device=device).reshape(1, n, n).expand(na, n,
                                                                     n)
    ang = torch.arange(na, device=device).reshape(na, 1, 1).expand(na, n, n)
    rows, cols, vals = [], [], []
    for j, w, keep in joseph_taps(geom, device):
        rows.append((ang * nt + j)[keep])
        cols.append(pix[keep])
        vals.append(w[keep])
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                    (na * nt, n * n),
                                    check_invariants=False).coalesce()
        at = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals,
                                     (n * n, na * nt),
                                     check_invariants=False).coalesce()
        return a.to_sparse_csr(), at.to_sparse_csr(), int(a.values().numel())
