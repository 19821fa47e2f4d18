"""Plain PyTorch reference of what the timed entries compute.

A frozen copy of the arithmetic of the port's plain versions (the Joseph
pair, the FGP prox, the TV value and subgradient, the SART sweep) and of
the solver loops around them (FISTA-TV, ASD-POCS, chemical tomography and
data fusion, the streaming compressed-sensing round). It imports nothing
of the port and takes nothing the port made: it derives its own system
weights, SART weights, fusion weights and rescaling from the inputs.

Every function runs on the device and in the data type of the tensors it
is given. Geometry tables and tap positions are always float32 (as the
port keeps them); the data and every sum over them are in ``dt``, so the
same code at ``torch.bfloat16`` is the control that the comparison has to
refuse. Layouts are slice-last: volumes (N, N, Ns), sinograms
(Na, Nt, Ns).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = torch.float32
EPS_TV = 1e-6
POISSON_EPS = 0.1
WEIGHT_EPS = 1e-6


@dataclasses.dataclass
class Geom:
    """A parallel-beam geometry: image side n, nray bins, angles in
    degrees; per angle (cos, sin, 1/D) in float32, trig values below
    1e-12 zeroed."""

    n: int
    angles_deg: np.ndarray
    nray: int

    def __post_init__(self):
        a = np.deg2rad(np.asarray(self.angles_deg, np.float64)).reshape(-1)
        c, s = np.cos(a), np.sin(a)
        c[np.abs(c) < 1e-12] = 0.0
        s[np.abs(s) < 1e-12] = 0.0
        bp = np.stack([c, s, 1.0 / np.maximum(np.abs(c), np.abs(s))],
                      axis=1)
        self.nproj = len(a)
        self.bp_tab = bp.astype(np.float32).tolist()


def make_geom(n: int, angles_deg, nray: int | None = None) -> Geom:
    return Geom(int(n), np.asarray(angles_deg, np.float64),
                int(nray or n))


# ------------------------------------------------------------ projector


def _taps(g: Geom, device):
    """Both taps of every (angle, pixel) of the Joseph pair's closed form:
    (angle, bin, pixel, weight) of each nonzero of A, the bin j in
    {floor(J*), floor(J*) + 1} of J* = x cos + y sin + (Nt-1)/2 with the
    weight hat((j - J*) / D) / D, D = max(|cos|, |sin|); float32."""
    n, nt = g.n, g.nray
    t = torch.tensor(g.bp_tab, dtype=F32, device=device)
    c, s, invd = (t[:, i, None, None] for i in range(3))
    ctr = (n - 1) / 2.0
    xc = torch.arange(n, dtype=F32, device=device) - ctr
    yr = ctr - torch.arange(n, dtype=F32, device=device)
    jstar = c * xc[None, None, :] + s * yr[None, :, None] + (nt - 1) / 2.0
    f = torch.floor(jstar)
    ang = torch.arange(g.nproj, device=device).reshape(-1, 1, 1)
    pix = torch.arange(n * n, device=device).reshape(1, n, n)
    out = []
    for fj in (f, f + 1.0):
        w = torch.clamp_min(1.0 - torch.abs(fj - jstar) * invd, 0.0) * invd
        j = fj.to(torch.int64)
        keep = (j >= 0) & (j < nt) & (w != 0)
        out.append((ang.expand_as(j)[keep], j[keep],
                    pix.expand_as(j)[keep], w[keep]))
    return [torch.cat(v) for v in zip(*out)]


DENSE_MAX = 1 << 22  # entries of A kept dense below this (small problems)


def _matrix(rows, cols, vals, shape, dt):
    """A sparse CSR matrix, or a dense one where it is small (CSR products
    take no bfloat16 on the CPU)."""
    if shape[0] * shape[1] <= DENSE_MAX:
        m = torch.zeros(shape, dtype=F32, device=vals.device)
        m.index_put_((rows, cols), vals, accumulate=True)
        return m.to(dt)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr().to(dt)


def _mm(m, v):
    return torch.sparse.mm(m, v) if m.layout == torch.sparse_csr else m @ v


class Operator:
    """The Joseph matrix A of a geometry as a matrix in data type `dt`:
    A x and A^T y of slice-last stacks, and each angle's rows for the
    SART sweep. The same weights as the gather form of the port's plain
    versions; the sums run in the matrix product's order."""

    def __init__(self, g: Geom, device, dt):
        self.g = g
        n2, nt = g.n * g.n, g.nray
        a, j, p, w = _taps(g, device)
        rows = a * nt + j
        self.A = _matrix(rows, p, w, (g.nproj * nt, n2), dt)
        self.At = _matrix(p, rows, w, (n2, g.nproj * nt), dt)
        self.rows = []  # per angle: (A_a, A_a^T)
        for k in range(g.nproj):
            m = a == k
            self.rows.append((_matrix(j[m], p[m], w[m], (nt, n2), dt),
                              _matrix(p[m], j[m], w[m], (n2, nt), dt)))

    def fp(self, x: torch.Tensor) -> torch.Tensor:
        """A x: (N, N, Ns) -> (Na, Nt, Ns)."""
        g = self.g
        y = _mm(self.A, x.reshape(g.n * g.n, -1))
        return y.reshape(g.nproj, g.nray, -1)

    def bp(self, y: torch.Tensor) -> torch.Tensor:
        """A^T y: (Na, Nt, Ns) -> (N, N, Ns)."""
        g = self.g
        x = _mm(self.At, y.reshape(g.nproj * g.nray, -1))
        return x.reshape(g.n, g.n, -1)

    def fp_angle(self, x: torch.Tensor, a: int) -> torch.Tensor:
        return _mm(self.rows[a][0], x.reshape(self.g.n ** 2, -1))

    def bp_angle(self, ya: torch.Tensor, a: int) -> torch.Tensor:
        return _mm(self.rows[a][1], ya).reshape(self.g.n, self.g.n, -1)


def _safe_inv(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > WEIGHT_EPS,
                       1.0 / torch.clamp_min(w, WEIGHT_EPS), 0.0)


@dataclasses.dataclass
class System:
    """The operator, its inverse row sums A 1 and column sums A^T 1, and
    max(A^T A 1)."""

    op: Operator
    inv_row: torch.Tensor  # (Na, Nt)
    inv_col: torch.Tensor  # (N, N)
    lipschitz: torch.Tensor  # 0-dim


def make_system(g: Geom, device, dt=F32) -> System:
    op = Operator(g, device, dt)
    row = op.fp(torch.ones((g.n, g.n, 1), dtype=dt, device=device))
    col = op.bp(torch.ones((g.nproj, g.nray, 1), dtype=dt, device=device))
    lip = torch.max(op.bp(row))
    return System(op, _safe_inv(row[:, :, 0]), _safe_inv(col[:, :, 0]), lip)


def sart_weights(s: System) -> torch.Tensor:
    """Per-angle inverse column sums A_a^T 1, (Na, N, N)."""
    ones = torch.ones((s.op.g.nray, 1), dtype=s.inv_row.dtype,
                      device=s.inv_row.device)
    return torch.stack([_safe_inv(s.op.bp_angle(ones, a)[:, :, 0])
                        for a in range(s.op.g.nproj)])


# ------------------------------------------------------------------- TV


def _bdiff(p: torch.Tensor, axis: int) -> torch.Tensor:
    prev = torch.narrow(p, axis, 0, p.shape[axis] - 1)
    lo = torch.zeros_like(torch.narrow(p, axis, 0, 1))
    return p - torch.cat([lo, prev], dim=axis)


def _fdiff(d: torch.Tensor, axis: int) -> torch.Tensor:
    n = d.shape[axis]
    diff = torch.narrow(d, axis, 0, n - 1) - torch.narrow(d, axis, 1, n - 1)
    return torch.cat([diff, torch.zeros_like(torch.narrow(d, axis, 0, 1))],
                     dim=axis)


def _fgp_objective(x, p, lam: float):
    div = _bdiff(p[0], 0) + _bdiff(p[1], 1) + _bdiff(p[2], 2)
    return torch.clamp_min(x - lam * div, 0.0)


def fgp(x: torch.Tensor, n_iter: int, lam: float) -> torch.Tensor:
    """FGP TV prox (zero-boundary divergence and gradient, dual step
    1/(26 lam), isotropic projection of the duals, nonnegativity):
    n_iter - 1 dual updates from P = 0, then the objective."""
    p = [torch.zeros_like(x) for _ in range(3)]
    multip = 1.0 / (26.0 * lam)
    for _ in range(n_iter - 1):
        d = _fgp_objective(x, p, lam)
        q = [p[k] + multip * _fdiff(d, k) for k in range(3)]
        den = q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
        scale = torch.where(den > 1.0, torch.rsqrt(den), 1.0)
        p = [v * scale for v in q]
    return _fgp_objective(x, p, lam)


def tv_value(x: torch.Tensor) -> torch.Tensor:
    """Isotropic TV with periodic wrap on every axis (0-dim)."""
    d0 = x - torch.roll(x, -1, 0)
    d1 = x - torch.roll(x, -1, 1)
    d2 = x - torch.roll(x, -1, 2)
    return torch.sum(torch.sqrt(EPS_TV + d0 * d0 + d1 * d1 + d2 * d2))


def tv_grad(x: torch.Tensor) -> torch.Tensor:
    """The 4-term periodic TV subgradient (axes in the order slice, row,
    column of a slice-last volume)."""
    i_, j_, k_ = 2, 0, 1
    ip, jp, kp = (torch.roll(x, -1, a) for a in (i_, j_, k_))
    di, dj, dk = x - ip, x - jp, x - kp
    d = torch.sqrt(EPS_TV + di * di + dj * dj + dk * dk)
    g = (3.0 * x - ip - jp - kp) / d
    g = g + (x - torch.roll(x, 1, i_)) / torch.roll(d, 1, i_)
    g = g + (x - torch.roll(x, 1, j_)) / torch.roll(d, 1, j_)
    return g + (x - torch.roll(x, 1, k_)) / torch.roll(d, 1, k_)


def tv_descent(x: torch.Tensor, ng: int, dpocs: float) -> torch.Tensor:
    """ng steps x -= dpocs g / ||g||, then positivity."""
    for _ in range(ng):
        g = tv_grad(x)
        x = x - dpocs * g / torch.sqrt(torch.sum(g * g))
    return torch.clamp_min(x, 0.0)


def _norm(v: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(v * v)))


# -------------------------------------------------------------- solvers


def fista(b: torch.Tensor, s: System, lam: float, n_iter: int,
          n_tv_iter: int):
    """FISTA-TV with Nesterov momentum from zero. Returns (x, cost) with
    cost[i] = 0.5 ||A x_i - b||^2 + lam TV(x_i)."""
    op, n = s.op, s.op.g.n
    x_old = yk = torch.zeros((n, n, b.shape[-1]), dtype=b.dtype,
                             device=b.device)
    ir, ic = s.inv_row[:, :, None], s.inv_col[:, :, None]
    ax = op.fp(x_old)
    resid = (b - ax) * ir
    t = 1.0
    cost = []
    for _ in range(n_iter):
        z = torch.clamp_min(yk + ic * op.bp(resid), 0.0)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t_new
        d = fgp(z, n_tv_iter, lam)
        yk = d + beta * (d - x_old)
        ax_new = op.fp(d)
        resid = (b - (ax_new + beta * (ax_new - ax))) * ir
        r = ax_new - b
        cost.append(0.5 * float(torch.sum(r * r)) + lam * float(tv_value(d)))
        x_old, ax, t = d, ax_new, t_new
    return x_old, np.asarray(cost)


def sart_sweep(x, b, s: System, w_a: torch.Tensor, beta: float):
    """One sequential SART pass over the angles."""
    op = s.op
    for a in range(op.g.nproj):
        proj = op.fp_angle(x, a)
        resid = (b[a] - proj) * s.inv_row[a][:, None]
        upd = op.bp_angle(resid, a)
        x = torch.clamp_min(x + beta * w_a[a][:, :, None] * upd, 0.0)
    return x


def asd_pocs(b: torch.Tensor, s: System, w_a: torch.Tensor, niter: int,
             eps: float, beta0: float, beta_red: float, r_max: float,
             ng: int, alpha: float, alpha_red: float):
    """ASD-POCS from zero with the host-side adaptation of beta and the
    TV step. Returns (x, dd_vec, tv_vec)."""
    op, n = s.op, s.op.g.n
    x = torch.zeros((n, n, b.shape[-1]), dtype=b.dtype, device=b.device)
    beta, dpocs = beta0, 0.0
    dds, tvs = [], []
    for it in range(niter):
        x0 = x
        x = sart_sweep(x, b, s, w_a, beta)
        dp = _norm(x - x0)
        if it == 0:
            dpocs = alpha * dp
        dd = _norm(op.fp(x) - b)
        tvs.append(float(tv_value(x)))
        x1 = x
        x = tv_descent(x, ng, dpocs)
        dg = _norm(x - x1)
        beta *= beta_red
        dds.append(dd)
        if dg > r_max * dp and dd > eps:
            dpocs *= alpha_red
    return x, np.asarray(dds), np.asarray(tvs)


def cs_round(x, dpocs: float, b, s: System, n_iter: int, ng: int,
             alpha: float, alpha_red: float, r_max: float, eps: float):
    """One streaming compressed-sensing round from the state (x, dpocs):
    n_iter times a SIRT data step with positivity, then ng TV steps, with
    the adaptation of dpocs. Returns (x, dd of the last iteration,
    dpocs)."""
    op = s.op
    ir, ic = s.inv_row[:, :, None], s.inv_col[:, :, None]
    dd = 0.0
    for _ in range(n_iter):
        first = dpocs == 0.0
        x0 = x
        x = torch.clamp_min(x + ic * op.bp((b - op.fp(x)) * ir), 0.0)
        dp = _norm(x - x0)
        if first:
            dpocs = alpha * dp
        dd = _norm(op.fp(x) - b)
        x1 = x
        x = tv_descent(x, ng, dpocs)
        dg = _norm(x - x1)
        if dg > r_max * dp and dd > eps:
            dpocs *= alpha_red
    return x, dd, dpocs


# --------------------------------------------------------------- fusion


@dataclasses.dataclass
class Fusion:
    haadf: System
    chem: System
    w: torch.Tensor  # (Nel,)
    gamma: float
    l_aps: torch.Tensor
    l_asig: torch.Tensor


def make_fusion(n: int, haadf_deg, chem_deg, weights, gamma: float,
                device, dt=F32) -> Fusion:
    sh = make_system(make_geom(n, haadf_deg), device, dt)
    sc = make_system(make_geom(n, chem_deg), device, dt)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device,
                        dtype=dt)
    sig1 = torch.sum(w) * torch.ones((n, n, 1), dtype=dt, device=device)
    back = sh.op.bp(sh.op.fp(sig1))
    return Fusion(sh, sc, w, float(gamma), sc.lipschitz,
                  torch.max(w) * torch.max(back))


def _model(x: torch.Tensor, fs: Fusion) -> torch.Tensor:
    xg = torch.clamp_min(x, 0.0) ** fs.gamma
    return torch.tensordot(fs.w, xg, dims=1)


def chemical_tomography(b_chem, fs: Fusion, n_iter: int, lam: float):
    """Chemistry-only Poisson-ML from zero; returns (x, costCHEM)."""
    op, n = fs.chem.op, fs.chem.op.g.n
    nel, ns = b_chem.shape[0], b_chem.shape[-1]
    x = torch.zeros((nel, n, n, ns), dtype=b_chem.dtype,
                    device=b_chem.device)
    scale = -lam / fs.l_aps
    costs = []
    for _ in range(n_iter):
        new, cost = [], 0.0
        for e in range(nel):
            ax = op.fp(x[e])
            ratio = (ax - b_chem[e]) / (ax + POISSON_EPS)
            new.append(torch.clamp_min(x[e] + scale * op.bp(ratio), 0.0))
            cost += float(torch.sum(ax - b_chem[e]
                                    * torch.log(ax + POISSON_EPS)))
        x = torch.stack(new)
        costs.append(cost)
    return x, np.asarray(costs)


def _sirt(x, b, s: System, n_iter: int):
    ir, ic = s.inv_row[:, :, None], s.inv_col[:, :, None]
    for _ in range(n_iter):
        x = torch.clamp_min(x + ic * s.op.bp((b - s.op.fp(x)) * ir), 0.0)
    return x


def data_fusion(x, b_haadf, b_chem, fs: Fusion, n_iter: int,
                lam_haadf: float, lam_chem: float, lam_tv: float,
                iter_sirt: int, tv_iter: int):
    """The rescaling, then the fused loop with the host-side lam_chem
    decay. Returns (x, costHAADF, costCHEM, costTV)."""
    oh, oc = fs.haadf.op, fs.chem.op
    nel = x.shape[0]
    x = x * 10.0
    gmod = oh.fp(_model(x, fs))
    b_haadf = (b_haadf / torch.clamp_min(
        torch.amax(b_haadf, dim=(1, 2), keepdim=True), 1e-30)
        * torch.amax(gmod, dim=(1, 2), keepdim=True))
    m = np.zeros((n_iter, 3))
    for i in range(n_iter):
        h = _model(x, fs)
        gmod = oh.fp(h)
        u = _sirt(h, b_haadf, fs.haadf, iter_sirt)
        d_h = fs.w.reshape(nel, 1, 1, 1) * (u - h)[None]
        d_h = fs.gamma * torch.clamp_min(x, 0.0) ** (fs.gamma - 1.0) * d_h
        d_c, cc = [], 0.0
        for e in range(nel):
            ax = oc.fp(x[e])
            d_c.append(oc.bp((ax - b_chem[e]) / (ax + POISSON_EPS)))
            cc += float(torch.sum(ax - b_chem[e]
                                  * torch.log(ax + POISSON_EPS)))
        x = torch.clamp_min(x - (lam_chem / fs.l_aps) * torch.stack(d_c)
                            + lam_haadf * d_h, 0.0)
        ch = _norm(gmod - b_haadf)
        tv0 = sum(float(tv_value(x[e])) for e in range(nel))
        x = torch.stack([fgp(x[e], tv_iter, lam_tv) for e in range(nel)])
        m[i] = ch, cc, tv0
        if i > 0 and m[i, 0] > m[i - 1, 0]:
            lam_chem *= 0.95
    return x, m[:, 0], m[:, 1], m[:, 2]
