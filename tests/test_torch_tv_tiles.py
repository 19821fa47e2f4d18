"""The plane march of K7/K9c and K3/K9a (csrc/tv_march.cuh, tvgd.cu, fgp.cu)
emulated on the CPU.

The kernels stage each plane of their tile with a one-voxel halo (periodic
for K7, zero outside the volume for K3, the halo planes for K9c/K9a), march
TV_C planes of axis 0 a block (a chunk restarts one plane below), compute
K7's denominator D and K3's objective d once a voxel on the tile plus one
row and one column, and keep the previous plane's values. A torch
emulation of each march, with the kernels' staging rules and the same
float32 operations in the same order, must equal the plain versions bit for
bit at shapes that cross every boundary: n0 below, at and above TV_C; n1
and n2 not multiples of the tile; n2 = 1. K7's ||g||^2 partials are
emulated in the kernel's layout and order (one a block; warp shuffle trees,
then the warps in order).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax_torch.tv import march  # noqa: E402
from tomojax_torch.tv import tv_gd  # noqa: E402
from tomojax_torch.tv.cuda_fgp import fgp_iter_ref  # noqa: E402
from tomojax_torch.tv.cuda_fgp_sharded import fgp_iter_halo_ref  # noqa: E402
from tomojax_torch.tv.cuda_tv_value import EPS_TV  # noqa: E402
from tomojax_torch.tv.cuda_tvgd import (  # noqa: E402
    tv_grad_ref, tv_step, tv_step_ref,
)
from tomojax_torch.tv.cuda_tvgd_sharded import tv_grad_halo_ref  # noqa: E402

CSRC = Path(march.__file__).resolve().parents[1] / "csrc"
T1, T2, C = march.TV_T1, march.TV_T2, march.TV_C
TY = 256 // T2  # thread rows of a block; a thread's voxels lie TY rows apart
F32 = torch.float32
# (n0, n1, n2): n0 below, at and above TV_C (and two chunks and a bit);
# ragged n1 and n2; n2 = 1; one plane
SHAPES = [(5, 11, 37), (32, 9, 33), (40, 16, 1), (70, 3, 40), (1, 8, 32)]


def _rand(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.normal(size=shape) * scale + offset).astype(np.float32))


def test_tile_constants_match_the_source():
    text = (CSRC / "tv_march.cuh").read_text()
    for name, value in (("TV_T1", T1), ("TV_T2", T2), ("TV_C", C)):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m is not None and int(m.group(1)) == value, name
    # the emulated block sum takes a tile row as one warp
    assert T2 == 32


# ------------------------------------------------------------ the staging


def _rows(n1, gy, periodic):
    """Box row -> row of the plane, n1 (a zero row) where nothing is read."""
    r = torch.arange(gy)[:, None] * T1 - 1 + torch.arange(T1 + 2)[None, :]
    if periodic:
        r = torch.where(r == -1, n1 - 1, torch.where(r == n1, 0, r))
    return torch.where((r >= 0) & (r < n1), r, n1)


def _cols(n2, gx, periodic, halo):
    """Box column -> column of the extended plane: 0..n2-1 the volume, n2
    the plane below slice 0, n2 + 1 the plane above slice n2 - 1, n2 + 2
    zeros."""
    c = torch.arange(gx)[:, None] * T2 - 1 + torch.arange(T2 + 2)[None, :]
    lo = n2 if halo else (n2 - 1 if periodic else n2 + 2)
    hi = n2 + 1 if halo else (0 if periodic else n2 + 2)
    out = torch.where(c == -1, lo, torch.where(c == n2, hi, c))
    return torch.where(c > n2, n2 + 2, out)


def _stager(field, rows, cols, lo=None, hi=None, periodic=True):
    """stage(p): the (gy, gx, T1 + 2, T2 + 2) boxes of plane p of `field`
    (wrapped into [0, n0) when periodic, zeros outside otherwise)."""
    n0, n1, n2 = field.shape

    def stage(p):
        ext = torch.zeros((n1 + 1, n2 + 3), dtype=F32)
        if periodic:
            p %= n0
        if 0 <= p < n0:
            ext[:n1, :n2] = field[p]
            if lo is not None:
                ext[:n1, n2] = lo[p]
            if hi is not None:
                ext[:n1, n2 + 1] = hi[p]
        return ext[rows[:, None, :, None], cols[None, :, None, :]]

    return stage


def _crop(tiles, n1, n2):
    """(gy, gx, T1, T2) tiles of one plane -> the (n1, n2) plane."""
    gy, gx = tiles.shape[:2]
    return tiles.permute(0, 2, 1, 3).reshape(gy * T1, gx * T2)[:n1, :n2]


def _valid(n1, n2, gy, gx):
    r = torch.arange(gy)[:, None, None, None] * T1 + torch.arange(T1)[:, None]
    c = torch.arange(gx)[None, :, None, None] * T2 + torch.arange(T2)
    return (r < n1) & (c < n2)


# ------------------------------------------------------------------- K7


def _denom(c, pi, pj, pk):
    di, dj, dk = c - pi, c - pj, c - pk
    return torch.sqrt(EPS_TV + di * di + dj * dj + dk * dk)


def emulate_tv_grad(x, lo=None, hi=None):
    """K7 (K9c with lo and hi) as the kernel marches: (g, partials)."""
    n0, n1, n2 = x.shape
    gx, gy, gz = march.march_grid(n0, n1, n2)
    stage = _stager(x, _rows(n1, gy, True), _cols(n2, gx, True, lo is not None),
                    lo, hi)
    valid = _valid(n1, n2, gy, gx)
    g = torch.empty_like(x)
    partials = torch.empty((gz, gy, gx), dtype=F32)
    mid = (slice(1, -1), slice(1, -1))
    for z in range(gz):
        i_s, i_e = z * C, min(n0, z * C + C)
        prev, cur = stage(i_s - 1), stage(i_s)
        x_jm = prev[..., 1:-1, 1:-1]
        d_jm = _denom(x_jm, prev[..., 1:-1, 2:], cur[(...,) + mid],
                      prev[..., 2:, 1:-1])
        # a thread's sum: rows ty, ty + TY, ... of each plane, in order
        acc = torch.zeros((gy, gx, TY, T2), dtype=F32)
        for i0 in range(i_s, i_e):
            nxt = stage(i0 + 1)
            # D on the region: box rows 0..T1, columns 0..T2
            dreg = _denom(cur[..., :-1, :-1], cur[..., :-1, 1:],
                          nxt[..., :-1, :-1], cur[..., 1:, :-1])
            cv, d = cur[(...,) + mid], dreg[..., 1:, 1:]
            num = 3.0 * cv - cur[..., 1:-1, 2:] - nxt[(...,) + mid] \
                - cur[..., 2:, 1:-1]
            gv = num / d
            gv = gv + (cv - cur[..., 1:-1, :-2]) / dreg[..., 1:, :-1]
            gv = gv + (cv - x_jm) / d_jm
            gv = gv + (cv - cur[..., :-2, 1:-1]) / dreg[..., :-1, 1:]
            g[i0] = _crop(gv, n1, n2)
            sq = torch.where(valid, gv * gv, 0.0)
            for j in range(T1 // TY):
                acc = acc + sq[..., j * TY:(j + 1) * TY, :]
            x_jm, d_jm, cur = cv, d, nxt
        # march_block_sum: the shuffle tree of each warp (a row of threads),
        # then thread 0 adds the warps in order
        for off in (16, 8, 4, 2, 1):
            acc = torch.cat([acc[..., :off] + acc[..., off:2 * off],
                             acc[..., 2 * off:]], dim=-1)
        total = acc[..., 0, 0]
        for w in range(1, TY):
            total = total + acc[..., w, 0]
        partials[z] = total
    return g, partials.reshape(-1)


def _block_sums64(g):
    """Sum of g^2 over each block's voxels in float64, in the partials'
    layout."""
    n0, n1, n2 = g.shape
    gx, gy, gz = march.march_grid(n0, n1, n2)
    pad = torch.zeros((gz * C, gy * T1, gx * T2), dtype=torch.float64)
    pad[:n0, :n1, :n2] = g.double() ** 2
    return pad.reshape(gz, C, gy, T1, gx, T2).sum(dim=(1, 3, 5)).reshape(-1)


@pytest.mark.parametrize("shape", SHAPES)
def test_k7_march_equals_plain(shape):
    x = _rand(shape, 0, offset=0.5)
    g, partials = emulate_tv_grad(x)
    g_ref, gsq_ref = tv_grad_ref(x)
    assert torch.equal(g, g_ref)
    assert partials.numel() == march.grad_partials(*shape)
    np.testing.assert_allclose(partials.double().numpy(),
                               _block_sums64(g_ref).numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(partials.double().sum()), float(gsq_ref),
                               rtol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_k9c_march_equals_plain(shape):
    x = _rand(shape, 1, offset=0.5)
    lo, hi = _rand(shape[:2], 2), _rand(shape[:2], 3)
    g, partials = emulate_tv_grad(x, lo, hi)
    g_ref, gsq_ref = tv_grad_halo_ref(x, lo, hi)
    assert torch.equal(g, g_ref)
    np.testing.assert_allclose(float(partials.double().sum()), float(gsq_ref),
                               rtol=2e-5)


def test_k7_wrap_seam():
    """A sharp seam across every wrap (tests/test_pallas_tv.py's field),
    one chunk boundary included."""
    x = torch.ones((40, 9, 33))
    x[0], x[-1], x[:, 0], x[:, :, -1] = 4.0, -2.0, 3.0, -1.0
    assert torch.equal(emulate_tv_grad(x)[0], tv_grad_ref(x)[0])


# ------------------------------------------------------------------- K3


def emulate_fgp_iter(x, p1, p2, p3, lam, p3_lo=None, hi=None):
    """K3 (K9a with p3_lo and optionally hi = (x_hi, p1_hi, p2_hi, p3_hi))
    as the kernel marches: the new duals in p1's dtype."""
    n0, n1, n2 = x.shape
    gx, gy, gz = march.march_grid(n0, n1, n2)
    halo = p3_lo is not None
    rows, cols = _rows(n1, gy, False), _cols(n2, gx, False, halo)
    his = (None,) * 4 if hi is None else tuple(h.to(F32) for h in hi)
    los = (None, None, None, None if p3_lo is None else p3_lo.to(F32))
    stages = [_stager(f.to(F32), rows, cols, lo, h, periodic=False)
              for f, lo, h in zip((x, p1, p2, p3), los, his)]
    valid = _valid(n1, n2, gy, gx)
    r = torch.arange(gy)[:, None, None, None] * T1 + torch.arange(T1)[:, None]
    c = torch.arange(gx)[None, :, None, None] * T2 + torch.arange(T2)
    has2 = r < n1 - 1
    has3 = (c < n2 - 1) | (hi is not None)
    multip = 1.0 / (26.0 * lam)
    out = [torch.empty(x.shape, dtype=F32) for _ in range(3)]

    def region_d(cur, p1_below):  # box rows 1..T1+1, columns 1..T2+1
        xx, q1, q2, q3 = cur
        div = q1[..., 1:, 1:] - p1_below[..., 1:, 1:]
        div = div + (q2[..., 1:, 1:] - q2[..., :-1, 1:])
        div = div + (q3[..., 1:, 1:] - q3[..., 1:, :-1])
        return torch.clamp_min(xx[..., 1:, 1:] - lam * div, 0.0)

    for z in range(gz):
        i_s, i_e = z * C, min(n0, z * C + C)
        cur = [s(i_s) for s in stages]
        d_cur = region_d(cur, stages[1](i_s - 1))
        for i0 in range(i_s, i_e):
            nxt = [s(i0 + 1) for s in stages]
            d_nxt = region_d(nxt, cur[1])
            d = d_cur[..., :T1, :T2]
            zero = torch.zeros_like(d)
            g1 = d - d_nxt[..., :T1, :T2] if i0 < n0 - 1 else zero
            g2 = torch.where(has2, d - d_cur[..., 1:, :T2], 0.0)
            g3 = torch.where(has3, d - d_cur[..., :T1, 1:], 0.0)
            q = [cur[k + 1][..., 1:-1, 1:-1] + multip * gk
                 for k, gk in enumerate((g1, g2, g3))]
            den = q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
            scale = torch.where(den > 1.0, torch.rsqrt(den), 1.0)
            for k in range(3):
                out[k][i0] = _crop(torch.where(valid, q[k] * scale, 0.0),
                                   n1, n2)
            cur, d_cur = nxt, d_nxt
    return tuple(o.to(p1.dtype) for o in out)


def _duals(shape, seed, dtype):
    return tuple(_rand(shape, seed + k, scale=0.6).to(dtype) for k in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_march_equals_plain(shape, dtype):
    x = _rand(shape, 4, offset=0.5)
    p = _duals(shape, 5, dtype)
    got = emulate_fgp_iter(x, *p, 0.1)
    for a, b in zip(got, fgp_iter_ref(x, *p, 0.1)):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("role", ["bottom", "interior", "top"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k9a_march_equals_plain(shape, dtype, role):
    x = _rand(shape, 8, offset=0.5)
    p = _duals(shape, 9, dtype)
    plane = shape[:2]
    p3_lo = (torch.zeros(plane, dtype=dtype) if role == "bottom"
             else _rand(plane, 12, scale=0.6).to(dtype))
    hi = None if role == "top" else (
        _rand(plane, 13, offset=0.5),
        *(_rand(plane, 14 + k, scale=0.6).to(dtype) for k in range(3)))
    got = emulate_fgp_iter(x, *p, 0.2, p3_lo, hi)
    for a, b in zip(got, fgp_iter_halo_ref(x, *p, 0.2, p3_lo, hi)):
        assert torch.equal(a, b)


def test_k3_chain_of_the_march():
    """Ten emulated iterations from P = 0 stay equal to the plain chain."""
    x = _rand((40, 11, 37), 20, offset=0.5)
    p = q = tuple(torch.zeros(x.shape, dtype=torch.bfloat16)
                  for _ in range(3))
    for _ in range(10):
        p, q = emulate_fgp_iter(x, *p, 0.1), fgp_iter_ref(x, *q, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(p, q))


# -------------------------------------------------------------- the step


@pytest.mark.parametrize("dpocs", [0.3, "tensor"])
def test_tv_step_is_the_expression_tv_gd_used(dpocs):
    x = _rand((6, 9, 13), 30, offset=0.5)
    dp = torch.tensor(0.3) if dpocs == "tensor" else dpocs
    g, gsq = tv_grad_ref(x)
    for clamp in (False, True):
        want = x - dp * g / torch.sqrt(gsq)
        if clamp:
            want = torch.clamp_min(want, 0.0)
        assert torch.equal(tv_step_ref(x, g, gsq, dp, clamp), want)
        assert torch.equal(tv_step(x, g, gsq, dp, clamp), want)
    # tv_gd: ng steps of the expression, then positivity
    for ng in (1, 4):
        want = x
        for _ in range(ng):
            gw, gsqw = tv_grad_ref(want)
            want = want - dp * gw / torch.sqrt(gsqw)
        got, _ = tv_gd(x, ng, dp)
        assert torch.equal(got, torch.clamp_min(want, 0.0))


def test_tv_step_rejects_bad_operands():
    x = torch.ones((4, 5, 6))
    with pytest.raises(ValueError):
        tv_step(x, x[:, :, :5].contiguous(), torch.tensor(1.0), 0.1)
    with pytest.raises(ValueError):
        tv_step(x, x, torch.ones(1), 0.1)
    with pytest.raises(ValueError):
        tv_step(x, x.double(), torch.tensor(1.0), 0.1)
