"""K1's and K2's staging windows (csrc/joseph.cu fp_kernel, bp_kernel).

The kernels gather every tap from a window of their input staged in shared
memory; a window one bin short would drop taps silently. These tests check,
on the host, that the windows cover every tap the plain versions use:

* K2: `cuda_joseph.bp_window_lo` mirrors the window start that bp_kernel
  computes per (tile, angle) from the tile's corners (csrc/joseph.cu, the
  block before the first __syncthreads of bp_kernel); every tap of every
  pixel of the tile must lie in [lo, lo + BP_WINDOW).
* K1: `cuda_joseph.fp_plan` is the table the kernel reads; every tap pair
  of every ray step that touches the volume must lie inside its block's
  window, and a clamped pair must land on zero positions only.

Then a numpy emulation of each kernel's staged gather (the windows, the
zero fill, K1's clamp) is held against tomojax's 'gather' projector.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import bp as j_bp, fp as j_fp  # noqa: E402

from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import cuda_joseph as cj  # noqa: E402

CPU = torch.device("cpu")
ANGLE_SETS = {
    "tilt90": np.linspace(-76, 76, 90),
    "full90": np.arange(0, 180, 2.0),
    "exact": np.array([0.0, 45.0, 90.0, 135.0, 180.0, -45.0, -90.0]),
}
CASES = [(n, extra, name) for n in (16, 33, 48, 256) for extra in (0, 7)
         for name in ANGLE_SETS]


def _geom(n, extra, name):
    return Geometry.make(n, np.deg2rad(ANGLE_SETS[name]), nray=n + extra)


@pytest.mark.parametrize("n,extra,name", CASES)
def test_bp_windows_cover_every_tap(n, extra, name):
    geom = _geom(n, extra, name)
    lo = cj.bp_window_lo(geom)  # (Na, row tiles, column tiles)
    tiles = lo.shape[1]
    side = tiles * cj.BP_TILE  # pixels past N are computed, not stored
    ctr = np.float32(0.5) * np.float32(n - 1)
    px = np.arange(side, dtype=np.float32)
    tab = cj.angle_tables(geom, CPU).bp.numpy()
    j0 = np.floor(cj.bp_jstar(tab, geom.nray, (px - ctr)[None, :],
                              (ctr - px)[:, None])).astype(np.int64)
    lo_px = np.repeat(np.repeat(lo, cj.BP_TILE, axis=1), cj.BP_TILE, axis=2)
    assert (j0 >= lo_px).all()
    assert (j0 + 1 <= lo_px + cj.BP_WINDOW - 1).all()


def _fp_plan_taps(geom, plan):
    """Per group: (members, lo, width, i0) broadcast over (angle, bin,
    step) for the bins < Nt and steps < N that the group's blocks walk."""
    n, nt = geom.n, geom.nray
    tab = cj.angle_tables(geom, CPU).fp.numpy()
    j, k = np.arange(nt), np.arange(n)
    for g, row in enumerate(plan.groups):
        members = row[2:2 + row[1]]
        pos = cj.fp_positions(tab[members], n, nt, j[:, None], k[None, :])
        win = plan.windows[g][j // cj.FP_BINS][:, k // cj.FP_STEPS]
        yield members, win[..., 0], win[..., 1], np.floor(pos).astype(
            np.int64)


@pytest.mark.parametrize("n,extra,name", CASES)
def test_fp_plan_covers_every_tap(n, extra, name):
    geom = _geom(n, extra, name)
    _check_plan_covers(geom, cj.fp_plan(geom, CPU), cj.FP_GROUP)


@pytest.mark.parametrize("group", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("n,extra,name", CASES)
def test_fp_plan_group_caps_cover_every_tap(n, extra, name, group):
    """E1's plans: K1's rule with at most `group` angles a group (E1's ab;
    FP_GROUP = 8 is K1's own, above)."""
    geom = _geom(n, extra, name)
    plan = cj.fp_plan(geom, CPU, group=group)
    assert plan.groups.shape[1] == 2 + group
    _check_plan_covers(geom, plan, group)


@pytest.mark.parametrize("n,extra,name", CASES)
def test_fp_plan_default_group_is_k1s(n, extra, name):
    geom = _geom(n, extra, name)
    a, b = cj.fp_plan(geom, CPU), cj.fp_plan(geom, CPU, group=cj.FP_GROUP)
    assert a.table.numpy().tobytes() == b.table.numpy().tobytes()
    assert a.groups.shape[1] == 2 + cj.FP_GROUP


# sha256 of K1's plan tables over CASES in order, recorded before fp_plan
# took a group cap: K1's blocks must not move when E1's caps are added
K1_PLANS_SHA256 = (
    "f6ec55a0e19461c7b52a0b4b3d6fb45f937c7f3e388d3db90a2dc954a9fdb97b")


def test_k1_plans_as_recorded():
    h = hashlib.sha256()
    for case in CASES:
        h.update(cj.fp_plan(_geom(*case), CPU).table.numpy().tobytes())
    assert h.hexdigest() == K1_PLANS_SHA256


def _check_plan_covers(geom, plan, group):
    n = geom.n
    tab = cj.angle_tables(geom, CPU).fp.numpy()
    seen = np.concatenate([r[2:2 + r[1]] for r in plan.groups])
    np.testing.assert_array_equal(seen, np.arange(geom.nproj))
    assert plan.groups[:, 1].max() <= group
    assert plan.width <= cj.FP_WINDOW
    assert plan.table.dtype == torch.int32
    assert plan.table.numel() == plan.groups.size + plan.windows.size
    for members, lo, width, i0 in _fp_plan_taps(geom, plan):
        assert (tab[members, 3] == tab[members[0], 3]).all()
        touches = (i0 + 1 >= 0) & (i0 <= n - 1)
        inside = (i0 >= lo) & (i0 + 1 <= lo + width - 1)
        assert (inside | ~touches).all(), "an in-volume tap is unstaged"
        i0c = np.clip(i0, lo, lo + width - 2)
        off = ((i0c < 0) | (i0c >= n)) & ((i0c + 1 < 0) | (i0c + 1 >= n))
        assert (off | touches).all(), "a clamped pair reads the volume"


def _emulate_fp(x, geom):
    """K1's staged gather in numpy: per group and step, the window
    [lo, lo + width) of the step's row (or column), zeros outside the
    volume, the tap pair read at the clamped i0, summed in step order."""
    n, nt = geom.n, geom.nray
    plan = cj.fp_plan(geom, CPU)
    tab = cj.angle_tables(geom, CPU).fp.numpy()
    pad = np.zeros((n, n + 8 + 2 * cj.FP_WINDOW, x.shape[-1]), np.float32)
    out = np.zeros((geom.nproj, nt, x.shape[-1]), np.float32)
    for members, lo, width, i0 in _fp_plan_taps(geom, plan):
        pos = cj.fp_positions(tab[members], n, nt, np.arange(nt)[:, None],
                              np.arange(n)[None, :])
        frac = (pos - np.floor(pos)).astype(np.float32)
        i0c = np.clip(i0, lo, lo + width - 2)
        for m, a in enumerate(members):
            src = x if tab[a, 3] else x.transpose(1, 0, 2)  # [step][pos]
            pad[:, cj.FP_WINDOW + 2:cj.FP_WINDOW + 2 + n] = src
            acc = np.zeros((nt, x.shape[-1]), np.float32)
            for k in range(n):
                idx = i0c[m, :, k] + cj.FP_WINDOW + 2
                w1 = frac[m, :, k, None]
                acc = acc + pad[k, idx] * (1 - w1) + pad[k, idx + 1] * w1
            out[a] = acc * tab[a, 2]
    return out


def _emulate_bp(y, geom):
    """K2's staged gather in numpy: per tile and angle, BP_WINDOW bins from
    lo (zeros outside [0, Nt)), the taps of tj::bp_taps read from there."""
    n, nt, ns = geom.n, geom.nray, y.shape[-1]
    lo = cj.bp_window_lo(geom)
    tab = cj.angle_tables(geom, CPU).bp.numpy()
    side = lo.shape[1] * cj.BP_TILE
    ctr = np.float32(0.5) * np.float32(n - 1)
    px = np.arange(side, dtype=np.float32)
    jstar = cj.bp_jstar(tab, nt, (px - ctr)[None, :], (ctr - px)[:, None])
    f = np.floor(jstar)
    invd = tab[:, 2, None, None]
    w0 = np.maximum(0, 1 - np.abs(f - jstar) * invd) * invd
    w1 = np.maximum(0, 1 - np.abs((f + 1) - jstar) * invd) * invd
    rel = f.astype(np.int64) - np.repeat(
        np.repeat(lo, cj.BP_TILE, axis=1), cj.BP_TILE, axis=2)
    out = np.zeros((side, side, ns), np.float32)
    bins = np.arange(cj.BP_WINDOW)
    for a in range(geom.nproj):
        for tr in range(lo.shape[1]):
            for tc in range(lo.shape[2]):
                j = lo[a, tr, tc] + bins
                win = np.where(((j >= 0) & (j < nt))[:, None],
                               y[a, np.clip(j, 0, nt - 1)], 0)
                rs = slice(tr * cj.BP_TILE, (tr + 1) * cj.BP_TILE)
                cs = slice(tc * cj.BP_TILE, (tc + 1) * cj.BP_TILE)
                r = rel[a, rs, cs]
                out[rs, cs] += (win[r] * w0[a, rs, cs, None]
                                + win[r + 1] * w1[a, rs, cs, None])
    return out[:n, :n]


@pytest.mark.parametrize("n,extra,name", [(33, 0, "tilt90"), (24, 7, "exact"),
                                          (48, 0, "full90")])
def test_staged_gathers_match_gather_mode(n, extra, name):
    ang = np.deg2rad(ANGLE_SETS[name])
    if name == "tilt90":
        ang = ang[::12]  # 8 angles keep the loops short
    geom = Geometry.make(n, ang, nray=n + extra)
    jgeom = JGeometry.make(n, ang, nray=n + extra)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, n, 3)).astype(np.float32)
    y = rng.normal(size=(len(ang), n + extra, 3)).astype(np.float32)
    ref_fp = np.asarray(j_fp(jnp.asarray(x.transpose(2, 0, 1)), jgeom,
                             mode="gather")).transpose(1, 2, 0)
    ref_bp = np.asarray(j_bp(jnp.asarray(y.transpose(2, 0, 1)), jgeom,
                             mode="gather")).transpose(1, 2, 0)
    np.testing.assert_allclose(_emulate_fp(x, geom), ref_fp, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_emulate_bp(y, geom), ref_bp, rtol=1e-4,
                               atol=1e-4)


def _emulate_bp_ab(y, geom, ab):
    """K10's ring in numpy: the angle set padded to a multiple of ab with
    zero sinogram rows and zero table entries, staged ab angles a stage,
    per tile and angle BP_WINDOW bins from the window start of the tile's
    corners (zeros outside [0, Nt)), the taps of tj::bp_taps read from
    there and added angle by angle in bp_sl_ref's order."""
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, y.shape[-1]
    na_pad = -(-na // ab) * ab
    tab = np.zeros((na_pad, 4), np.float32)
    tab[:na] = cj.angle_tables(geom, CPU).bp.numpy()
    yp = np.zeros((na_pad, nt, ns), np.float32)
    yp[:na] = y
    f32 = np.float32
    ctr = f32(0.5) * f32(n - 1)
    t0 = np.arange(0, n, cj.BP_TILE, dtype=f32)
    xs = np.stack([t0 - ctr, (t0 + (cj.BP_TILE - 1)) - ctr])
    ys = np.stack([ctr - t0, ctr - (t0 + (cj.BP_TILE - 1))])
    lo = np.floor(cj.bp_jstar(tab, nt, xs[None, None, :, :],
                              ys[:, :, None, None]).min(axis=(1, 3)))
    lo = lo.astype(np.int64)  # (na_pad, row tiles, column tiles)
    np.testing.assert_array_equal(lo[:na], cj.bp_window_lo(geom))
    side = lo.shape[1] * cj.BP_TILE
    px = np.arange(side, dtype=f32)
    jstar = cj.bp_jstar(tab, nt, (px - ctr)[None, :], (ctr - px)[:, None])
    f = np.floor(jstar)
    invd = tab[:, 2, None, None]
    w0 = np.maximum(f32(0), f32(1) - np.abs(f - jstar) * invd) * invd
    w1 = np.maximum(f32(0), f32(1) - np.abs((f + f32(1)) - jstar) * invd) \
        * invd
    out = np.zeros((side, side, ns), np.float32)
    bins = np.arange(cj.BP_WINDOW)
    for g in range(0, na_pad, ab):
        ring = {}
        for a in range(g, g + ab):  # the stage: every angle's windows
            for tr in range(lo.shape[1]):
                for tc in range(lo.shape[2]):
                    j = lo[a, tr, tc] + bins
                    ring[a, tr, tc] = np.where(
                        ((j >= 0) & (j < nt))[:, None],
                        yp[a, np.clip(j, 0, nt - 1)], 0)
        for a in range(g, g + ab):  # the gather, in angle order
            for tr in range(lo.shape[1]):
                for tc in range(lo.shape[2]):
                    rs = slice(tr * cj.BP_TILE, (tr + 1) * cj.BP_TILE)
                    cs = slice(tc * cj.BP_TILE, (tc + 1) * cj.BP_TILE)
                    r = f[a, rs, cs].astype(np.int64) - lo[a, tr, tc]
                    win = ring[a, tr, tc]
                    out[rs, cs] = out[rs, cs] + win[r] * w0[a, rs, cs, None]
                    out[rs, cs] = out[rs, cs] + win[r + 1] * w1[a, rs, cs,
                                                               None]
    return out[:n, :n]


@pytest.mark.parametrize("ab", [3, 6, 32])
@pytest.mark.parametrize("n,extra,name", [(33, 0, "tilt90"),
                                          (24, 7, "exact")])
def test_k10_ring_matches_plain_and_gather_mode(n, extra, name, ab):
    ang = np.deg2rad(ANGLE_SETS[name])
    if name == "tilt90":
        ang = ang[::6]  # 15 angles: a ragged last stage at ab 6 and 32
    geom = Geometry.make(n, ang, nray=n + extra)
    jgeom = JGeometry.make(n, ang, nray=n + extra)
    y = np.random.default_rng(11).normal(
        size=(len(ang), n + extra, 3)).astype(np.float32)
    got = _emulate_bp_ab(y, geom, ab)
    np.testing.assert_array_equal(
        got, cj.bp_sl_ref(torch.from_numpy(y), geom, ab).numpy())
    ref = np.asarray(j_bp(jnp.asarray(y.transpose(2, 0, 1)), jgeom,
                          mode="gather")).transpose(1, 2, 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
