"""E1's and E2's staged gathers (csrc/exp_projector.cu fp_variant_kernel,
bp_variant_kernel), emulated.

E1 walks K1's host plan (`cuda_joseph.fp_plan` with at most `ab` angles a
group): per group and driving step it stages the window [lo, lo + width)
of the step's row (row-driven) or column (column-driven), zeros outside the
volume, and reads a tap pair at the clamped index min(max(i0, lo),
lo + width - 2), while the pair's weights come from the true tap i0. NODOT
reads nothing. PAIR walks the angles Na/2 .. Na-1 and also stages the
mirrored window (row N-1-k, or rows N-1-i of column k). A numpy emulation
of that gather, in every weight form, equals the plain version
`fp_variant_ref` bit for bit: both round each float32 operation alone, in
the same order.

E2 is K2's block: per 16 x 16 tile and angle it stages 24 bins from the
window start of `cuda_joseph.bp_window_lo` (zeros outside [0, Nt)), 8
angles a ring stage, and each pixel reads its taps floor(J*), floor(J*) + 1
from there with the weights of its form; APS 2 reads two angles' taps
before adding them in angle order. Its emulation equals `bp_variant_ref`
bit for bit in every form.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax_torch.experiments import (  # noqa: E402
    cuda_projector_variants as cpv,
)
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import cuda_joseph as cj  # noqa: E402

CPU = torch.device("cpu")
F32 = np.float32
ANGLE_SETS = {
    "tilt16": np.linspace(-76, 76, 16),
    "exact": np.array([0.0, 45.0, 90.0, 135.0, 180.0, -45.0, -90.0]),
}
PAIR_SETS = {  # theta[Na-1-i] = -theta[i]
    "sym16": np.linspace(-76, 76, 16),
    "sym_exact": np.array([-90.0, -45.0, 0.0, 0.0, 45.0, 90.0]),
}
CAPS = (1, 4, 8, 32)  # angles a group, E1's ab


def _bf16(v):
    """float32 rounded to bfloat16 (nearest, ties to even), as float32."""
    b = np.asarray(v, F32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(
        0xFFFF0000)
    return b.view(F32)


def _weight(form, jf, jstar, invd):
    """tj::xp::weight<FORM> in numpy float32."""
    invd = F32(invd)
    if form == "NOHAT":
        return np.full(jstar.shape, invd * F32(0.5), F32)
    if form == "W4":
        inv2 = invd * invd
        return np.maximum(F32(0), invd - np.abs(jf * inv2 - inv2 * jstar))
    d = jf - jstar
    if form == "HAT5":
        u = d * invd
        return np.maximum(F32(0), np.minimum(F32(1) - u, F32(1) + u))
    if form == "BF16":
        ub = _bf16(d * invd)
        return np.maximum(F32(0), _bf16(F32(1) - np.abs(ub)))
    return np.maximum(F32(0), F32(1) - np.abs(d) * invd) * invd


def _emulate_e1(x, geom, form, ab, pair=False):
    """E1's blocks in numpy: the plan's groups and windows, the staged (and,
    with pair, mirrored) rows with zeros outside the volume, weights from
    the true tap, values from the clamped index, summed in step order."""
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, x.shape[-1]
    tabs = cj.angle_tables(geom, CPU)
    tf, tb = tabs.fp.numpy(), tabs.bp.numpy()
    plan = cpv.fp_variant_plan(geom, ab, pair, CPU)
    a0 = na // 2 if pair else 0
    ctr = F32(0.5) * F32(n - 1)
    j, k = np.arange(nt)[:, None], np.arange(n)[None, :]
    jf, kf = j.astype(F32), k.astype(F32)
    guard = cj.FP_WINDOW + 2  # zero positions on each side of the volume
    out = np.zeros((na, nt, ns), F32)
    for g, row in enumerate(plan.groups):
        win = plan.windows[g][j // cj.FP_BINS, k // cj.FP_STEPS]  # (nt, n, 2)
        lo, width = win[..., 0].astype(np.int64), win[..., 1]
        for m in row[2:2 + row[1]]:
            a = a0 + m
            rd = bool(row[0])
            f = np.floor(cj.fp_positions(tf[[a]], n, nt, j, k)[0])
            js = []
            for tap in (f, f + F32(1)):
                if rd:  # pixel (row k, column tap)
                    js.append(cj.bp_jstar(tb[[a]], nt, tap - ctr, ctr - kf)[0])
                else:  # pixel (row tap, column k)
                    js.append(cj.bp_jstar(tb[[a]], nt, kf - ctr, ctr - tap)[0])
            w0, w1 = (_weight(form, jf, s, tb[a, 2]) for s in js)
            if form == "NODOT":  # the weights alone, nothing read
                acc = np.zeros(nt, F32)
                for s in range(n):
                    acc = acc + w0[:, s]
                    acc = acc + w1[:, s]
                out[a] = acc[:, None]
                continue
            i0 = np.clip(f.astype(np.int64) - lo, 0, width - 2) + lo + guard
            srcs = [x if rd else x.transpose(1, 0, 2)]  # [step][position]
            if pair:
                srcs.append(x[::-1] if rd else x[::-1].transpose(1, 0, 2))
            for src, dst in zip(srcs, (a, na - 1 - a)):
                staged = np.zeros((n, n + 2 * guard, ns), F32)
                staged[:, guard:guard + n] = src
                acc = np.zeros((nt, ns), F32)
                for s in range(n):
                    acc = acc + w0[:, s, None] * staged[s, i0[:, s]]
                    acc = acc + w1[:, s, None] * staged[s, i0[:, s] + 1]
                out[dst] = acc * tb[a, 2] if form in ("HAT5", "BF16") else acc
    return out


def _x(n, seed):
    return np.random.default_rng(seed).normal(size=(n, n, 3)).astype(F32)


@pytest.mark.parametrize("form", cpv.FORMS)
@pytest.mark.parametrize("name", sorted(ANGLE_SETS))
@pytest.mark.parametrize("n,extra", [(16, 0), (16, 7), (33, 0), (33, 7)])
def test_staged_e1_matches_plain(n, extra, name, form):
    geom = Geometry.make(n, np.deg2rad(ANGLE_SETS[name]), nray=n + extra)
    x = _x(n, n + extra)
    want = cpv.fp_variant_ref(torch.from_numpy(x), geom, form).numpy()
    for ab in CAPS:
        np.testing.assert_array_equal(_emulate_e1(x, geom, form, ab), want,
                                      err_msg=f"ab={ab}")


@pytest.mark.parametrize("name", sorted(PAIR_SETS))
@pytest.mark.parametrize("n,extra", [(16, 0), (16, 7), (33, 0), (33, 7)])
def test_staged_e1_pair_matches_plain(n, extra, name):
    geom = Geometry.make(n, np.deg2rad(PAIR_SETS[name]), nray=n + extra)
    x = _x(n, 2 * n + extra)
    want = cpv.fp_variant_ref(torch.from_numpy(x), geom, pair=True).numpy()
    for ab in CAPS:
        np.testing.assert_array_equal(_emulate_e1(x, geom, "FULL", ab, True),
                                      want, err_msg=f"ab={ab}")


BP_STAGE = 8  # E2's angles a ring stage (csrc/staging.cuh BP_G)


def _emulate_e2(y, geom, form, aps=1):
    """E2's blocks in numpy: per tile and angle BP_WINDOW bins from the
    tile's window start, zeros outside [0, Nt); per pixel the taps of J*,
    the weights of `form` (NODOT: the weights alone), the values read from
    the staged window (times invd for BF16); the ring's stages of BP_STAGE
    angles, two angles' reads before their sums with aps 2, the angles
    added in order."""
    n, nt, na, ns = geom.n, geom.nray, geom.nproj, y.shape[-1]
    tab = cj.angle_tables(geom, CPU).bp.numpy()
    lo = cj.bp_window_lo(geom)  # (Na, row tiles, column tiles)
    tiles = lo.shape[1]
    side = tiles * cj.BP_TILE  # pixels past N are computed, not stored
    ctr = F32(0.5) * F32(n - 1)
    px = np.arange(side, dtype=F32)
    jstar = cj.bp_jstar(tab, nt, (px - ctr)[None, :], (ctr - px)[:, None])
    f = np.floor(jstar)  # (Na, rows, columns)
    tr, tc = np.meshgrid(np.arange(side) // cj.BP_TILE,
                         np.arange(side) // cj.BP_TILE, indexing="ij")
    bins = np.arange(cj.BP_WINDOW)
    acc = np.zeros((side, side) if form == "NODOT" else (side, side, ns),
                   F32)
    for g in range(0, na, BP_STAGE):
        stage = list(range(g, min(g + BP_STAGE, na)))
        ring = {}
        for a in stage:  # the stage: every tile's window of every angle
            j = lo[a][:, :, None] + bins  # (tiles, tiles, BP_WINDOW)
            ring[a] = np.where(((j >= 0) & (j < nt))[..., None],
                               y[a, np.clip(j, 0, nt - 1)], F32(0))
        # aps 2: pairs of the stage, its odd last angle alone
        for step in (stage[i:i + aps] for i in range(0, len(stage), aps)):
            reads = []
            for a in step:  # every read of the step first
                invd = tab[a, 2]
                w0 = _weight(form, f[a], jstar[a], invd)
                w1 = _weight(form, f[a] + F32(1), jstar[a], invd)
                if form == "NODOT":
                    reads.append((w0, w1, None, None))
                    continue
                rel = f[a].astype(np.int64) - lo[a][tr, tc]
                assert rel.min() >= 0 and rel.max() <= cj.BP_WINDOW - 2
                v0, v1 = ring[a][tr, tc, rel], ring[a][tr, tc, rel + 1]
                if form == "BF16":
                    v0, v1 = v0 * invd, v1 * invd
                reads.append((w0, w1, v0, v1))
            for w0, w1, v0, v1 in reads:  # then the sums, in angle order
                if form == "NODOT":
                    acc = acc + w0
                    acc = acc + w1
                else:
                    acc = acc + w0[..., None] * v0
                    acc = acc + w1[..., None] * v1
    if form == "NODOT":
        acc = np.repeat(acc[..., None], ns, axis=-1)
    return acc[:n, :n]


@pytest.mark.parametrize("form", (*cpv.BP_FORMS, "APS2"))
@pytest.mark.parametrize("name", sorted(ANGLE_SETS))
@pytest.mark.parametrize("n,extra", [(16, 0), (16, 7), (33, 0), (33, 7)])
def test_staged_e2_matches_plain(n, extra, name, form):
    geom = Geometry.make(n, np.deg2rad(ANGLE_SETS[name]), nray=n + extra)
    y = np.random.default_rng(3 * n + extra).normal(
        size=(geom.nproj, geom.nray, 3)).astype(F32)
    aps = 2 if form == "APS2" else 1
    fm = "FULL" if aps == 2 else form
    want = cpv.bp_variant_ref(torch.from_numpy(y), geom, fm)
    got = torch.from_numpy(_emulate_e2(y, geom, fm, aps))
    assert torch.equal(got, want)


def test_pair_plan_walks_the_second_half():
    """PAIR's plan is K1's plan of the angles Na/2 .. Na-1, indexed from 0."""
    geom = Geometry.make(24, np.deg2rad(PAIR_SETS["sym16"]))
    half = Geometry.make(24, np.deg2rad(PAIR_SETS["sym16"][8:]))
    for ab in CAPS:
        got = cpv.fp_variant_plan(geom, ab, True, CPU)
        want = cj.fp_plan(half, CPU, group=ab)
        assert torch.equal(got.table, want.table)
        seen = np.concatenate([r[2:2 + r[1]] for r in got.groups])
        np.testing.assert_array_equal(seen, np.arange(8))
