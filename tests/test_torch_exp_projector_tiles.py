"""E1's staged gather (csrc/exp_projector.cu fp_variant_kernel), emulated.

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
