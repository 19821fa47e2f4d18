"""K8's resident route (csrc/sart.cu sart_resident_kernel), emulated.

A cluster of 8 blocks keeps 4 slices of the volume for the whole sweep
(K8's first shape, (8, 4)), or 16 blocks keep 2 (its second, (16, 2),
for 289 <= N <= 528) or 1 (its third, (16, 1), for 529 <= N <= 1052, in
the spilling layout: a block's band rows past `held_rows` in a device
scratch), block r the rows [r R, (r + 1) R), R = ceil(N / blocks). Per
step each block sums every ray's taps that lie in its own rows: a
row-driven angle's steps over its rows, a column-driven angle's steps in
the closed-form range of `cuda_sart.column_steps`, reading 0 for a tap row
outside the band. The blocks' partials are added in block order, scaled by
1/D into the residual, and every pixel takes K8's update.

These tests show, on the host, that every in-volume tap of every (angle,
bin, step) falls in exactly one band, for clusters of 8 and 16 blocks (so
the partials add up to the ray),
hold a torch emulation of the sweep at 8 and 16 bands against the plain
version `sart_sweep_sl_ref` within the bounds `chip_smoke.py` applies to
the kernel, and check the route helper against the sources' list of
shapes. For the spilling layout they show that the blocks' spilled rows
tile the scratch, and that its FP's map of threads to (bin, phase) items
walks every item once.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax_torch import ops  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import cuda_joseph as cj  # noqa: E402
from tomojax_torch.sim import nanocube_phantom  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    make_sart_weights, make_system, to_sl,
)
from tomojax_torch.solvers import cuda_sart as cs  # noqa: E402

CPU = torch.device("cpu")
F32 = np.float32
ANGLE_SETS = {
    "tilt16": np.linspace(-76, 76, 16),
    "full90": np.arange(0, 180, 2.0),
    "exact": np.array([0.0, 45.0, 90.0, 135.0, 180.0, -45.0, -90.0]),
}


def _bands(n, blocks):
    rows = -(-n // blocks)
    return [(min(r * rows, n), min((r + 1) * rows, n)) for r in range(blocks)]


def _taps_counted(geom, a, blocks):
    """How often the bands count each tap of angle a: (2, N steps, Nt) for
    the taps i0 and i0 + 1, with the in-volume mask of each."""
    n, nt = geom.n, geom.nray
    tab = cj.angle_tables(geom, CPU).fp.numpy()
    k, j = np.arange(n)[:, None], np.arange(nt)[None, :]
    pos = cj.fp_positions(tab[[a]], n, nt, j, k)[0]  # (N steps, Nt)
    i0 = np.floor(pos).astype(np.int64)
    taps = np.stack([i0, i0 + 1])
    inside = (taps >= 0) & (taps < n)
    counted = np.zeros(taps.shape, np.int64)
    row_driven = tab[a, 3] != 0
    ctr = F32(0.5) * F32(n - 1)
    u = ctr - (np.arange(nt, dtype=F32) - F32(0.5) * F32(nt - 1)) * tab[a, 0]
    for r0, r1 in _bands(n, blocks):
        if row_driven:  # the band's rows are its steps, every column held
            walked = (k >= r0) & (k < r1)
            counted += walked & inside
        else:  # taps along rows: those in the band, over its step range
            k0, k1 = cs.column_steps(u, tab[a, 1], n, nt, r0, r1)
            walked = (k >= k0[None, :]) & (k < k1[None, :])
            counted += walked & (taps >= r0) & (taps < r1)
    return counted, inside


@pytest.mark.parametrize("blocks", [8, 3, 16])
@pytest.mark.parametrize("name", sorted(ANGLE_SETS))
@pytest.mark.parametrize("n,extra", [(16, 0), (33, 7), (48, 0)])
def test_every_tap_falls_in_exactly_one_band(n, extra, name, blocks):
    geom = Geometry.make(n, np.deg2rad(ANGLE_SETS[name]), nray=n + extra)
    for a in range(geom.nproj):
        counted, inside = _taps_counted(geom, a, blocks)
        np.testing.assert_array_equal(counted, inside.astype(np.int64),
                                      err_msg=f"angle {a}")


def test_column_steps_are_short_ranges():
    """The closed form walks about R / |shear| steps a band, not all N: at
    76 degrees (|shear| 0.25) a band of 32 rows of 256 takes at most 140."""
    geom = Geometry.make(256, np.deg2rad([76.0]))
    tab = cj.angle_tables(geom, CPU).fp.numpy()
    assert tab[0, 3] == 0  # column-driven
    ctr = F32(127.5)
    u = ctr - (np.arange(256, dtype=F32) - F32(127.5)) * tab[0, 0]
    longest = max(int((k1 - k0).max()) for k0, k1 in (
        cs.column_steps(u, tab[0, 1], 256, 256, r0, r1)
        for r0, r1 in _bands(256, cs.BAND_BLOCKS)))
    assert 0 < longest <= 140


def _band_partial(x, t, n, nt, r0, r1):
    """One block's FP partial (Nt, Ns) of an angle with fp table row t: the
    taps of its rows, in the kernel's positions, over its steps."""
    inv_d, shear, _, row_driven = t
    ctr = (n - 1) / 2.0
    steps = torch.arange(n, dtype=torch.float32)
    base = (torch.arange(nt, dtype=torch.float32) - (nt - 1) / 2.0) * inv_d
    k = torch.arange(n)[:, None]
    if row_driven:
        pos = (base[None, :] + (ctr - steps)[:, None] * shear) + ctr
        walked = (k >= r0) & (k < r1)
        lo, hi = 0, n
    else:
        u = ctr - base
        pos = u[None, :] + (steps - ctr)[:, None] * shear
        k0, k1 = cs.column_steps(u.numpy(), shear, n, nt, r0, r1)
        walked = (k >= torch.from_numpy(k0)) & (k < torch.from_numpy(k1))
        lo, hi = r0, r1
    f = torch.floor(pos)
    frac = pos - f
    acc = torch.zeros((nt, x.shape[-1]))
    for tap, w in ((f.long(), 1.0 - frac), (f.long() + 1, frac)):
        held = walked & (tap >= lo) & (tap < hi)
        tc = tap.clamp(0, n - 1)
        v = x[k, tc] if row_driven else x[tc, k]  # (N steps, Nt, Ns)
        acc = acc + torch.where(held[..., None], v * w[..., None], 0.0).sum(0)
    return acc


def emulate_resident_sweep(x, b, geom, inv_row, inv_col_a, beta, order,
                           blocks=cs.BAND_BLOCKS):
    """The resident sweep on the host: per step the bands' partials added in
    block order, scaled by 1/D into the residual, then K8's update; an
    order entry outside [0, Na) leaves x unchanged."""
    n, nt, na = geom.n, geom.nray, geom.nproj
    tabs = cj.angle_tables(geom, CPU)
    fp_tab, bp_tab = tabs.fp.tolist(), tabs.bp.tolist()
    for a in order.tolist():
        if not 0 <= a < na:
            continue
        parts = [_band_partial(x, fp_tab[a], n, nt, r0, r1)
                 for r0, r1 in _bands(n, blocks)]
        ray = parts[0]
        for p in parts[1:]:
            ray = ray + p
        resid = (b[a] - ray * fp_tab[a][2]) * inv_row[a][:, None]
        upd = cj.bp_angle_ref(resid, bp_tab[a], n)
        x = torch.clamp_min(x + beta * inv_col_a[a][:, :, None] * upd, 0.0)
    return x


def _problem(n, na, ns, extra=0):
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)),
                         nray=n + extra)
    sysd = make_system(geom, "cpu")
    vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)))
    return geom, sysd, vol, cj.fp_sl_ref(vol, geom), make_sart_weights(sysd)


@pytest.mark.parametrize("order_kind", ["ordered", "permuted"])
@pytest.mark.parametrize("n,na,ns,extra", [(33, 7, 5, 0), (40, 15, 3, 5)])
def test_emulated_sweep_within_chip_smoke_bounds(n, na, ns, extra,
                                                 order_kind):
    """chip_smoke.py's three levels: one angle step (a column- and a
    row-driven angle) from random x within 1e-5 max|x|; one sweep from zero
    on consistent projections within 1e-4 max|x|; rmse against the phantom
    after 5 sweeps within 1e-4 of the plain version's."""
    _held_to_chip_smoke_bounds(n, na, ns, extra, order_kind, cs.BAND_BLOCKS)


@pytest.mark.parametrize("order_kind", ["ordered", "permuted"])
@pytest.mark.parametrize("n,na,ns,extra", [(33, 7, 5, 0), (40, 15, 3, 5)])
def test_emulated_sweep_at_16_bands_within_chip_smoke_bounds(n, na, ns, extra,
                                                             order_kind):
    """The same three levels with the ray summed over the 16 bands of
    K8's second cluster shape, (16, 2)."""
    assert cs.K8_SHAPES[1][0] == 16
    _held_to_chip_smoke_bounds(n, na, ns, extra, order_kind, 16)


def _held_to_chip_smoke_bounds(n, na, ns, extra, order_kind, blocks):
    geom, sysd, vol, b, w = _problem(n, na, ns, extra)
    args = (b, geom, sysd.inv_row, w, torch.tensor(1.0))
    x = torch.from_numpy(np.random.default_rng(n).random(
        (n, n, ns)).astype(F32))
    for a in (0, na // 2):
        order = torch.tensor([a], dtype=torch.int32)
        ref = cs.sart_sweep_sl_ref(x, *args, order)
        got = emulate_resident_sweep(x, *args, order, blocks)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    order = torch.arange(na, dtype=torch.int32)
    if order_kind == "permuted":
        order = torch.from_numpy(
            np.random.default_rng(5).permutation(na).astype(np.int32))
    x0 = torch.zeros_like(vol)
    ref = cs.sart_sweep_sl_ref(x0, *args, order)
    got = emulate_resident_sweep(x0, *args, order, blocks)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    xe = xp = x0
    for _ in range(5):
        xe = emulate_resident_sweep(xe, *args, order, blocks)
        xp = cs.sart_sweep_sl_ref(xp, *args, order)
    assert abs(float(ops.rmse(xe, vol)) - float(ops.rmse(xp, vol))) <= 1e-4


def test_out_of_range_order_entries_leave_x():
    geom, sysd, vol, b, w = _problem(24, 6, 2)
    args = (b, geom, sysd.inv_row, w, torch.tensor(0.7))
    x = torch.from_numpy(np.random.default_rng(1).random(
        (24, 24, 2)).astype(F32))
    skip = torch.tensor([6, -1, 100], dtype=torch.int32)
    assert torch.equal(emulate_resident_sweep(x, *args, skip), x)
    mixed = torch.tensor([6, 2, -1, 4], dtype=torch.int32)
    assert torch.equal(emulate_resident_sweep(x, *args, mixed),
                       emulate_resident_sweep(
                           x, *args, torch.tensor([2, 4], dtype=torch.int32)))


def test_phase_timing_checks_its_operands():
    """The timed instantiation takes `sart_sweep_sl`'s operands, checked
    before any pointer reaches the card, and only on the card."""
    geom, sysd, vol, b, w = _problem(24, 6, 2)
    args = [vol, b, geom, sysd.inv_row, w, torch.tensor(1.0),
            torch.arange(6, dtype=torch.int32)]
    with pytest.raises(ValueError, match="CUDA"):
        cs.resident_phases(*args)
    args[4] = w[:-1]  # weights of another geometry
    with pytest.raises(ValueError, match="inv_col_a"):
        cs.resident_phases(*args)


def test_route_depends_on_the_shape_alone():
    """The first of K8's shapes that fits: (8, 4) up to N = 288, (16, 2)
    up to N = 528, (16, 1) spilling up to N = 1052 (a row spills from
    N = 919), then streaming."""
    assert cs.K8_SHAPES == ((8, 4), (16, 2), (16, 1))
    assert cs.K8_SPILL == (False, False, True)
    assert cs.resident_smem_bytes(256, 256) == (32 * 260 * 16 + 32 * 256 * 4
                                                + 256 * 68)
    assert cs.resident_smem_bytes(512, 512, 16, 2) == 216064
    assert cs.resident_smem_bytes(528, 528, 16, 2) == 229152
    assert cs.resident_smem_bytes(529, 529, 16, 2) == 235964
    for n in (16, 33, 64, 128, 256, 288):
        assert cs.sart_shape(n, n) == (8, 4), n
        assert cs.sart_route(n, n) == "resident", n
    for n in (289, 320, 512, 528):
        assert cs.sart_shape(n, n) == (16, 2), n
        assert cs.sart_route(n, n) == "resident", n
    for n in (529, 544, 918, 919, 1024, 1040, 1052):
        assert cs.sart_shape(n, n) == (16, 1), n
        assert cs.sart_route(n, n) == "resident", n
    for n in (1053, 1056, 2048):
        assert cs.sart_shape(n, n) is None, n
        assert cs.sart_route(n, n) == "streaming", n
        assert cs.route_spill_rows(n, n) == 0, n
    spilled = {528: 0, 529: 0, 918: 0, 919: 1, 1024: 13, 1052: 16}
    for n, rows in spilled.items():
        assert cs.route_spill_rows(n, n) == rows, n
    assert cs.sart_route(256, 256 + 7) == "resident"
    assert cs.band_rows(256) == 32 and cs.band_rows(33) == 5
    assert cs.band_rows(512, 16) == 32


def test_resident_launch_helpers_refuse_the_streaming_route():
    """`resident_clusters` and `resident_phases` take the shape that
    launches, and raise before any call into the library where K8
    streams."""
    with pytest.raises(ValueError, match="streams at N 1056"):
        cs.resident_clusters(1056, 1056, 8)
    with pytest.raises(ValueError, match="streams at N 1053"):
        cs._resident_shape(1053, 1053)
    assert cs._resident_shape(512, 512) == (16, 2)
    assert cs._resident_shape(529, 529) == (16, 1)
    assert cs._resident_shape(1024, 1024) == (16, 1)


def test_e3_keeps_its_own_route():
    """E3 (exp_sart.cu) has only K8's first shape: resident where (8, 4)
    fits, streaming above, where K8 runs (16, 2)."""
    from tomojax_torch.experiments import cuda_sart_variants as csv

    assert csv.e3_bands(512, 512) == 1 and csv.e3_bands(256, 256) == 8
    for n in (16, 256, 288, 289, 320, 512, 528, 529, 1024, 1052, 1053):
        want = "resident" if n <= 288 else "streaming"
        assert csv.e3_route(n, n) == want, n
        assert (want == "resident") == (
            cs.sart_shape(n, n) == cs.K8_SHAPES[0]), n


# the generalised resident_smem_bytes(n, nt, blocks, sb) at N = Nt: the
# shapes of E4 (csrc/exp_sart_shapes.cu) against the 232,448 B limit
SMEM_TABLE = {
    256: {(8, 4): 183296, (8, 2): 108544, (8, 1): 71168, (16, 4): 100352},
    512: {(8, 1): 273408, (16, 4): 364544, (16, 2): 216064,
          (16, 1): 141824},
}  # (16, 4) at 512: a band of 32 rows alone is 264,192 B


@pytest.mark.parametrize("n", sorted(SMEM_TABLE))
def test_resident_smem_of_every_cluster_shape(n):
    fits = {256: {(8, 4), (8, 2), (8, 1), (16, 4), (16, 2), (16, 1)},
            512: {(16, 2), (16, 1)}}[n]
    for shape, smem in SMEM_TABLE[n].items():
        assert cs.resident_smem_bytes(n, n, *shape) == smem, shape
    for blocks in (8, 16):
        for sb in (1, 2, 4):
            rows = cs.band_rows(n, blocks)
            want = (rows * (n + 4) * 4 * sb + rows * n * 4
                    + n * (16 * sb + 4))
            assert cs.resident_smem_bytes(n, n, blocks, sb) == want
            assert ((blocks, sb) in fits) == (
                want <= cs.RESIDENT_SMEM_MAX), (blocks, sb)
    # K8's shape is the default, and its route turns at N = 288
    assert cs.resident_smem_bytes(n, n) == cs.resident_smem_bytes(n, n, 8, 4)


# the spilling layout at (16, 1), N = Nt: shared memory a block, rows held
# in it and rows spilled to device memory, and whether the shape fits
SPILL_TABLE = {
    529: (83068, 34, 0, True),
    544: (85408, 34, 0, True),
    918: (232264, 58, 0, True),
    919: (228824, 57, 1, True),
    1024: (230192, 51, 13, True),
    1052: (232240, 50, 16, True),
    1053: (228232, 49, 17, False),
}


@pytest.mark.parametrize("n", sorted(SPILL_TABLE))
def test_spilling_layout_of_the_16_1_shape(n):
    """The band rows past `held_rows` go to device memory and inv_col_a is
    not staged: 51 rows of 1028 px (209,712 B) and 20 Nt for the bins'
    planes at 1024², 13 rows spilled; the shape fits while at most a
    quarter of a band spills."""
    smem, held, spilled, fits = SPILL_TABLE[n]
    rows = cs.band_rows(n, 16)
    assert cs.resident_smem_bytes(n, n, 16, 1, spill=True) == smem
    assert smem == held * (n + cs.BAND_PAD) * 4 + 20 * n
    assert smem <= cs.RESIDENT_SMEM_MAX
    assert cs.held_rows(n, n, 16, 1) == held
    assert rows - held == spilled
    assert cs.shape_fits(n, n, 16, 1, spill=True) is fits
    assert (4 * spilled <= rows) is fits
    # one more held row would not fit beside the bins' planes
    assert held == rows or (held + 1) * (n + cs.BAND_PAD) * 4 + 20 * n > (
        cs.RESIDENT_SMEM_MAX)
    # no staged layout of K8's earlier shapes holds these planes
    assert not cs.shape_fits(n, n, 16, 2)
    if fits:
        assert cs.route_spill_rows(n, n) == spilled


@pytest.mark.parametrize("n, ns", [(1024, 3), (919, 2), (1052, 1)])
def test_spilled_rows_tile_the_scratch(n, ns):
    """The kernel's addressing of the spilled pixels: block b (b = cluster
    16 + rank) keeps pixel p of its band (p = (row - r0) N + column) at
    spill[b spill_rows N + p - held N] for p >= held N. Every spilled pixel
    of every band of every slice lands in one place of the (Ns, 16,
    spill_rows, N) scratch, and each place holds one pixel."""
    blocks = 16
    rows = cs.band_rows(n, blocks)
    held, spilled = cs.held_rows(n, n, blocks, 1), cs.route_spill_rows(n, n)
    assert spilled == rows - held > 0
    seen = np.zeros(ns * blocks * spilled * n, np.int64)
    held_px = 0
    for s in range(ns):
        for rank in range(blocks):
            r0, r1 = min(rank * rows, n), min((rank + 1) * rows, n)
            px = max(r1 - r0, 0) * n
            p = np.arange(held * n, max(px, held * n))
            seen[(s * blocks + rank) * spilled * n + p - held * n] += 1
            held_px += min(px, held * n)
    assert seen.max(initial=0) <= 1
    assert held_px + int(seen.sum()) == ns * n * n  # the plane, once


# csrc/sart_resident.cuh R_NT and csrc/sart.cu R_CHAINS
R_NT, R_CHAINS = 512, 4


@pytest.mark.parametrize("nt", [1024, 1031, 544, 64])
def test_fp_items_cover_every_bin_once(nt):
    """The spilling shape's FP: at a row-driven angle thread tid walks, in
    phase tid & 1, the bins j0 + 64 w + l + 16 q together (q < 4, w = tid
    / 32, l = tid / 2 mod 16, j0 = 0, 1024, ...); at a column-driven one
    the bin j0 + tid / 2 a round (j0 = 0, 256, ...). Either way every
    (bin, phase) is walked once; the chains of a thread lie 16 bins apart,
    the 16 lane pairs of a warp walk 16 neighbouring bins at each chain,
    and a column-driven round's bins are neighbours across the block."""
    seen = {}
    for j0 in range(0, nt, R_CHAINS * R_NT // 2):
        for tid in range(R_NT):
            g = R_CHAINS * 16 * (tid >> 5) + ((tid >> 1) & 15)
            bins = [j0 + g + 16 * q for q in range(R_CHAINS)]
            assert np.diff(bins).tolist() == [16] * (R_CHAINS - 1)
            for j in bins:
                if j < nt:
                    seen[(j, tid & 1)] = seen.get((j, tid & 1), 0) + 1
    assert seen == {(j, ph): 1 for j in range(nt) for ph in (0, 1)}
    seen = {}
    for j0 in range(0, nt, R_NT // 2):
        for tid in range(R_NT):
            j = j0 + (tid >> 1)
            if j < nt:
                seen[(j, tid & 1)] = seen.get((j, tid & 1), 0) + 1
    assert seen == {(j, ph): 1 for j in range(nt) for ph in (0, 1)}
    for q in range(R_CHAINS):  # warp 3's lanes at chain q
        lanes = sorted({3 * 64 + ((tid >> 1) & 15) + 16 * q
                        for tid in range(96, 128)})
        assert lanes == list(range(lanes[0], lanes[0] + 16))


def test_resident_constants_match_the_source():
    """The Python mirrors of the resident sweep's constants equal the
    sources' (sart_resident.cuh for the sweep, sart.cu for K8's list of
    shapes, exp_sart.cu for E3's one shape, exp_sart_shapes.cu for
    E4's)."""
    from tomojax_torch.experiments import cuda_sart_variants as csv

    csrc = Path(cs.__file__).resolve().parents[1] / "csrc"
    text = (csrc / "sart_resident.cuh").read_text()
    for name, value in (("RESIDENT_SMEM_MAX", cs.RESIDENT_SMEM_MAX),
                        ("R_PAD", cs.BAND_PAD),
                        ("R_PHASES", len(cs.PHASES)), ("R_NT", R_NT)):
        m = re.search(rf"constexpr \w+ {name} = (\d+);", text)
        assert m is not None and int(m.group(1)) == value, name
    m = re.search(r"constexpr float STEP_SLACK = ([0-9.e+-]+)f;", text)
    assert m is not None and float(m.group(1)) == cs.STEP_SLACK
    m = re.search(r"constexpr int R_SHAPES\[(\d+)\]\[3\] = \{(.*)\};",
                  (csrc / "sart.cu").read_text())
    assert m is not None
    rows = re.findall(r"\{(\d+), (\d+), ([01])\}", m.group(2))
    listed = tuple((int(b), int(s)) for b, s, _ in rows)
    assert listed == cs.K8_SHAPES and int(m.group(1)) == len(listed)
    assert tuple(f == "1" for _, _, f in rows) == cs.K8_SPILL
    m = re.search(r"constexpr int R_CHAINS = (\d+);",
                  (csrc / "sart.cu").read_text())
    assert m is not None and int(m.group(1)) == R_CHAINS
    body = (csrc / "exp_sart.cu").read_text()
    for name, value in (("E_BLOCKS", cs.BAND_BLOCKS),
                        ("E_SLICES", cs.CLUSTER_SLICES)):
        m = re.search(rf"constexpr int {name} = (\d+);", body)
        assert m is not None and int(m.group(1)) == value, name
    shapes = (csrc / "exp_sart_shapes.cu").read_text()
    found = set(map(tuple, re.findall(
        r"if \(blocks == (\d+) && sb == (\d+)\) return", shapes)))
    assert {(int(b), int(s)) for b, s in found} == set(csv.E4_SHAPES)
