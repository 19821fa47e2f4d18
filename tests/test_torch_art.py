"""tomojax_torch ART (A1's plain version, ``art_sweep``, ``TomoTorch.art``)
held against tomojax, and A1 against its plain version on the card.

The reference's ``art_sweep`` is an XLA scan of one ray a step; the port's
plain version computes the same float32 positions, weights and updates
(batched over the rays) and sums each ray's dot product in another order,
so one sweep is held at 1e-5 of the largest magnitude of the result. The
kernel on the card rounds like the plain version but for the order of its
sums: one ray step is held at 1e-6, one sweep at 1e-4 of the largest
magnitude, and two kernel sweeps must agree bit for bit.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import TomoTPU  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import make_system as j_sys  # noqa: E402
from tomojax.solvers.iterative import art_sweep as j_art  # noqa: E402

from tomojax_torch import TomoTorch  # noqa: E402
from tomojax_torch.convert import system_from_numpy  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector.cuda_joseph import fp_sl  # noqa: E402
from tomojax_torch.sim import nanocube_phantom, shepp_logan  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    art_sweep, art_sweep_sl, cuda_art, from_sl, row_norms_sq, to_sl,
)

# (N, Na, Ns, Nt, span): a ragged detector (Nt != N), exact 0/90 degree
# views among others, and a row- and column-driven mix
SHAPES = [(16, 6, 3, 16, 70), (20, 7, 4, 27, 76), (17, 5, 3, 17, 90)]


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _problem(n, na, ns, nt, span, seed=0):
    ang = np.deg2rad(np.linspace(-span, span, na))
    jgeom, geom = JGeometry.make(n, ang, nt), Geometry.make(n, ang, nt)
    jsys = j_sys(jgeom)
    sysd = system_from_numpy(geom, np.asarray(jsys.row_sum),
                             np.asarray(jsys.col_sum),
                             np.asarray(jsys.lipschitz), "cpu")
    rng = np.random.default_rng(seed)
    vol = nanocube_phantom(ns, n, seed=seed)
    b = np.array(j_fp(jnp.asarray(vol), jgeom))
    b += rng.uniform(0.0, 0.05, size=b.shape).astype(np.float32)
    return jsys, sysd, vol, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("start", ["zero", "random"])
def test_art_sweep_sequential_matches_reference(shape, start):
    jsys, sysd, vol, b = _problem(*shape)
    rng = np.random.default_rng(1)
    x0 = (np.zeros_like(vol) if start == "zero"
          else rng.uniform(0, 1, size=vol.shape).astype(np.float32))
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 1.0))
    got = art_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 1.0)
    assert got.shape == vol.shape and got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_art_sweep_permutation_matches_reference(shape):
    jsys, sysd, vol, b = _problem(*shape, seed=2)
    rays = shape[1] * shape[3]
    perm = np.random.default_rng(3).permutation(rays).astype(np.int32)
    x0 = np.zeros_like(vol)
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 0.7,
                           jnp.asarray(perm)))
    got = art_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 0.7,
                    perm)
    _close(got.numpy(), ref, 1e-5)
    # a partial order: every other ray
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 1.0,
                           jnp.asarray(perm[::2])))
    got = art_sweep(torch.from_numpy(x0), torch.from_numpy(b), sysd, 1.0,
                    perm[::2])
    _close(got.numpy(), ref, 1e-5)


def test_art_taps_are_the_joseph_rows():
    """The rows the sweep walks are A's rows: the taps of every ray give
    the forward projection (K1's plain version), and nsq their squared
    norms (solvers.base.row_norms_sq)."""
    n, na, ns, nt, span = SHAPES[1]
    _, sysd, vol, _ = _problem(n, na, ns, nt, span)
    p0, p1, w0, w1, nsq = cuda_art.art_taps(sysd.geom, "cpu")
    xf = to_sl(torch.from_numpy(vol)).reshape(n * n, ns)
    ax = (xf[p0] * w0[..., None] + xf[p1] * w1[..., None]).sum(1)
    _close(ax.reshape(na, nt, ns).numpy(),
           fp_sl(to_sl(torch.from_numpy(vol)), sysd.geom).numpy(), 1e-5)
    _close(nsq.reshape(na, nt).numpy(),
           row_norms_sq(sysd.geom, "cpu").numpy(), 1e-5)


def test_art_plain_version_rejects_bad_orders():
    _, sysd, vol, b = _problem(*SHAPES[0])
    x, bs = to_sl(torch.from_numpy(vol)), to_sl(torch.from_numpy(b))
    rays = SHAPES[0][1] * SHAPES[0][3]
    for bad in ([rays], [-1]):
        with pytest.raises(ValueError, match="outside"):
            art_sweep_sl(x, bs, sysd.geom, 1.0,
                         torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="order"):
        art_sweep_sl(x, bs, sysd.geom, 1.0, torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        art_sweep_sl(x, bs, sysd.geom, 1.0, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="slices"):
        art_sweep_sl(x, bs, sysd.geom, 1.0,
                     torch.zeros(3, dtype=torch.int32), slices=6)
    assert cuda_art.art_max_n(8) == 512 and cuda_art.art_max_n(1) == 4096
    assert [cuda_art.art_slices(n) for n in (33, 1024, 4096)] == [
        cuda_art.ART_SLICES, 2, 1]
    with pytest.raises(ValueError, match="N <= 4096"):
        cuda_art.art_slices(4097)


def test_art_timing_variants_take_card_tensors_only():
    """The split of A1's time (art_variant, art_phases) runs the kernel or
    raises: no plain path for CPU tensors; an unknown variant raises."""
    _, sysd, vol, b = _problem(*SHAPES[0])
    x, bs = to_sl(torch.from_numpy(vol)), to_sl(torch.from_numpy(b))
    order = torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_art.art_variant(x, bs, sysd.geom, 1.0, order, "NOLOAD")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_art.art_phases(x, bs, sysd.geom, 1.0, order)
    with pytest.raises(KeyError):
        cuda_art.VARIANTS["NOSUCH"]
    assert cuda_art.VARIANTS["CHAIN"] == (cuda_art.VARIANTS["NOLOAD"]
                                          | cuda_art.VARIANTS["NOSTORE"]
                                          | cuda_art.VARIANTS["NOPREF"])


def _series(ns=8, n=24, angles=np.linspace(-70, 70, 11)):
    rng = np.random.default_rng(1)
    ph = np.stack([shepp_logan(n)] * ns) * rng.uniform(
        0.8, 1.2, size=(ns, 1, 1)).astype(np.float32)
    b = np.asarray(j_fp(jnp.asarray(ph), JGeometry.make(n,
                                                        np.deg2rad(angles))))
    return angles, np.transpose(b, (0, 2, 1))


def test_tomotorch_art_matches_tomotpu():
    angles, ts = _series()
    ref = TomoTPU(angles, ts).art(Niter=2, beta=0.8)
    got = TomoTorch(angles, ts, device="cpu").art(Niter=2, beta=0.8)
    _close(got.get_recon(), ref.get_recon(), 1e-5)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-4)
    assert got.cost[-1] < got.cost[0]
    quiet = TomoTorch(angles, ts, device="cpu").art(show_convergence=False)
    np.testing.assert_array_equal(quiet.cost, np.zeros(1, np.float32))


def test_tomotorch_randart_draws_permutations_from_seed_zero():
    """randART: each sweep a permutation of the rays from the instance's
    torch generator (seed 0, as the reference's PRNGKey(0); the streams
    differ), each sweep equal to the reference's sweep over that order."""
    angles, ts = _series()
    tomo = TomoTorch(angles, ts, device="cpu").art(Niter=2,
                                                   random_order=True)
    gen = torch.Generator().manual_seed(0)
    rays = len(angles) * ts.shape[1]
    orders = [torch.randperm(rays, generator=gen).numpy().astype(np.int32)
              for _ in range(2)]
    assert not np.array_equal(orders[0], orders[1])
    jgeom = JGeometry.make(ts.shape[1], np.deg2rad(angles))
    jsys = j_sys(jgeom)
    x = jnp.zeros((ts.shape[0], ts.shape[1], ts.shape[1]), jnp.float32)
    b = jnp.asarray(np.transpose(ts, (0, 2, 1)))
    for order in orders:
        x = j_art(x, b, jsys, 1.0, jnp.asarray(order))
    _close(tomo.get_recon(), np.asarray(x), 1e-5)


@pytest.mark.cuda
def test_art_kernel_matches_plain_on_card():
    """A1 against its plain version on the card: one ray step from random
    x (1e-6 max|x|), one sweep from zero in the angle-major, a random and
    the mixed order (1e-4 max|x|), two sweeps bit for bit, out-of-range
    rays skipped, every slices-a-block instantiation, at N 33 / Na 7 / Ns
    5 and on a ragged detector."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for n, na, ns, nt in ((33, 7, 5, 33), (24, 9, 19, 31)):
        geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)), nt)
        vol = to_sl(torch.from_numpy(nanocube_phantom(ns, n)).to(dev))
        b = fp_sl(vol, geom)
        x = torch.rand((n, n, ns), generator=gen, device=dev)
        seq = torch.arange(na * nt, dtype=torch.int32, device=dev)
        x0 = torch.zeros_like(vol)
        mixed = torch.from_numpy(cuda_art.mixed_order(na, nt)).to(dev)
        perm = torch.randperm(na * nt, generator=torch.Generator().manual_seed(
            0)).to(device=dev, dtype=torch.int32)
        orders = [(o, cuda_art.art_sweep_sl_ref(x0, b, geom, 1.0, o))
                  for o in (seq, perm, mixed)]
        for slices in cuda_art.SLICES:
            for r in (0, nt // 2, (na // 2) * nt + 3):
                one = seq[r:r + 1]
                got = art_sweep_sl(x, b, geom, 1.0, one, slices)
                ref = cuda_art.art_sweep_sl_ref(x, b, geom, 1.0, one)
                assert float((got - ref).abs().max()) <= \
                    1e-6 * float(ref.abs().max())
            for order, ref in orders:
                got = art_sweep_sl(x0, b, geom, 1.0, order, slices)
                assert float((got - ref).abs().max()) <= \
                    1e-4 * float(ref.abs().max())
                assert torch.equal(
                    art_sweep_sl(x0, b, geom, 1.0, order, slices), got)
            skip = torch.tensor([na * nt, -1], dtype=torch.int32, device=dev)
            assert torch.equal(art_sweep_sl(x, b, geom, 1.0, skip, slices), x)


# ---------------------------------------------------------------------------
# A1's schedule (csrc/art.cuh), emulated in plain PyTorch: step m belongs to
# step group m % G (cuda_art.art_groups); where ray k + 1 keeps ray k's
# driving axis its taps are computed while k reduces and the pixels that k
# does not hold are loaded then (before k's stores); k's update takes the
# shared pixels (clipped taps included) from "registers"; a pixel that
# k + 1 carries is not stored by k; any other successor (a change of axis,
# an out-of-range entry, the end) fetches its pixels after k's stores, a
# change of axis after a barrier.


class _Hazard(AssertionError):
    pass


def _emulate_schedule(x, b, geom, beta, order, slices, carry_rule=True,
                      axis_barrier=True):
    """One sweep as A1 schedules it, on the CPU: returns (x, a count of
    rays by fetch kind). Raises _Hazard where a read could see a value
    that another step group wrote since the last barrier, a value that is
    stale in memory (held in registers, not yet stored), or, loading ahead,
    a pixel that the current ray is about to write. carry_rule=False loads
    all of the next ray's pixels ahead; axis_barrier=False leaves out the
    barrier at a change of driving axis (both for the test that the checks
    bite)."""
    n, ns = geom.n, x.shape[-1]
    rays = geom.nproj * geom.nray
    p0s, p1s, w0s, w1s, nsqs = cuda_art.art_taps(geom, "cpu")
    rds = cuda_art.art_table(geom, torch.device("cpu"))[:, 3] != 0
    groups = cuda_art.art_groups(n, slices)
    steps = torch.arange(n)
    mem = x.reshape(n * n, ns).clone()
    bf = b.reshape(rays, ns)
    writer = torch.full((n * n,), -1)  # step group of the last store
    written = torch.full((n * n,), -1)  # barrier epoch of the last store
    held = torch.zeros(n * n, dtype=torch.bool)  # values only in registers
    epoch, owner = 0, steps % groups
    order = [int(r) for r in order]
    valid = [0 <= r < rays for r in order]

    def read(p, where, busy=None):
        p = p[where]
        if busy is not None and bool(busy[p].any()):
            raise _Hazard("loaded ahead a pixel the current ray writes")
        if bool(held[p].any()):
            raise _Hazard("a stale pixel read from memory")
        w = writer[p]
        if bool(((w >= 0) & (w != owner[where]) & (written[p] == epoch))
                .any()):
            raise _Hazard("a pixel another step group wrote, no barrier")
        out = torch.zeros((n, ns))
        out[where] = mem[p]
        return out

    have, prev_rd, kinds = False, None, collections.Counter()
    for k, r in enumerate(order):
        if not valid[k]:
            epoch += 1  # the ray's barrier; x stays
            have = False
            kinds["skipped"] += 1
            continue
        rd = bool(rds[r])
        if not have:  # the full fetch
            if axis_barrier and prev_rd is not None and rd != prev_rd:
                epoch += 1
            p0, p1, w0, w1 = p0s[r], p1s[r], w0s[r], w1s[r]
            v0, v1 = read(p0, steps >= 0), read(p1, steps >= 0)
            kinds["fetched"] += 1
        else:
            kinds["carried"] += 1
        prev_rd = rd
        r1 = order[k + 1] if k + 1 < len(order) else -1
        carry = k + 1 < len(order) and valid[k + 1] and bool(rds[r1]) == rd
        if carry:  # ray k + 1's new pixels, loaded before k's stores
            q0, q1 = p0s[r1], p1s[r1]
            new0 = (q0 != p0) & (q0 != p1) | (not carry_rule)
            new1 = (q1 != p0) & (q1 != p1) | (not carry_rule)
            busy = torch.zeros(n * n, dtype=torch.bool)
            busy[p0], busy[p1] = True, True
            l0, l1 = read(q0, new0, busy), read(q1, new1, busy)
        epoch += 1  # the ray's barrier
        dot = (v0 * w0[:, None] + v1 * w1[:, None]).sum(0)
        coeff = beta * (bf[r] - dot) / torch.clamp_min(nsqs[r], 1e-12)
        same = (p0 == p1)[:, None]
        u0 = v0 + coeff * w0[:, None]
        u0 = torch.where(same, u0 + coeff * w1[:, None], u0)
        u1 = torch.where(same, u0, v1 + coeff * w1[:, None])
        none = torch.zeros(n, dtype=torch.bool)
        keep0 = (p0 == q0) | (p0 == q1) if carry else none
        keep1 = (p1 == q0) | (p1 == q1) if carry else none
        st0, st1 = ~keep0, ~keep1 & ~same[:, 0]
        mem[p0[st0]] = u0[st0]
        mem[p1[st1]] = u1[st1]
        for p, st in ((p0, st0), (p1, st1)):
            writer[p[st]], written[p[st]] = owner[st], epoch
        held[:] = False
        held[p0[keep0]] = True
        held[p1[keep1]] = True
        if carry:
            v0 = torch.where((q0 == p0)[:, None], u0,
                             torch.where((q0 == p1)[:, None], u1, l0))
            v1 = torch.where((q1 == p0)[:, None], u0,
                             torch.where((q1 == p1)[:, None], u1, l1))
            p0, p1, w0, w1 = q0, q1, w0s[r1], w1s[r1]
        have = carry
    return mem.reshape(n, n, ns), kinds


def _orders(na, nt, seed=0):
    rays = na * nt
    rng = np.random.default_rng(seed)
    seq = np.arange(rays)
    # ray nt // 2 twice in a row, then -1 and Na Nt (left out by A1)
    repeated = np.insert(seq, [nt // 2, nt + 3, 2 * nt], [nt // 2, -1, rays])
    return {"angle-major": seq, "reversed": seq[::-1].copy(),
            "random": rng.permutation(rays),
            "repeats and out-of-range": repeated,
            "two angles in turns": cuda_art.mixed_order(na, nt)}


# (N, Na, Ns, Nt, span): the chip check's small shape; N 24 over +-60 in
# steps of 15 degrees (row-driven to +-45 exactly, column-driven at +-60)
# with a detector wider than the image (bins whose taps clip at both edges)
SCHEDULE_SHAPES = [(33, 7, 5, 33, 76), (24, 9, 4, 31, 60)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
@pytest.mark.parametrize("name", ["angle-major", "reversed", "random",
                                  "repeats and out-of-range",
                                  "two angles in turns"])
def test_art_schedule_emulation_matches_plain(shape, name):
    """The emulated schedule at every slices-a-block ownership against
    art_sweep_sl_ref (the out-of-range entries dropped, which A1 skips),
    at 1e-5 max|x|, with no read across step groups without a barrier and
    no stale read; both kinds of successor occur where the order has
    them."""
    n, na, ns, nt, span = shape
    _, sysd, vol, b = _problem(n, na, ns, nt, span, seed=4)
    geom = sysd.geom
    if span == 60:
        deg = np.rad2deg(geom.angles)
        assert np.isclose(deg, 45.0).any() and np.isclose(deg, -45.0).any()
        assert geom.row_driven[np.isclose(np.abs(deg), 45.0)].all()
        assert not geom.row_driven.all()
    order = _orders(na, nt)[name]
    rays = na * nt
    kept = order[(order >= 0) & (order < rays)]
    x0 = torch.from_numpy(
        np.random.default_rng(5).uniform(0, 1, (n, n, ns)).astype(np.float32))
    bs = to_sl(torch.from_numpy(b))
    ref = cuda_art.art_sweep_sl_ref(x0, bs, geom, 0.9,
                                    torch.as_tensor(kept, dtype=torch.int32))
    for slices in cuda_art.SLICES:
        got, kinds = _emulate_schedule(x0, bs, geom, 0.9, order, slices)
        _close(got.numpy(), ref.numpy(), 1e-5)
    assert kinds["carried"] > 0 and kinds["fetched"] > 0
    assert kinds["skipped"] == len(order) - len(kept)


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
@pytest.mark.parametrize("name", ["angle-major", "reversed", "random",
                                  "repeats and out-of-range",
                                  "two angles in turns"])
def test_art_schedule_emulation_matches_reference(shape, name):
    """The emulated schedule against tomojax's art_sweep (the reference's
    scan, over the order with the out-of-range entries dropped, which A1
    skips), at 1e-5 max|x|."""
    n, na, ns, nt, span = shape
    jsys, sysd, vol, b = _problem(n, na, ns, nt, span, seed=6)
    x0 = np.zeros_like(vol)
    order = _orders(na, nt)[name]
    kept = order[(order >= 0) & (order < na * nt)].astype(np.int32)
    ref = np.asarray(j_art(jnp.asarray(x0), jnp.asarray(b), jsys, 1.0,
                           jnp.asarray(kept)))
    got, _ = _emulate_schedule(to_sl(torch.from_numpy(x0)),
                               to_sl(torch.from_numpy(b)), sysd.geom, 1.0,
                               order, cuda_art.ART_SLICES)
    _close(from_sl(got).numpy(), ref, 1e-5)


def test_art_schedule_hazard_rules_are_needed():
    """The emulation's checks bite: loading all of the next ray's pixels
    ahead (in place of taking the shared ones, clipped taps included, from
    registers) reads pixels the current ray writes; a successor on the
    other axis fetched without the barrier reads pixels other step groups
    wrote. With both rules the two-ray order holds."""
    n, na, ns, nt, span = SCHEDULE_SHAPES[1]
    _, sysd, vol, b = _problem(n, na, ns, nt, span, seed=7)
    geom = sysd.geom
    x0 = torch.rand((n, n, ns), generator=torch.Generator().manual_seed(0))
    bs = to_sl(torch.from_numpy(b))
    seq = np.arange(na * nt)
    with pytest.raises(_Hazard, match="current ray writes"):
        _emulate_schedule(x0, bs, geom, 1.0, seq, 2, carry_rule=False)
    rd = geom.row_driven
    a_row, a_col = int(np.argmax(rd)), int(np.argmax(~rd))
    order = np.array([a_row * nt + nt // 2, a_col * nt + nt // 2])
    with pytest.raises(_Hazard, match="another step group"):
        _emulate_schedule(x0, bs, geom, 1.0, order, 2, axis_barrier=False)
    got, kinds = _emulate_schedule(x0, bs, geom, 1.0, order, 2)
    assert kinds["fetched"] == 2
    ref = cuda_art.art_sweep_sl_ref(x0, bs, geom, 1.0,
                                    torch.as_tensor(order, dtype=torch.int32))
    _close(got.numpy(), ref.numpy(), 1e-5)


def test_art_groups_follow_the_kernel_layout():
    """Step ownership (art_groups) as csrc/art.cuh lays the block out: KS
    steps a thread up to W warps, KL above; the N limits 4096 / slices."""
    for slices in cuda_art.SLICES:
        vs, lanes, q, ks, kl, w = cuda_art.art_config(slices)
        assert vs * lanes == slices and q * lanes == 32
        for n in (24, 33, 256, 512, cuda_art.art_max_n(slices)):
            if n > cuda_art.art_max_n(slices):
                continue
            g = cuda_art.art_groups(n, slices)
            assert g % q == 0 and g // q <= w and g * kl >= n
    assert [cuda_art.art_max_n(s) for s in cuda_art.SLICES] == [
        4096, 2048, 1024, 512, 256]


def test_art_config_mirrors_the_kernel():
    """cuda_art.art_config and art_max_n hold the constants of csrc/art.cuh
    Cfg, read from the source (change both languages together)."""
    import re
    from pathlib import Path

    src = (Path(cuda_art.__file__).parents[1] / "csrc" / "art.cuh"
           ).read_text()
    body = src[src.index("struct Cfg {"):src.index("};", src.index(
        "struct Cfg {"))]
    exprs = dict(re.findall(r"static constexpr int (\w+) = ([^;]+);", body))
    for slices in cuda_art.SLICES:
        env = {"SL": slices}
        for name, expr in exprs.items():
            py = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2) if (\1) else (\3)",
                        expr).replace("/", "//")
            env[name] = eval(py, {}, dict(env))
        assert cuda_art.art_config(slices) == tuple(
            env[k] for k in ("VS", "L", "Q", "KS", "KL", "W"))
        assert cuda_art.art_max_n(slices) == env["MAX_N"]
