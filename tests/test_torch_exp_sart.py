"""Experiment SART sweeps E3/E4 (tomojax_torch.experiments) held against
the reference's SART experiment scripts and production sweeps.

scripts/exp_sart_pipeline.py and exp_sart_ablate.py are imported by file
path with their ``pl`` swapped for one whose ``pallas_call`` interprets
(test_torch_exp_projector.load_script), so every kernel runs with the
script's own specs on the CPU. Shapes: n = 64, ns = 8, 10 angles over
+-76 deg (``_sart_chunk`` gives 2 chunks of 32 rows, which dbuf needs).

* TAPS_F32 (dbuf, wv_f32, ablate full / rot, phase; the production sweeps)
  over one sweep of random data at K8's test bounds (rtol 2e-4, atol 2e-5).
* The bf16 modes (wvmem, wv_rebuild, wv_reread, wv_fold, whbm, res, reshbm)
  at one step (a one-angle geometry): their weights, the FP's x and the
  update's residual round to bf16 in both packages, but the two sum the
  FP in other orders, so a residual can round to the next bf16 value; the
  bound is 2^-7 max|x_1 - x_0| + K8's atol. Over many steps bf16 SART on
  random data is chaotic (the script's own note), so the modes are also
  held by the script's criterion: the rmse against the phantom after 10
  sweeps on the consistent nanocube problem with real SART weights, within
  2 % of the float32 sweep's.
* The ablations NOHAT, NOFP and NOUPD against their definitions.
* The plain version in the resident kernel's order (``bands=8`` and 16:
  per band and phase, then phase 0 + phase 1, then the bands in rank
  order) against the scripts at the same bounds, against ``bands=1``
  within K8's bounds, and equal bit for bit to a host emulation of the
  kernel's band walk in the experiment modes; E4's cluster shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_exp_projector import load_script  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.solvers import (  # noqa: E402
    make_sart_weights as j_weights, make_system as j_sys,
)
from tomojax.solvers.iterative import sart_sweep as j_sweep  # noqa: E402

from tomojax_torch import ops  # noqa: E402
from tomojax_torch.convert import exp_sart_weights  # noqa: E402
from tomojax_torch.experiments import cuda_sart_variants as csv  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.sim import nanocube_phantom  # noqa: E402
from tomojax_torch.projector import cuda_joseph as cj  # noqa: E402
from tomojax_torch.projector.cuda_joseph import fp_sl  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    make_sart_weights, make_system, to_sl,
)
from tomojax_torch.solvers import cuda_sart as cs  # noqa: E402

X_TOL = dict(rtol=2e-4, atol=2e-5)
F32 = np.float32
N, NS, NA = 64, 8, 10
BF16_VARIANTS = [("wvmem", "TAPS_BF16", False), ("wv_rebuild", "TAPS_BF16",
                                                 False),
                 ("wv_reread", "TAPS_BF16", False),
                 ("wv_fold", "TAPS_BF16", False),
                 ("whbm", "TABLE_BF16", False), ("res", "TAPS_BF16", True),
                 ("reshbm", "TABLE_BF16", True)]


def _problem(na=NA, seed=0):
    ang = np.deg2rad(np.linspace(-76, 76, na))
    rng = np.random.default_rng(seed)
    x = rng.random((N, N, NS)).astype(np.float32)
    b = rng.random((na, N, NS)).astype(np.float32)
    return JGeometry.make(N, ang), Geometry.make(N, ang), x, b


def _port(x, b, g, weights, mode, resident=False, tables=None, beta=1.0):
    inv_row, inv_col = (torch.from_numpy(w) for w in weights)
    sweep = csv.sart_resident if resident else csv.sart_variant
    if mode == "TABLE_BF16" and tables is None:
        tables = csv.sart_tables(g, "cpu")
    return sweep(torch.from_numpy(x), torch.from_numpy(b), g, inv_row,
                 inv_col, torch.tensor(beta),
                 torch.arange(g.nproj, dtype=torch.int32), mode,
                 tables).numpy()


def _real_weights(jg):
    """The reference's SART weights of `jg` (System.inv_row, per-angle
    inverse column sums) as numpy arrays."""
    jsys = j_sys(jg)
    return jsys, (np.array(jsys.inv_row[0]), np.array(j_weights(jsys)))


@pytest.mark.parametrize("ref_kind", ["dbuf", "wv_f32", "base", "xla",
                                      "ablate_full", "ablate_rot", "phase"])
def test_taps_f32_matches_reference_sweeps(ref_kind):
    """Rows 8, 9 (wv_f32), 12 (full, rot) and 13: one sweep of random data,
    with the scripts' random weights (default_rng(1)), or with the
    reference's own weights for its XLA sweep."""
    jg, g, x, b = _problem()
    weights = exp_sart_weights(NA, N, N)
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    if ref_kind in ("dbuf", "wv_f32"):
        sp = load_script("exp_sart_pipeline")
        f, extra = sp.make(jg, NS, ref_kind, interpret=True, weights=weights)
        ref = f(jx, jb, *extra)
    elif ref_kind == "base":
        sp = load_script("exp_sart_pipeline")
        ref = sp.make_base(jg, NS, interpret=True, weights=weights)(jx, jb)
    elif ref_kind == "xla":  # the production sweep, slice-first
        jsys, weights = _real_weights(jg)
        ref = jnp.moveaxis(j_sweep(jnp.moveaxis(jx, 2, 0),
                                   jnp.moveaxis(jb, 2, 0), jsys,
                                   jnp.asarray(weights[1]), beta=1.0), 0, 2)
    else:
        sa = load_script("exp_sart_ablate")
        ref = (sa.make_phase(jg, NS) if ref_kind == "phase"
               else sa.make(jg, NS, ref_kind[len("ablate_"):]))(jx, jb)
    got = _port(x, b, g, weights, "TAPS_F32")
    np.testing.assert_allclose(got, np.asarray(ref), **X_TOL)


@pytest.mark.parametrize("variant,mode,resident", BF16_VARIANTS)
def test_bf16_modes_one_step_match_scripts(variant, mode, resident):
    """Rows 9-11: one SART step (a one-angle geometry) of the bf16 kernels
    against TAPS_BF16 / TABLE_BF16 through E3, or E4 for res / reshbm."""
    ang = np.deg2rad(np.array([23.0]))
    jg, g = JGeometry.make(N, ang), Geometry.make(N, ang)
    rng = np.random.default_rng(3)
    x = rng.random((N, N, NS)).astype(np.float32)
    b = rng.random((1, N, NS)).astype(np.float32)
    weights = exp_sart_weights(1, N, N)
    sp = load_script("exp_sart_pipeline")
    f, extra = sp.make(jg, NS, variant, interpret=True, weights=weights)
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(b), *extra))
    got = _port(x, b, g, weights, mode, resident)
    tol = 2.0 ** -7 * float(np.abs(ref - x).max()) + X_TOL["atol"]
    assert float(np.abs(got - ref).max()) <= tol


def _nanocube(na=NA):
    ang = np.deg2rad(np.linspace(-76, 76, na))
    g = Geometry.make(N, ang)
    sysd = make_system(g, "cpu")
    vol = torch.from_numpy(nanocube_phantom(NS, N))
    b = fp_sl(to_sl(vol), g)
    return g, sysd, vol, b


def test_bf16_modes_converge_like_f32():
    """The script's criterion: rmse against the phantom after 10 sweeps on
    the consistent nanocube problem with real SART weights; the bf16 modes
    within 2 % of TAPS_F32 (E3 and E4) and of the script's wvmem."""
    g, sysd, vol, b = _nanocube()
    w = make_sart_weights(sysd)
    one = torch.tensor(1.0)
    seq = torch.arange(NA, dtype=torch.int32)
    tables = csv.sart_tables(g, "cpu")

    def rmse10(sweep, mode):
        x = torch.zeros((N, N, NS))
        for _ in range(10):
            x = sweep(x, b, g, sysd.inv_row, w, one, seq, mode, tables)
        return float(ops.rmse(x.permute(2, 0, 1), vol))

    r32 = rmse10(csv.sart_variant, "TAPS_F32")
    assert r32 < 0.5 * float(vol.square().mean().sqrt())  # it converges
    got = {(s.__name__, m): rmse10(s, m)
           for s in (csv.sart_variant, csv.sart_resident)
           for m in ("TAPS_BF16", "TABLE_BF16")}
    assert got[("sart_variant", "TAPS_BF16")] == got[("sart_variant",
                                                      "TABLE_BF16")]
    for r in got.values():
        assert abs(r - r32) <= 0.02 * r32
    # the script's own bf16 sweep, from the same weights and projections
    jg = JGeometry.make(N, g.angles)
    sp = load_script("exp_sart_pipeline")
    f, _ = sp.make(jg, NS, "wvmem", interpret=True,
                   weights=(sysd.inv_row.numpy(), w.numpy()))
    xj = jnp.zeros((N, N, NS))
    for _ in range(10):
        xj = f(xj, jnp.asarray(b.numpy()))
    rj = float(ops.rmse(torch.from_numpy(np.array(xj)).permute(2, 0, 1),
                        vol))
    assert abs(got[("sart_variant", "TAPS_BF16")] - rj) <= 0.02 * rj


def test_tables_give_taps_bf16_and_their_size():
    """TABLE_BF16 reads what TAPS_BF16 computes: the sweeps are equal bit
    for bit; the tables hold 8 bytes per angle and bin and driving step
    and per angle and pixel."""
    _, g, x, b = _problem(seed=4)
    weights = exp_sart_weights(NA, N, N)
    tables = csv.sart_tables(g, "cpu")
    assert tables.nbytes == 2 * 8 * NA * N * N
    taps = _port(x, b, g, weights, "TAPS_BF16")
    np.testing.assert_array_equal(
        _port(x, b, g, weights, "TABLE_BF16", tables=tables), taps)
    np.testing.assert_array_equal(
        _port(x, b, g, weights, "TABLE_BF16", resident=True, tables=tables),
        taps)
    np.testing.assert_array_equal(
        _port(x, b, g, weights, "TAPS_F32", resident=True),
        _port(x, b, g, weights, "TAPS_F32"))


def test_nofp_is_the_update_with_resid_b():
    """NOFP: every step is x <- max(x + (beta invd) inv_col u, 0) with u the
    update sum of resid = b inv_row. From x = 0 a TAPS_F32 step has acc = 0
    and so that resid; with b, weights >= 0 its clamp is inactive, so the
    NOFP step is x plus that step, and a NOFP sweep is its steps in order."""
    _, g, x, b = _problem(seed=5)
    weights = exp_sart_weights(NA, N, N)
    inv_row, inv_col = (torch.from_numpy(w) for w in weights)
    xt, bt, beta = torch.from_numpy(x), torch.from_numpy(b), torch.tensor(.7)
    zero = torch.zeros_like(xt)
    want = xt
    for a in (0, 7, 3):
        order = torch.tensor([a], dtype=torch.int32)
        inc = csv.sart_variant(zero, bt, g, inv_row, inv_col, beta, order)
        step = csv.sart_variant(want, bt, g, inv_row, inv_col, beta, order,
                                "NOFP")
        assert torch.equal(step, torch.clamp_min(want + inc, 0.0))
        want = step
    got = csv.sart_variant(xt, bt, g, inv_row, inv_col, beta,
                           torch.tensor([0, 7, 3], dtype=torch.int32), "NOFP")
    assert torch.equal(got, want)


def test_noupd_returns_x_and_nohat_puts_a_constant_on_the_taps():
    """NOUPD returns x. NOHAT at theta = 0 on x = 1, b = 0, unit weights and
    beta: each ray's FP sum is 0.01 per in-range tap (2 per row, 1 on the
    last bin), the residual its negative (invd = 1), and each voxel's
    update 0.01 (r[c] + r[c+1])."""
    _, g, x, b = _problem(seed=6)
    weights = exp_sart_weights(NA, N, N)
    inv_row, inv_col = (torch.from_numpy(w) for w in weights)
    xt = torch.from_numpy(x)
    got = csv.sart_variant(xt, torch.from_numpy(b), g, inv_row, inv_col,
                           torch.tensor(1.0),
                           torch.arange(NA, dtype=torch.int32), "NOUPD")
    assert torch.equal(got, xt) and got is not xt
    n, ns = 8, 2
    g0 = Geometry.make(n, np.zeros(1))
    acc = torch.full((n,), 0.0)
    for _ in range(n):  # the walk adds 0.01 x per tap, row by row
        acc = acc + 0.01
        acc = acc + torch.tensor([0.01] * (n - 1) + [0.0])
    r = -acc
    upd = 0.01 * r + 0.01 * torch.cat([r[1:], torch.zeros(1)])
    want = torch.clamp_min(1.0 + upd, 0.0)[None, :, None].expand(n, n, ns)
    got = csv.sart_variant(torch.ones((n, n, ns)), torch.zeros((1, n, ns)),
                           g0, torch.ones((1, n)), torch.ones((1, n, n)),
                           torch.tensor(1.0),
                           torch.zeros(1, dtype=torch.int32), "NOHAT")
    assert torch.equal(got, want)


def test_exp_sart_weights_are_the_scripts():
    """convert.exp_sart_weights draws what the scripts draw when they make
    their own weights (make(..., weights=None))."""
    jg, _, x, b = _problem(seed=7)
    sp = load_script("exp_sart_pipeline")
    f0, _ = sp.make(jg, NS, "wv_f32", interpret=True)
    f1, _ = sp.make(jg, NS, "wv_f32", interpret=True,
                    weights=exp_sart_weights(NA, N, N))
    np.testing.assert_array_equal(np.asarray(f0(jnp.asarray(x),
                                                jnp.asarray(b))),
                                  np.asarray(f1(jnp.asarray(x),
                                                jnp.asarray(b))))


def test_sart_wrappers_reject_bad_operands():
    _, g, x, b = _problem()
    inv_row, inv_col = (torch.from_numpy(w) for w in
                        exp_sart_weights(NA, N, N))
    args = (torch.from_numpy(x), torch.from_numpy(b), g, inv_row, inv_col,
            torch.tensor(1.0))
    order = torch.arange(NA, dtype=torch.int32)
    with pytest.raises(ValueError):
        csv.sart_variant(*args, order, "TAPS_F16")
    with pytest.raises(ValueError):  # E4 has no ablations
        csv.sart_resident(*args, order, "NOFP")
    with pytest.raises(ValueError):  # clusters of 8 or 16 blocks
        csv.sart_resident(*args, order, "TAPS_F32", None, 3)
    with pytest.raises(ValueError):  # TABLE_BF16 needs its tables
        csv.sart_variant(*args, order, "TABLE_BF16")
    with pytest.raises(ValueError):  # tables of another geometry
        csv.sart_variant(*args, order, "TABLE_BF16", csv.sart_tables(
            Geometry.make(N, g.angles[:-1]), "cpu"))
    with pytest.raises(ValueError):
        csv.sart_variant(*args, order.long())


# ------------------------------------------- the resident kernel's order

BANDS = [8, 16]


@pytest.mark.parametrize("ref_kind", ["dbuf", "ablate_full"])
@pytest.mark.parametrize("bands", BANDS)
def test_banded_taps_f32_matches_reference_sweeps(bands, ref_kind):
    """The plain version in the order of a resident kernel of `bands`
    blocks, TAPS_F32, over one sweep of random data against the scripts'
    kernels at K8's test bounds, as the driving order is."""
    jg, g, x, b = _problem()
    weights = exp_sart_weights(NA, N, N)
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    if ref_kind == "dbuf":
        sp = load_script("exp_sart_pipeline")
        f, extra = sp.make(jg, NS, ref_kind, interpret=True, weights=weights)
        ref = f(jx, jb, *extra)
    else:
        ref = load_script("exp_sart_ablate").make(jg, NS, "full")(jx, jb)
    inv_row, inv_col = (torch.from_numpy(w) for w in weights)
    got = csv.sart_variant_ref(
        torch.from_numpy(x), torch.from_numpy(b), g, inv_row, inv_col,
        torch.tensor(1.0), torch.arange(NA, dtype=torch.int32), "TAPS_F32",
        None, bands)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **X_TOL)


@pytest.mark.parametrize("variant,mode", [("wvmem", "TAPS_BF16"),
                                          ("whbm", "TABLE_BF16")])
@pytest.mark.parametrize("bands", BANDS)
def test_banded_bf16_one_step_matches_scripts(bands, variant, mode):
    """One bf16 step (a one-angle geometry) in the banded order against
    the script's kernel, at the one-step bf16 bound of
    test_bf16_modes_one_step_match_scripts."""
    ang = np.deg2rad(np.array([23.0]))
    jg, g = JGeometry.make(N, ang), Geometry.make(N, ang)
    rng = np.random.default_rng(3)
    x = rng.random((N, N, NS)).astype(np.float32)
    b = rng.random((1, N, NS)).astype(np.float32)
    weights = exp_sart_weights(1, N, N)
    sp = load_script("exp_sart_pipeline")
    f, extra = sp.make(jg, NS, variant, interpret=True, weights=weights)
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(b), *extra))
    inv_row, inv_col = (torch.from_numpy(w) for w in weights)
    got = csv.sart_variant_ref(
        torch.from_numpy(x), torch.from_numpy(b), g, inv_row, inv_col,
        torch.tensor(1.0), torch.zeros(1, dtype=torch.int32), mode,
        csv.sart_tables(g, "cpu"), bands).numpy()
    tol = 2.0 ** -7 * float(np.abs(ref - x).max()) + X_TOL["atol"]
    assert float(np.abs(got - ref).max()) <= tol


@pytest.fixture(scope="module")
def nanocube_rmse10():
    """rmse10(mode, bands) of the plain version on the consistent nanocube
    problem, and the script's own wvmem sweep's rmse after 10 sweeps."""
    g, sysd, vol, b = _nanocube()
    w = make_sart_weights(sysd)
    one = torch.tensor(1.0)
    seq = torch.arange(NA, dtype=torch.int32)
    tables = csv.sart_tables(g, "cpu")

    def rmse10(mode, bands):
        x = torch.zeros((N, N, NS))
        for _ in range(10):
            x = csv.sart_variant_ref(x, b, g, sysd.inv_row, w, one, seq,
                                     mode, tables, bands)
        return float(ops.rmse(x.permute(2, 0, 1), vol))

    sp = load_script("exp_sart_pipeline")
    f, _ = sp.make(JGeometry.make(N, g.angles), NS, "wvmem", interpret=True,
                   weights=(sysd.inv_row.numpy(), w.numpy()))
    xj = jnp.zeros((N, N, NS))
    for _ in range(10):
        xj = f(xj, jnp.asarray(b.numpy()))
    script = float(ops.rmse(torch.from_numpy(np.array(xj)).permute(2, 0, 1),
                            vol))
    return rmse10, script


@pytest.mark.parametrize("bands", BANDS)
def test_banded_bf16_modes_converge_like_f32(bands, nanocube_rmse10):
    """The script's criterion in the banded order: the bf16 modes' rmse
    after 10 sweeps within 2 % of the float32 sweep's (banded and driving
    order) and of the script's wvmem."""
    rmse10, script = nanocube_rmse10
    r32 = rmse10("TAPS_F32", bands)
    r32_drive = rmse10("TAPS_F32", 1)
    assert abs(r32 - r32_drive) <= 1e-4  # K8's rmse level
    for mode in ("TAPS_BF16", "TABLE_BF16"):
        r = rmse10(mode, bands)
        assert abs(r - r32) <= 0.02 * r32, mode
        assert abs(r - r32_drive) <= 0.02 * r32_drive, mode
        assert abs(r - script) <= 0.02 * script, mode


@pytest.mark.parametrize("mode", ["TAPS_F32", "NOHAT"])
@pytest.mark.parametrize("bands", BANDS)
def test_banded_order_within_k8_bounds_of_driving_order(bands, mode):
    """K8's bounds between its resident and streaming orders, here between
    bands = 8 or 16 and bands = 1: one angle step (a column- and a
    row-driven angle) from random x within 1e-5 max|x|; one sweep from
    zero on consistent nanocube projections within 1e-4 max|x|."""
    g, sysd, vol, b = _nanocube()
    args = (b, g, sysd.inv_row, make_sart_weights(sysd), torch.tensor(1.0))
    x = torch.from_numpy(np.random.default_rng(9).random(
        (N, N, NS)).astype(np.float32))
    for a in (0, NA // 2):
        order = torch.tensor([a], dtype=torch.int32)
        ref = csv.sart_variant_ref(x, *args, order, mode)
        got = csv.sart_variant_ref(x, *args, order, mode, None, bands)
        assert float((got - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max())
    seq = torch.arange(NA, dtype=torch.int32)
    x0 = torch.zeros_like(x)
    ref = csv.sart_variant_ref(x0, *args, seq, mode)
    got = csv.sart_variant_ref(x0, *args, seq, mode, None, bands)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _hat(jf, jstar, invd):
    """tj::xp::weight<HAT5>, each float32 operation rounded alone."""
    u = (jf - jstar) * invd
    return np.maximum(F32(0), np.minimum(F32(1) - u, F32(1) + u))


def _jstar(bt, xc, yr, off):
    """tj::bp_jstar: (cos x_c + sin y_r) + (Nt-1)/2."""
    return (bt[0] * xc + bt[1] * yr) + off


class _EWalk:
    """The kernel's band walk in an experiment mode (csrc/exp_sart.cuh
    SartTaps on csrc/sart_resident.cuh fp_band), for all bins of one angle
    at once: each bin's thread of phase ph steps ph, ph + 2, ... through
    its band's range, reading the band's staged rows."""

    def __init__(self, geom, mode, tables, a):
        self.n, self.nt, self.mode, self.a = geom.n, geom.nray, mode, a
        tabs = cj.angle_tables(geom, torch.device("cpu"))
        self.ft, self.bt = tabs.fp.numpy()[a], tabs.bp.numpy()[a]
        self.ctr = F32(0.5) * F32(self.n - 1)
        self.off = F32(0.5) * F32(self.nt - 1)
        self.jf = np.arange(self.nt, dtype=F32)
        self.base = (self.jf - self.off) * self.ft[0]
        if mode == "TABLE_BF16":
            self.ti = tables.fp_i0[a].numpy()
            self.tw = tables.fp_w[a].float().numpy()

    def taps(self, k, pos, row):
        """(i0, w0, w1) per bin of step(s) k at position(s) pos."""
        j = np.arange(self.nt)
        if self.mode == "TABLE_BF16":
            return (self.ti[j, k].astype(np.int64), self.tw[j, k, 0],
                    self.tw[j, k, 1])
        f = np.floor(pos)
        if self.mode == "NOHAT":
            w = np.full(self.nt, 0.01, F32)
            return f.astype(np.int64), w, w
        fk = np.asarray(k).astype(F32)
        ws = []
        for fi in (f, f + F32(1)):
            xc, yr = ((fi - self.ctr, self.ctr - fk) if row
                      else (fk - self.ctr, self.ctr - fi))
            ws.append(_hat(self.jf, _jstar(self.bt, xc, yr, self.off),
                           self.bt[2]))
        if self.mode == "TAPS_BF16":
            ws = [_bf16(w) for w in ws]
        return f.astype(np.int64), ws[0], ws[1]

    def add(self, acc, v0, v1, w0, w1):
        if self.mode in ("TAPS_BF16", "TABLE_BF16"):
            v0, v1 = _bf16(v0), _bf16(v1)
        acc = acc + w0[:, None] * v0
        return acc + w1[:, None] * v1

    def partial(self, xb, r0, r1, ph):
        """Phase ph's partial (Nt, Ns) of the band holding rows [r0, r1)
        (xb: those rows of x)."""
        n, ctr, ft = self.n, self.ctr, self.ft
        acc = np.zeros((self.nt, xb.shape[-1]), F32)
        if ft[3] != 0:  # row-driven: the band's rows, every column held
            for k in range(r0 + ph, r1, 2):
                pos = (self.base + (ctr - F32(k)) * ft[1]) + ctr
                i0, w0, w1 = self.taps(np.full(self.nt, k), pos, True)
                vs = [np.where(((i >= 0) & (i < n))[:, None],
                               xb[k - r0][np.clip(i, 0, n - 1)], F32(0))
                      for i in (i0, i0 + 1)]
                acc = self.add(acc, *vs, w0, w1)
            return acc
        u = ctr - self.base
        k0, k1 = cs.column_steps(u, ft[1], n, self.nt, r0, r1)
        k = k0 + ph
        while (k < k1).any():
            act = k < k1
            kc = np.minimum(k, n - 1)
            pos = u + (kc.astype(F32) - ctr) * ft[1]
            i0, w0, w1 = self.taps(kc, pos, False)
            vs = [np.where(((i >= r0) & (i < r1))[:, None],
                           xb[np.clip(i - r0, 0, r1 - r0 - 1), kc], F32(0))
                  for i in (i0, i0 + 1)]
            acc = np.where(act[:, None], self.add(acc, *vs, w0, w1), acc)
            k = k + 2
        return acc


def emulate_e_sweep(x, b, geom, inv_row, inv_col_a, beta, order, mode,
                    tables, blocks):
    """One sweep of the resident kernel with `blocks` blocks a cluster in
    an experiment mode, on the host in numpy float32: per step the bands'
    phase partials (phase 0 + phase 1), added in rank order, the
    residual, then the update of every pixel."""
    n, nt = geom.n, geom.nray
    rows = cs.band_rows(n, blocks)
    tabs = cj.angle_tables(geom, torch.device("cpu"))
    x = x.numpy().copy()
    b, inv_row, inv_col_a = b.numpy(), inv_row.numpy(), inv_col_a.numpy()
    beta = F32(beta)
    for a in order:
        walk = _EWalk(geom, mode, tables, a)
        bt, invd = walk.bt, walk.bt[2]
        s = np.zeros((nt, x.shape[-1]), F32)
        if mode != "NOFP":
            for rank in range(blocks):
                r0, r1 = min(rank * rows, n), min((rank + 1) * rows, n)
                xb = x[r0:r1]
                p = walk.partial(xb, r0, r1, 0) + walk.partial(xb, r0, r1, 1)
                s = p if rank == 0 else s + p
        resid = (b[a] - invd * s) * inv_row[a][:, None]
        if mode in ("TAPS_BF16", "TABLE_BF16"):
            resid = _bf16(resid)
        if mode == "NOUPD":
            continue
        r = np.arange(n, dtype=F32)[:, None]
        c = np.arange(n, dtype=F32)[None, :]
        if mode == "TABLE_BF16":
            j0 = tables.bp_j0[a].numpy().astype(np.int64)
            w0, w1 = (tables.bp_w[a, :, :, i].float().numpy() for i in (0, 1))
        else:
            jstar = _jstar(bt, c - walk.ctr, walk.ctr - r, walk.off)
            f = np.floor(jstar)
            j0 = f.astype(np.int64)
            if mode == "NOHAT":
                w0 = w1 = np.full((n, n), 0.01, F32)
            else:
                w0, w1 = _hat(f, jstar, invd), _hat(f + F32(1), jstar, invd)
                if mode == "TAPS_BF16":
                    w0, w1 = _bf16(w0), _bf16(w1)
        rv = [np.where(((j >= 0) & (j < nt))[..., None],
                       resid[np.clip(j, 0, nt - 1)], F32(0))
              for j in (j0, j0 + 1)]
        upd = w0[..., None] * rv[0] + w1[..., None] * rv[1]
        scale = (beta * invd) * inv_col_a[a]
        x = np.maximum(x + scale[..., None] * upd, F32(0))
    return x


@pytest.mark.parametrize("mode", csv.MODES)
@pytest.mark.parametrize("bands", BANDS)
@pytest.mark.parametrize("n,na,ns", [(64, 10, 8), (33, 7, 5)])
def test_band_walk_emulation_equals_plain(n, na, ns, bands, mode):
    """The host emulation of the kernel's band walk in each experiment mode
    equals sart_variant_ref(bands=B) bit for bit over one sweep of random
    data, at n = 64 and at the ragged N 33, Na 7, Ns 5 (the last bands
    short or empty)."""
    g = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    rng = np.random.default_rng(n + bands)
    x = torch.from_numpy(rng.random((n, n, ns)).astype(np.float32))
    b = torch.from_numpy(rng.random((na, n, ns)).astype(np.float32))
    inv_row, inv_col = (torch.from_numpy(w)
                        for w in exp_sart_weights(na, n, n))
    tables = csv.sart_tables(g, "cpu") if mode == "TABLE_BF16" else None
    order = np.random.default_rng(1).permutation(na)
    ref = csv.sart_variant_ref(x, b, g, inv_row, inv_col, torch.tensor(0.9),
                               torch.from_numpy(order.astype(np.int32)),
                               mode, tables, bands)
    got = emulate_e_sweep(x, b, g, inv_row, inv_col, 0.9, order, mode,
                          tables, bands)
    np.testing.assert_array_equal(got, ref.numpy())


def test_e4_refuses_shapes():
    """E4 raises, on the CPU too, for blocks outside {8, 16}, sb outside
    {1, 2, 4}, and a shape whose block does not fit the card's shared
    memory; it never runs another shape in its place."""
    _, g, x, b = _problem()
    inv_row, inv_col = (torch.from_numpy(w) for w in
                        exp_sart_weights(NA, N, N))
    args = (torch.from_numpy(x), torch.from_numpy(b), g, inv_row, inv_col,
            torch.tensor(1.0), torch.arange(NA, dtype=torch.int32),
            "TAPS_F32", None)
    for blocks, sb in ((4, 4), (32, 1), (8, 8), (16, 3)):
        with pytest.raises(ValueError):
            csv.sart_resident(*args, blocks, sb)
    g512 = Geometry.make(512, g.angles)
    big = (torch.zeros((512, 512, 1)), torch.zeros((NA, 512, 1)), g512,
           torch.zeros((NA, 512)), torch.zeros((NA, 512, 512)),
           torch.tensor(1.0), torch.arange(NA, dtype=torch.int32),
           "TAPS_F32", None)
    for blocks, sb in ((8, 4), (8, 2), (8, 1), (16, 4)):
        with pytest.raises(ValueError, match="shared memory"):
            csv.sart_resident(*big, blocks, sb)
    assert csv.e4_shapes(512, 512) == [(16, 2), (16, 1)]
    assert csv.e4_shapes(256, 256) == list(csv.E4_SHAPES)
    assert csv.e3_bands(256, 256) == 8 and csv.e3_bands(512, 512) == 1


@pytest.mark.parametrize("name", ["sart_pipeline", "sart_ablate"])
def test_sart_drivers_run_on_cpu(name, capsys):
    """Each driver end to end with --device cpu at 16^2 x 2 (90 angles): a
    row per script variant, the last line JSON with every variant's time;
    the float32 rows converge as K8 does."""
    import importlib
    import json

    from tomojax_torch.experiments import sart_ablate, sart_pipeline

    mod = importlib.import_module(f"tomojax_torch.experiments.{name}")
    mod.main(["16", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    rows = out["rows"]
    want = (["base", *sart_pipeline.VARIANTS] if name == "sart_pipeline"
            else [*sart_ablate.ABLATIONS, "na30"])
    assert sorted(rows) == sorted(want)
    assert all(np.isfinite(r["ms"]) for r in rows.values())
    assert all(line.endswith("[cpu (host clock)]") for line in lines[1:-1])
    if name == "sart_pipeline":
        assert out["table_bytes"] == 2 * 8 * 90 * 16 * 16
        for v, (_, mode, _) in sart_pipeline.VARIANTS.items():
            bound = 1e-4 if mode == "TAPS_F32" else 2e-2
            assert abs(rows[v]["rmse10"] - rows["base"]["rmse10"]) <= \
                bound * rows["base"]["rmse10"], v
    else:
        assert rows["rot"]["rel"] == rows["phase"]["rel"] == 0.0


@pytest.mark.cuda
def test_e3_e4_kernels_match_plain_on_card():
    """Every mode of E3 equals the plain version in its route's order bit
    for bit over one sweep (resident, bands 8: n = 64 and N 33, Na 7, Ns 5;
    streaming, bands 1: N 320), and E4 in its three modes at every cluster
    shape the plain version at bands = its blocks; E4 at (8, 4) equals E3,
    and two E4 sweeps agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for n, na, ns in ((N, NA, NS), (33, 7, 5), (320, 6, 4)):
        g = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
        rng = np.random.default_rng(8)
        x = rng.random((n, n, ns)).astype(np.float32)
        b = rng.random((na, n, ns)).astype(np.float32)
        inv_row, inv_col = (torch.from_numpy(w).to(dev) for w in
                            exp_sart_weights(na, n, n))
        args = (torch.from_numpy(x).to(dev), torch.from_numpy(b).to(dev), g,
                inv_row, inv_col, torch.tensor(0.9, device=dev),
                torch.arange(na, dtype=torch.int32, device=dev))
        tables = csv.sart_tables(g, dev)
        bands = csv.e3_bands(n, n)
        assert bands == (8 if n < 300 else 1)
        for mode in csv.MODES:
            ref = csv.sart_variant_ref(*args, mode, tables, bands)
            got = csv.sart_variant(*args, mode, tables)
            assert torch.equal(got, ref), (n, mode)
        for mode in csv.RESIDENT_MODES:
            for blocks, sb in csv.e4_shapes(n, n):
                ref = csv.sart_variant_ref(*args, mode, tables, blocks)
                got = csv.sart_resident(*args, mode, tables, blocks, sb)
                assert torch.equal(got, ref), (n, mode, blocks, sb)
                assert torch.equal(
                    csv.sart_resident(*args, mode, tables, blocks, sb), got)
