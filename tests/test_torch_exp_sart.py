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
from tomojax_torch.projector.cuda_joseph import fp_sl  # noqa: E402
from tomojax_torch.solvers import (  # noqa: E402
    make_sart_weights, make_system, to_sl,
)

X_TOL = dict(rtol=2e-4, atol=2e-5)
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
    with pytest.raises(ValueError):  # slab widths are powers of two to 8
        csv.sart_resident(*args, order, "TAPS_F32", None, 3)
    with pytest.raises(ValueError):  # TABLE_BF16 needs its tables
        csv.sart_variant(*args, order, "TABLE_BF16")
    with pytest.raises(ValueError):  # tables of another geometry
        csv.sart_variant(*args, order, "TABLE_BF16", csv.sart_tables(
            Geometry.make(N, g.angles[:-1]), "cpu"))
    with pytest.raises(ValueError):
        csv.sart_variant(*args, order.long())


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
    """Every instantiation of E3 (six modes) and E4 (three, and TAPS_F32 at
    every slab width) equals the plain version bit for bit over one sweep,
    and E4 equals E3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    _, g, x, b = _problem(seed=8)
    inv_row, inv_col = (torch.from_numpy(w).to(dev) for w in
                        exp_sart_weights(NA, N, N))
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(b).to(dev), g,
            inv_row, inv_col, torch.tensor(0.9, device=dev),
            torch.arange(NA, dtype=torch.int32, device=dev))
    tables = csv.sart_tables(g, dev)
    for mode in csv.MODES:
        ref = csv.sart_variant_ref(*args, mode, tables)
        got = csv.sart_variant(*args, mode, tables)
        assert torch.equal(got, ref), mode
        if mode in csv.RESIDENT_MODES:
            assert torch.equal(csv.sart_resident(*args, mode, tables), ref)
    ref = csv.sart_variant_ref(*args)
    for sb in csv.SLICES_PER_BLOCK:
        assert torch.equal(csv.sart_resident(*args, "TAPS_F32", None, sb),
                           ref), sb
