"""Experiment projectors E1/E2 (tomojax_torch.experiments) held against the
reference's experiment scripts and production projector.

The scripts (scripts/exp_hat_model.py, exp_projector_variants.py,
exp_projector_variants2.py, exp_pair_fp.py) are imported by file path and
their kernel bodies run through ``pl.pallas_call(..., interpret=True)`` with
the scripts' own specs: the module's ``pl`` is swapped for one whose
``pallas_call`` adds ``interpret=True``. Their f32 variants contract with
``Precision.DEFAULT``, which is float32 on the CPU. Shapes: n = 128, ns =
8, 16 angles over +-76 deg (the banded FP needs n % 128 == 0); the banded
BP (row 3 of the kernel table) at n = 256, where its band is two tiles
wide. Tolerances: K1's (rtol 1e-4, atol 1e-4) for float32 forms, 2^-8
max|out| for BF16 (its weights round to bf16). The ablations NOHAT and
NODOT are held only against their definitions.
"""

import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import bp as j_bp, fp as j_fp  # noqa: E402

from tomojax_torch.experiments import (  # noqa: E402
    cuda_projector_variants as cpv,
)
from tomojax_torch.geometry import Geometry  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
N, NS, NA = 128, 8, 16


def load_script(name: str):
    """scripts/<name>.py as a fresh module whose pallas_call interprets."""
    spec = importlib.util.spec_from_file_location(
        f"_exp_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Interpret(types.ModuleType):
        def __getattr__(self, attr):
            return getattr(pl, attr)

        @staticmethod
        def pallas_call(*args, **kwargs):
            return pl.pallas_call(*args, **{**kwargs, "interpret": True})

    mod.pl = Interpret("pallas_interpret")
    return mod


def _geoms(n=N, na=NA):
    ang = np.deg2rad(np.linspace(-76, 76, na))
    return JGeometry.make(n, ang), Geometry.make(n, ang)


def _data(n=N, ns=NS, na=NA, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n, ns), np.float32),
            rng.random((na, n, ns), np.float32))


def _bf16_tol(ref) -> float:
    return 2.0 ** -8 * float(np.abs(ref).max())


@pytest.mark.parametrize("form,variant", [
    ("FULL", "full"), ("HAT5", "hat5"), ("BF16", "hatbf16")])
def test_fp_forms_match_hat_model(form, variant):
    jg, g = _geoms()
    x, _ = _data()
    hm = load_script("exp_hat_model")
    fp, _, _ = hm.make_fp(jg, NS, variant)
    ref = np.asarray(fp(jnp.asarray(x)))
    got = cpv.fp_variant(torch.from_numpy(x), g, form).numpy()
    if form == "BF16":
        assert np.abs(got - ref).max() <= _bf16_tol(ref)
    else:
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("form,variant", [("FULL", "full"),
                                          ("BF16", "hatbf16")])
def test_bp_forms_match_hat_model(form, variant):
    jg, g = _geoms()
    _, y = _data()
    hm = load_script("exp_hat_model")
    ref = np.asarray(hm.make_bp(jg, NS, variant)(jnp.asarray(y)))
    got = cpv.bp_variant(torch.from_numpy(y), g, form).numpy()
    if form == "BF16":
        assert np.abs(got - ref).max() <= _bf16_tol(ref)
    else:
        np.testing.assert_allclose(got, ref, **TOL)


def test_bp_matches_banded_hat_model():
    """Row 3: the banded BP of exp_hat_model at n = 256 (two 128-column
    tiles, a band narrower than the detector) computes E2 FULL's
    operator."""
    n, ns, na = 256, 4, 8
    jg, g = _geoms(n, na)
    _, y = _data(n, ns, na, seed=1)
    hm = load_script("exp_hat_model")
    bp, jw, nct = hm.make_bp_banded(jg, ns, "full")
    assert nct == 2 and jw < n
    ref = np.asarray(bp(jnp.asarray(y)))
    got = cpv.bp_variant(torch.from_numpy(y), g, "FULL").numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("a_blk,form", [(16, "FULL"), (16, "W4"),
                                        (32, "FULL"), (32, "W4")])
def test_fp_w4_matches_projector_variants(a_blk, form):
    jg, g = _geoms()
    x, _ = _data(seed=2)
    pv = load_script("exp_projector_variants")
    ref = np.asarray(pv.make_fp(jg, NS, a_blk, form == "W4")(jnp.asarray(x)))
    got = cpv.fp_variant(torch.from_numpy(x), g, form, ab=a_blk).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("form", ["FULL", "W4"])
def test_bp_w4_matches_projector_variants(form):
    jg, g = _geoms()
    _, y = _data(seed=3)
    pv = load_script("exp_projector_variants")
    ref = np.asarray(pv.make_bp(jg, NS, 32, form == "W4")(jnp.asarray(y)))
    got = cpv.bp_variant(torch.from_numpy(y), g, form).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_bp_aps2_matches_projector_variants2():
    """Row 7: two angles per step, with an odd angle count (the last angle
    alone, the reference's padded zero angle)."""
    jg, g = _geoms(na=NA - 1)
    _, y = _data(na=NA - 1, seed=4)
    pv2 = load_script("exp_projector_variants2")
    ref = np.asarray(pv2.make_bp2(jg, NS, 32)(jnp.asarray(y)))
    got = cpv.bp_variant(torch.from_numpy(y), g, "FULL", aps=2).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("form", ["FULL", "HAT5", "W4"])
def test_forms_match_production_projector(form):
    """The float32 forms are the production Joseph pair
    (tomojax.projector.joseph fp / bp, slice-first)."""
    jg, g = _geoms()
    x, y = _data(seed=5)
    ref_fp = np.asarray(j_fp(jnp.asarray(np.moveaxis(x, 2, 0)), jg))
    got_fp = cpv.fp_variant(torch.from_numpy(x), g, form).numpy()
    np.testing.assert_allclose(np.moveaxis(got_fp, 2, 0), ref_fp, **TOL)
    if form == "HAT5":
        return  # HAT5 is an FP form only
    ref_bp = np.asarray(j_bp(jnp.asarray(np.moveaxis(y, 2, 0)), jg))
    got_bp = cpv.bp_variant(torch.from_numpy(y), g, form).numpy()
    np.testing.assert_allclose(np.moveaxis(got_bp, 2, 0), ref_bp, **TOL)


def test_pair_matches_flipped_stack_and_unpaired():
    """Row 4: the paired FP of a symmetric 16-angle series against the
    script's [x | row-flipped x] stack through the production banded FP on
    the positive half of the angles (s_blk = 2 ns), and against E1 FULL."""
    jg, g = _geoms()
    x, _ = _data(seed=6)
    pf = load_script("exp_pair_fp")
    ang = np.deg2rad(np.linspace(-76, 76, NA))
    jg_h = JGeometry.make(N, ang[NA // 2:])
    fp_half, _ = pf.make_fp_sblk(jg_h, 2 * NS, 2 * NS)
    stack = jnp.concatenate([jnp.asarray(x), jnp.asarray(x)[::-1]], axis=2)
    ref = np.asarray(fp_half(stack))
    got = cpv.fp_variant(torch.from_numpy(x), g, pair=True).numpy()
    np.testing.assert_allclose(got[NA // 2:], ref[:, :, :NS], **TOL)
    np.testing.assert_allclose(got[:NA // 2][::-1], ref[:, :, NS:], **TOL)
    full = cpv.fp_variant(torch.from_numpy(x), g, "FULL").numpy()
    np.testing.assert_array_equal(got[NA // 2:], full[NA // 2:])
    rel = np.abs(got - full).max() / np.abs(full).max()
    assert rel <= 1e-6  # the -theta rays: the same taps, summed reversed


def test_pair_rejects_asymmetric_series():
    x = torch.zeros((N, N, NS))
    ang = np.deg2rad(np.linspace(-76, 76, NA))
    ang[3] += 1e-6
    with pytest.raises(ValueError, match="symmetric"):
        cpv.fp_variant(x, Geometry.make(N, ang), pair=True)
    with pytest.raises(ValueError, match="even"):
        cpv.fp_variant(x, Geometry.make(N, np.deg2rad(
            np.linspace(-76, 76, NA - 1))), pair=True)
    with pytest.raises(ValueError):  # pair with another form
        cpv.fp_variant(x, _geoms()[1], "W4", pair=True)


def test_ablations_match_their_definitions():
    """At theta = 0 every tap lies on a pixel centre: J* of column c is c,
    so NODOT's FP adds weight 1 (d = 0) and 0 (d = -1) per row, n per ray,
    and its BP 1 per angle; NOHAT puts invd/2 = 1/2 on both taps of every
    step, of which the second leaves the image on the last bin or column."""
    n, ns = 16, 3
    g = Geometry.make(n, np.zeros(1))
    ones = torch.ones((n, n, ns))
    assert torch.equal(cpv.fp_variant(ones, g, "NODOT"),
                       torch.full((1, n, ns), float(n)))
    assert torch.equal(cpv.bp_variant(torch.ones((1, n, ns)), g, "NODOT"),
                       torch.ones((n, n, ns)))
    want = torch.full((1, n, ns), float(n))
    want[0, -1] = n / 2
    assert torch.equal(cpv.fp_variant(ones, g, "NOHAT"), want)
    want = torch.ones((n, n, ns))
    want[:, -1] = 0.5
    assert torch.equal(cpv.bp_variant(torch.ones((1, n, ns)), g, "NOHAT"),
                       want)
    x, _ = _data(n, ns, 1, seed=7)
    xt = torch.from_numpy(x)
    want = torch.zeros((n, ns))
    for k in range(n):  # the rows in the walk's order
        want = want + xt[k]
    assert torch.equal(cpv.fp_variant(xt, g, "FULL")[0], want)


def test_wrappers_reject_bad_options():
    g = _geoms()[1]
    x, y = torch.zeros((N, N, NS)), torch.zeros((NA, N, NS))
    with pytest.raises(ValueError):
        cpv.fp_variant(x, g, "HAT6")
    with pytest.raises(ValueError):
        cpv.fp_variant(x, g, ab=3)
    with pytest.raises(ValueError):
        cpv.bp_variant(y, g, "HAT5")  # an FP form only
    with pytest.raises(ValueError):
        cpv.bp_variant(y, g, "W4", aps=2)
    with pytest.raises(ValueError):
        cpv.fp_variant(torch.zeros((N + 1, N, NS)), g)


DRIVER_KEYS = {
    "hat_model": ["fp_FULL", "fp_NOHAT", "fp_NODOT", "fp_HAT5", "fp_BF16",
                  "bp_FULL", "bp_NOHAT", "bp_NODOT", "bp_BF16", "fp_prod",
                  "bp_prod", "fgp_iter", "fp_model_ms", "bp_model_ms"],
    "projector_variants": ["fp_ab1_FULL", "fp_ab1_W4", "fp_ab16_FULL",
                           "fp_ab16_W4", "fp_ab32_FULL", "fp_ab32_W4",
                           "bp_FULL", "bp_W4"],
    "projector_variants2": ["fp_K1", "fp_ab16", "fp_ab32", "bp_K2",
                            "bp_aps2"],
    "pair_fp": ["base_E1", "base_K1", "pair", "base_repeat", "control"],
}


@pytest.mark.parametrize("name", sorted(DRIVER_KEYS))
def test_projector_drivers_run_on_cpu(name, capsys):
    """Each driver end to end with --device cpu at 16^2 x 2 (90 angles):
    its rows carry the device, and its last line is JSON with every
    variant's time."""
    import importlib
    import json

    mod = importlib.import_module(f"tomojax_torch.experiments.{name}")
    mod.main(["16", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["device"] == "cpu (host clock)" and out["n"] == 16
    assert sorted(out["ms"]) == sorted(DRIVER_KEYS[name])
    assert all(np.isfinite(v) for v in out["ms"].values())
    assert all(line.endswith("[cpu (host clock)]") for line in lines[1:-1])
    if name == "pair_fp":
        assert max(out["rel"].values()) <= 1e-6


@pytest.mark.cuda
def test_e1_e2_kernels_match_plain_on_card():
    """Every instantiation of E1 (six forms, PAIR, angles per block 1 to
    32) and E2 (five forms, APS 2) equals its plain version bit for bit;
    both also at ragged shapes (N 33, Ns 5 and N 48, Ns 37: scalar copies,
    tiles and slabs cut short, a ragged last ring stage), PAIR on
    symmetric series."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = _geoms()[1]
    x, y = (torch.from_numpy(a) for a in _data(seed=8))
    x, y = x.to(dev), y.to(dev)
    for n, na, ns in ((N, NA, NS), (33, 7, 5), (48, 14, 37)):
        geom = _geoms(n, na)[1]
        xs = x if n == N else torch.from_numpy(
            _data(n, ns, na, seed=n)[0]).to(dev)
        for form in cpv.FORMS:
            ref = cpv.fp_variant_ref(xs, geom, form)
            for ab in cpv.ANGLES_PER_BLOCK:
                assert torch.equal(cpv.fp_variant(xs, geom, form, ab=ab),
                                   ref), (n, form, ab)
        pg = _geoms(n, na + na % 2)[1]
        ref = cpv.fp_variant_ref(xs, pg, pair=True)
        for ab in cpv.ANGLES_PER_BLOCK:
            assert torch.equal(cpv.fp_variant(xs, pg, pair=True, ab=ab),
                               ref), (n, "PAIR", ab)
    for form in cpv.BP_FORMS:
        ref = cpv.bp_variant_ref(y, g, form)
        assert torch.equal(cpv.bp_variant(y, g, form), ref), form
    assert torch.equal(cpv.bp_variant(y, g, aps=2), cpv.bp_variant_ref(y, g))
    for n, na, ns in ((33, 7, 5), (48, 13, 37)):
        geom = _geoms(n, na)[1]
        ys = torch.from_numpy(_data(n, ns, na, seed=n)[1]).to(dev)
        for form in cpv.BP_FORMS:
            assert torch.equal(cpv.bp_variant(ys, geom, form),
                               cpv.bp_variant_ref(ys, geom, form)), (n, form)
        assert torch.equal(cpv.bp_variant(ys, geom, aps=2),
                           cpv.bp_variant_ref(ys, geom)), (n, "APS2")
