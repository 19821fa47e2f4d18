"""tomojax_torch multi-modal fusion held against tomojax: the sigma
weights, every function of ``fusion/multimodal.py``, the 4D TV wrappers,
``ChemicalTomo`` as a whole, and the golden trace
``tests/golden/fusion_jax_cpu.json``.

The reference runs on the CPU: its projector in 'mxu' mode (a dense
float32 contraction) and its 4D FGP as XLA stencils with float32 duals.
The port runs its plain versions with float32 duals, in its slice-last
layouts (``solvers.to_sl`` / ``from_sl`` convert). Bounds:

* single operators and one step: 1e-4 relative (of the largest
  magnitude), tests/test_torch_projector.py's bound for the projector
  pair, whose last digits the two packages round differently;
* the 4D TV stencils, which both packages compute with the same float32
  operations in another axis order: 2e-6;
* whole runs (``data_fusion_run``, ``ChemicalTomo``): costs at rtol 1e-3
  and volumes at 1e-3 of their largest magnitude, the bound the reference
  holds its own two float32 fusion paths to (tests/test_fusion.py:
  data_fusion_run against the host loop at rtol 1e-4, here widened tenfold
  for the projector's last-digit differences, which the outer iterations
  carry forward).

``tests/golden/fusion_jax_cpu.json`` is the reference's ``ChemicalTomo``
host loop on the CPU (see GOLDEN_CONFIG), regenerated with
``python tests/test_torch_fusion.py``, which also measures its bounds: the
largest deviation from it of the port's own replay with every input of the
data perturbed by one ulp, over 8 seeds, times 4. The λ_chem decay is a
branch on a float comparison of consecutive HAADF costs; the problem is
chosen so that no two consecutive costs lie within 1 % of each other, and
the file records the iterations at which the decay fired, so a flipped
branch is reported as such.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import ChemicalTomo as JChemicalTomo  # noqa: E402
from tomojax import tv as jtv  # noqa: E402
from tomojax.fusion import (  # noqa: E402
    PERIODIC_TABLE as J_TABLE,
    bp4d as j_bp4d,
    chemical_sart_sweep as j_chem_sart,
    chemical_sirt_sweep as j_chem_sirt,
    data_distance_chem as j_ddc,
    data_fusion_run as j_run,
    data_fusion_step as j_step,
    element_weights as j_element_weights,
    fp4d as j_fp4d,
    make_fusion_system as j_make_fsys,
    model_haadf as j_model,
    poisson_ml_step_4d as j_poisson4d,
    rescale_projections as j_rescale,
    sigma_apply as j_sigma,
    sigma_t_apply as j_sigma_t,
    weights_for_elements as j_weights,
)
from tomojax.fusion.multimodal import tv_fgp_4d as j_tv_fgp_4d  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import make_sart_weights as j_sart_w  # noqa: E402

from tomojax_torch import ChemicalTomo, config  # noqa: E402
from tomojax_torch import fusion  # noqa: E402
from tomojax_torch import tv as ttv  # noqa: E402
from tomojax_torch.convert import (  # noqa: E402
    fusion_system_from_numpy, sart_weights_from_numpy,
)
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector.cuda_joseph import fp_sl  # noqa: E402
from tomojax_torch.sim import nanocube_phantom  # noqa: E402
from tomojax_torch.solvers import from_sl, to_sl  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden" / "fusion_jax_cpu.json"
GOLDEN_CONFIG = {
    "nel": 2, "ns": 8, "n": 64, "na_haadf": 30, "na_chem": 10,
    "span_deg": 76.0, "elements": ["c", "zn"], "gamma": 1.6,
    "sigma_method": 3,
    "phantoms": "element e: nanocube_phantom(ns, n, seed=e + 1)",
    "data": "noiseless: haadf = fp(model_haadf(gt)), chem = fp4d(gt)",
    "chem_iters": 10, "lambda_chem": 0.05, "fusion_iters": 8,
    "lambda_haadf": 30.0, "lambda_tv": 1e-4, "iter_sirt": 5, "tv_iter": 5,
    "method": "sirt", "device": "cpu",
    "path": "tomojax ChemicalTomo host loop, f32 XLA (mxu projector, "
            "f32 FGP duals)"}
TRACES = ("costCHEM_chem", "costHAADF", "costCHEM", "costTV")
STUDY_SEEDS, STUDY_MARGIN = 8, 4.0

N, NS, NEL = 32, 4, 2  # tests/test_fusion.py's problem
H_ANG = np.deg2rad(np.linspace(-70, 70, 40))
C_ANG = np.deg2rad(np.linspace(-60, 60, 9))


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture
def f32_duals(monkeypatch):
    """The reference's CPU FGP keeps float32 duals."""
    monkeypatch.setattr(config, "fgp_dual_dtype", torch.float32)


@pytest.fixture(scope="module")
def setup():
    """tests/test_fusion.py's two-disc problem, the reference's system
    carried across."""
    yy, xx = np.mgrid[0:N, 0:N]
    gt = np.zeros((NEL, NS, N, N), np.float32)
    gt[0, :] = ((xx - 10) ** 2 + (yy - 16) ** 2 < 36)
    gt[1, :] = ((xx - 22) ** 2 + (yy - 16) ** 2 < 25)
    w = j_weights(["c", "zn"], 1.6, 3)
    jf = j_make_fsys(N, H_ANG, C_ANG, w, gamma=1.6)
    b_chem = np.array(j_fp4d(jnp.asarray(gt), jf.chem))
    b_haadf = np.array(j_fp(j_model(jnp.asarray(gt), jf), jf.haadf.geom))
    tf = fusion_system_from_numpy(
        (Geometry.make(N, H_ANG), np.asarray(jf.haadf.row_sum),
         np.asarray(jf.haadf.col_sum), np.asarray(jf.haadf.lipschitz)),
        (Geometry.make(N, C_ANG), np.asarray(jf.chem.row_sum),
         np.asarray(jf.chem.col_sum), np.asarray(jf.chem.lipschitz)),
        np.asarray(jf.weights), jf.gamma, np.asarray(jf.l_aps),
        np.asarray(jf.l_asig), "cpu")
    return gt, jf, tf, b_chem, b_haadf


def _x0(seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(NEL, NS, N, N)).astype(np.float32)


# ------------------------------------------------------------------ sigma


def test_weight_methods_match_reference():
    z = [6, 30, 79]
    for method in range(5):
        np.testing.assert_array_equal(fusion.element_weights(z, 1.6, method),
                                      j_element_weights(z, 1.6, method))
    for bad in (5, -1, 9):
        with pytest.raises(ValueError):
            fusion.element_weights(z, 1.6, bad)
    assert fusion.PERIODIC_TABLE == J_TABLE
    np.testing.assert_array_equal(
        fusion.weights_for_elements(["C", "zn", "Au"], 1.6, 4),
        j_weights(["C", "zn", "Au"], 1.6, 4))


def test_sigma_matches_reference_and_is_adjoint():
    rng = np.random.default_rng(0)
    w = np.asarray([0.3, 0.7], np.float32)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    v = rng.standard_normal((3, 8, 8)).astype(np.float32)
    sx = fusion.sigma_apply(w, _t(x))
    np.testing.assert_allclose(sx.numpy(),
                               np.asarray(j_sigma(w, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    stv = fusion.sigma_t_apply(torch.from_numpy(w), _t(v), 2)
    np.testing.assert_array_equal(stv.numpy(),
                                  np.asarray(j_sigma_t(w, jnp.asarray(v), 2)))
    lhs = float(torch.sum(sx.double() * _t(v).double()))
    rhs = float(torch.sum(_t(x).double() * stv.double()))
    assert np.isclose(lhs, rhs, rtol=1e-6)


# ------------------------------------------------------ system, operators


def test_fusion_system_matches_reference(setup):
    """make_fusion_system on its own against the reference's, and the
    reference's carried across by fusion_system_from_numpy."""
    _, jf, tf, _, _ = setup
    own = fusion.make_fusion_system(N, H_ANG, C_ANG, np.asarray(jf.weights),
                                    1.6, "cpu")
    for got, ref in ((own.haadf.row_sum, jf.haadf.row_sum[0]),
                     (own.haadf.col_sum, jf.haadf.col_sum[0]),
                     (own.chem.row_sum, jf.chem.row_sum[0]),
                     (own.chem.col_sum, jf.chem.col_sum[0])):
        _close(got.numpy(), ref, 1e-5)
    for got, ref in ((own.l_aps, jf.l_aps), (own.l_asig, jf.l_asig)):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    assert own.gamma == jf.gamma and own.nel == NEL == tf.nel
    np.testing.assert_array_equal(tf.weights.numpy(), np.asarray(jf.weights))
    np.testing.assert_array_equal(tf.haadf.row_sum.numpy(),
                                  np.asarray(jf.haadf.row_sum)[0])
    np.testing.assert_array_equal(tf.chem.col_sum.numpy(),
                                  np.asarray(jf.chem.col_sum)[0])
    assert float(tf.l_asig) == float(jf.l_asig)
    assert float(tf.chem.lipschitz) == float(jf.chem.lipschitz)


@pytest.mark.parametrize("gamma", [1.6, 1.0])
def test_projections_and_model_match_reference(setup, gamma):
    _, jf, tf, b_chem, _ = setup
    x = _x0(1, -0.2, 1.0)
    jf = type(jf)(jf.haadf, jf.chem, jf.weights, gamma, jf.l_aps, jf.l_asig)
    tf = type(tf)(tf.haadf, tf.chem, tf.weights, gamma, tf.l_aps, tf.l_asig)
    _close(from_sl(fusion.fp4d(to_sl(_t(x)), tf.chem)).numpy(),
           j_fp4d(jnp.asarray(x), jf.chem))
    _close(from_sl(fusion.bp4d(to_sl(_t(b_chem)), tf.chem)).numpy(),
           j_bp4d(jnp.asarray(b_chem), jf.chem, N))
    _close(from_sl(fusion.model_haadf(to_sl(_t(x)), tf)).numpy(),
           j_model(jnp.asarray(x), jf))


def test_poisson_ml_step_4d_matches_reference(setup):
    _, jf, tf, b_chem, _ = setup
    bn = b_chem / b_chem.max()
    xj, xt = jnp.asarray(_x0(2, 0.0, 0.3)), to_sl(_t(_x0(2, 0.0, 0.3)))
    for _ in range(3):
        xj, cj = j_poisson4d(xj, jnp.asarray(bn), jf, 0.5)
        xt, ct = fusion.poisson_ml_step_4d(xt, to_sl(_t(bn)), tf, 0.5)
    _close(from_sl(xt).numpy(), xj)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


def test_chemical_sirt_and_sart_match_reference(setup):
    _, jf, tf, b_chem, _ = setup
    x = _x0(3, 0.0, 0.2)
    _close(from_sl(fusion.chemical_sirt_sweep(to_sl(_t(x)), to_sl(_t(b_chem)),
                                              tf, 3)).numpy(),
           j_chem_sirt(jnp.asarray(x), jnp.asarray(b_chem), jf, 3))
    w = sart_weights_from_numpy(np.asarray(j_sart_w(jf.chem)), "cpu")
    _close(from_sl(fusion.chemical_sart_sweep(to_sl(_t(x)), to_sl(_t(b_chem)),
                                              tf, 2, w)).numpy(),
           j_chem_sart(jnp.asarray(x), jnp.asarray(b_chem), jf, 2))


@pytest.mark.parametrize("method,normalize", [("sirt", False), ("sirt", True),
                                              ("sart", False)])
def test_data_fusion_step_matches_reference(setup, method, normalize):
    _, jf, tf, b_chem, b_haadf = setup
    x = _x0(4, 0.0, 1.0)
    xj, chj, ccj = j_step(jnp.asarray(x), jnp.asarray(b_haadf),
                          jnp.asarray(b_chem), jf, 0.5, 0.05, 3, normalize,
                          method=method)
    xt, cht, cct = fusion.data_fusion_step(
        to_sl(_t(x)), to_sl(_t(b_haadf)), to_sl(_t(b_chem)), tf, 0.5,
        torch.tensor(0.05), 3, normalize, method)
    _close(from_sl(xt).numpy(), xj)
    np.testing.assert_allclose(float(cht), float(chj), rtol=1e-4)
    np.testing.assert_allclose(float(cct), float(ccj), rtol=1e-4)
    with pytest.raises(ValueError):
        fusion.data_fusion_step(to_sl(_t(x)), to_sl(_t(b_haadf)),
                                to_sl(_t(b_chem)), tf, 0.5, 0.05, 1,
                                method="art")


def test_data_fusion_run_matches_reference_and_host_loop(setup, f32_duals):
    """test_fusion.py's run (5 iterations, lam_chem carried on the device)
    against the reference's scan and against the port's own host loop."""
    _, jf, tf, b_chem, b_haadf = setup
    x0 = np.full((NEL, NS, N, N), 0.1, np.float32)
    args = (0.2, 0.1, 5, 2, 3, 1e-3)
    xj, mj = j_run(jnp.asarray(x0), jnp.asarray(b_haadf),
                   jnp.asarray(b_chem), jf, *args)
    bh, bc = to_sl(_t(b_haadf)), to_sl(_t(b_chem))
    xt, mt = fusion.data_fusion_run(to_sl(_t(x0)), bh, bc, tf, *args)
    assert mt.shape == (5, 3)
    _close(from_sl(xt).numpy(), xj, 1e-3)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-3)
    x, lam, chs = to_sl(_t(x0)), 0.1, []
    for i in range(5):
        x, ch, _ = fusion.data_fusion_step(x, bh, bc, tf, 0.2, lam, 2)
        x, _ = ttv.tv_fgp_4d(x, 3, 1e-3)
        chs.append(float(ch))
        if i > 0 and chs[-1] > chs[-2]:
            lam *= 0.95
    np.testing.assert_allclose(xt.numpy(), x.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(mt[:, 0].numpy(), chs, rtol=1e-4)


def test_rescale_and_distance_match_reference(setup):
    _, jf, tf, b_chem, b_haadf = setup
    x = _x0(5, 0.0, 1.0)
    _close(from_sl(fusion.rescale_projections(to_sl(_t(x)), to_sl(_t(b_haadf)),
                                              tf)).numpy(),
           j_rescale(jnp.asarray(x), jnp.asarray(b_haadf), jf))
    np.testing.assert_allclose(
        float(fusion.data_distance_chem(to_sl(_t(x)), to_sl(_t(b_chem)), tf)),
        float(j_ddc(jnp.asarray(x), jnp.asarray(b_chem), jf)), rtol=1e-4)
    assert torch.equal(fusion.rescale_tomograms(_t(x), 10.0), _t(x) * 10.0)


# ------------------------------------------------------------------ 4D TV


def test_tv_4d_matches_reference(f32_duals):
    """The 4D wrappers on a slice-last stack against the reference's XLA
    stencils on the same stack in its layout."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 6, 10, 9)).astype(np.float32) + 0.5
    xs = to_sl(_t(x))
    np.testing.assert_allclose(float(ttv.tv_4d(xs)),
                               float(jtv.tv_4d(jnp.asarray(x))), rtol=2e-6)
    d, tv0 = ttv.tv_fgp_4d(xs, 5, 0.1)
    d_r, tv_r = j_tv_fgp_4d(jnp.asarray(x), 5, 0.1)
    np.testing.assert_allclose(from_sl(d).numpy(), np.asarray(d_r), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(float(tv0), float(tv_r), rtol=2e-6)
    g, tv1 = ttv.tv_gd_4d(xs, 4, 0.05)
    g_r, tv1_r = jtv.tv_gd_4d(jnp.asarray(x), 4, 0.05)
    np.testing.assert_allclose(from_sl(g).numpy(), np.asarray(g_r), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(float(tv1), float(tv1_r), rtol=2e-6)
    for bad in (None, (2, 3)):
        with pytest.raises(ValueError):
            ttv.tv_gd(xs, 1, 0.05, axis_norm=bad)
    with pytest.raises(ValueError):
        ttv.tv_fgp_4d(xs[0], 1, 0.1)


# ------------------------------------------------------------ the slice


def _series(gt, jf_or_geoms, package):
    """(Nslice, Nray, Nangles) HAADF series and per-element chem series of
    the ground truth, projected by `package` ('jax' or 'torch')."""
    if package == "jax":
        jf = jf_or_geoms
        bh = np.asarray(j_fp(j_model(jnp.asarray(gt), jf), jf.haadf.geom))
        bc = np.asarray(j_fp4d(jnp.asarray(gt), jf.chem))
    else:
        tf = jf_or_geoms
        x = to_sl(_t(gt).to(tf.weights.device))
        bh = from_sl(fp_sl(fusion.model_haadf(x, tf), tf.haadf.geom))
        bh = bh.cpu().numpy()
        bc = from_sl(fusion.fp4d(x, tf.chem)).cpu().numpy()
    return bh.transpose(0, 2, 1), [b.transpose(0, 2, 1) for b in bc]


def test_chemical_tomo_matches_reference(setup, f32_duals):
    gt, jf, _, _, _ = setup
    haadf, chem = _series(gt, jf, "jax")
    ha, ca = np.rad2deg(H_ANG), np.rad2deg(C_ANG)
    chem = {"c": chem[0], "zn": chem[1]}
    ref = JChemicalTomo(haadf, ha, chem, ca)
    got = ChemicalTomo(haadf, ha, chem, ca, device="cpu")
    for t in (ref, got):
        t.chemical_tomography(Niter=6, lambdaCHEM=0.2)
    np.testing.assert_allclose(got.costCHEM, ref.costCHEM, rtol=1e-4)
    for t in (ref, got):
        t.data_fusion(Niter=5, lambdaHAADF=0.5, iterSIRT=3, tvIter=3,
                      lambdaTV=1e-3)
    for name in ("costHAADF", "costCHEM", "costTV"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-3)
    np.testing.assert_allclose(got.rmse_per_element(gt),
                               ref.rmse_per_element(gt), rtol=1e-3)
    _close(got.get_recon(), ref.get_recon(), 1e-3)
    assert got.get_recon().shape == (NEL, NS, N, N)


def test_chemical_tomo_fused_and_sart(setup, f32_duals):
    """fused=True follows the host loop; method='sart' runs and differs."""
    gt, jf, _, _, _ = setup
    haadf, chem = _series(gt, jf, "jax")
    ha, ca = np.rad2deg(H_ANG), np.rad2deg(C_ANG)
    chem = {"c": chem[0], "zn": chem[1]}
    runs = {}
    for kw in ({}, {"fused": True}, {"method": "sart"}):
        t = ChemicalTomo(haadf, ha, chem, ca, device="cpu")
        t.chemical_tomography(Niter=4, lambdaCHEM=0.2)
        t.data_fusion(Niter=4, lambdaHAADF=0.5, iterSIRT=2, tvIter=3, **kw)
        runs[tuple(kw)] = t
    host, fused = runs[()], runs[("fused",)]
    np.testing.assert_allclose(fused.costHAADF, host.costHAADF, rtol=1e-5)
    np.testing.assert_allclose(fused.get_recon(), host.get_recon(),
                               rtol=1e-5, atol=1e-6)
    sart = runs[("method",)]
    assert np.isfinite(sart.costHAADF).all()
    assert not np.allclose(sart.get_recon(), host.get_recon())


def test_chemical_tomo_checks_its_input(setup):
    gt, jf, _, _, _ = setup
    haadf, chem = _series(gt, jf, "jax")
    ha, ca = np.rad2deg(H_ANG), np.rad2deg(C_ANG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ChemicalTomo(haadf, ha, {"c": chem[0]}, ca)
    with pytest.raises(ValueError):
        ChemicalTomo(haadf, ha[:-1], {"c": chem[0]}, ca, device="cpu")
    with pytest.raises(ValueError):
        ChemicalTomo(haadf, ha, {"c": chem[0][:, :, :-1]}, ca, device="cpu")


# ---------------------------------------------------------------- golden


def golden_problem():
    """Ground truth (Nel, Ns, N, N) and the angle sets in degrees."""
    c = GOLDEN_CONFIG
    gt = np.stack([nanocube_phantom(c["ns"], c["n"], seed=e + 1)
                   for e in range(c["nel"])])
    span = c["span_deg"]
    return (gt, np.linspace(-span, span, c["na_haadf"]),
            np.linspace(-span, span, c["na_chem"]))


def _run_recipe(tomo, gt) -> dict:
    c = GOLDEN_CONFIG
    tomo.chemical_tomography(Niter=c["chem_iters"],
                             lambdaCHEM=c["lambda_chem"])
    chem_only = np.asarray(tomo.costCHEM, np.float64).tolist()
    tomo.data_fusion(Niter=c["fusion_iters"], lambdaCHEM=c["lambda_chem"],
                     lambdaHAADF=c["lambda_haadf"], lambdaTV=c["lambda_tv"],
                     iterSIRT=c["iter_sirt"], tvIter=c["tv_iter"],
                     method=c["method"])
    out = {"costCHEM_chem": chem_only}
    for name in TRACES[1:]:
        out[name] = np.asarray(getattr(tomo, name), np.float64).tolist()
    out["decay_iterations"] = decay_iterations(out["costHAADF"])
    out["rmse_final"] = np.asarray(tomo.rmse_per_element(gt),
                                   np.float64).tolist()
    return out


def decay_iterations(cost_haadf) -> list:
    """The iterations at which the host loop decayed lambda_chem."""
    return [i for i in range(1, len(cost_haadf))
            if cost_haadf[i] > cost_haadf[i - 1]]


def jax_golden_trace() -> dict:
    """The reference's ChemicalTomo host loop at the golden config."""
    c = GOLDEN_CONFIG
    gt, ha, ca = golden_problem()
    w = j_weights(c["elements"], c["gamma"], c["sigma_method"])
    jf = j_make_fsys(c["n"], np.deg2rad(ha), np.deg2rad(ca), w, c["gamma"])
    haadf, chem = _series(gt, jf, "jax")
    tomo = JChemicalTomo(haadf, ha, dict(zip(c["elements"], chem)), ca,
                         gamma=c["gamma"], sigmaMethod=c["sigma_method"])
    return {"config": c, **_run_recipe(tomo, gt)}


def port_golden_trace(device="cpu", perturb_seed=None) -> dict:
    """The port's replay: its own system, projections and ChemicalTomo
    (float32 duals); with perturb_seed, every datum moved by one ulp up or
    down at random."""
    c = GOLDEN_CONFIG
    gt, ha, ca = golden_problem()
    w = fusion.weights_for_elements(c["elements"], c["gamma"],
                                    c["sigma_method"])
    tf = fusion.make_fusion_system(c["n"], np.deg2rad(ha), np.deg2rad(ca), w,
                                   c["gamma"], device)
    haadf, chem = _series(gt, tf, "torch")
    if perturb_seed is not None:
        rng = np.random.default_rng(perturb_seed)

        def ulp(a):
            to = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
            return np.nextafter(a, to.astype(np.float32)).astype(np.float32)

        haadf, chem = ulp(haadf), [ulp(b) for b in chem]
    saved = config.fgp_dual_dtype
    config.fgp_dual_dtype = torch.float32
    try:
        tomo = ChemicalTomo(haadf, ha, dict(zip(c["elements"], chem)), ca,
                            gamma=c["gamma"], sigmaMethod=c["sigma_method"],
                            device=device)
        return _run_recipe(tomo, gt)
    finally:
        config.fgp_dual_dtype = saved


def golden_deviation(golden: dict, trace: dict) -> dict:
    """Max relative deviation of each trace, absolute of the final rmse."""
    dev = {name: float(np.max(np.abs(np.asarray(trace[name])
                                      - np.asarray(golden[name]))
                              / np.abs(np.asarray(golden[name]))))
           for name in TRACES}
    dev["rmse_final"] = float(np.max(np.abs(
        np.asarray(trace["rmse_final"]) - np.asarray(golden["rmse_final"]))))
    return dev


def check_against_golden(golden: dict, trace: dict) -> dict:
    """Raise AssertionError on a flipped decay branch or a deviation above
    the stored bounds; return the deviations."""
    if trace["decay_iterations"] != golden["decay_iterations"]:
        raise AssertionError(
            f"branch flip: lambda_chem decayed at iterations "
            f"{trace['decay_iterations']}, the golden run at "
            f"{golden['decay_iterations']}")
    dev = golden_deviation(golden, trace)
    over = {k: (v, golden["bounds"][k]) for k, v in dev.items()
            if v > golden["bounds"][k]}
    if over:
        raise AssertionError(f"golden trace drift (deviation, bound): {over}")
    return dev


def test_golden_trace_regenerates_from_reference():
    golden = json.loads(GOLDEN.read_text())
    fresh = jax_golden_trace()
    assert golden["config"] == fresh["config"] == GOLDEN_CONFIG
    check_against_golden(golden, fresh)


def test_golden_problem_has_no_near_ties():
    golden = json.loads(GOLDEN.read_text())
    ch = np.asarray(golden["costHAADF"])
    assert golden["decay_iterations"], "the recipe should decay lambda_chem"
    assert np.min(np.abs(np.diff(ch)) / ch[1:]) > 0.01


def test_port_replays_golden_trace():
    golden = json.loads(GOLDEN.read_text())
    check_against_golden(golden, port_golden_trace())


@pytest.mark.cuda
def test_port_replays_golden_trace_on_card():
    """The same replay through the kernels (K1-K5) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    golden = json.loads(GOLDEN.read_text())
    check_against_golden(golden, port_golden_trace(device="cuda"))


def write_golden() -> None:
    """Run the reference, measure the bounds by the one-ulp study, write
    the file."""
    golden = jax_golden_trace()
    devs = [golden_deviation(golden, port_golden_trace(perturb_seed=s))
            for s in range(STUDY_SEEDS)]
    devs.append(golden_deviation(golden, port_golden_trace()))
    worst = {k: max(d[k] for d in devs) for k in devs[0]}
    golden["bounds"] = {k: float(f"{STUDY_MARGIN * v:.1e}") for k, v in
                        worst.items()}
    golden["study"] = {"seeds": STUDY_SEEDS, "margin": STUDY_MARGIN,
                       "max_deviation": worst,
                       "how": "port plain path on the CPU, data moved by "
                              "one ulp per datum, plus the unperturbed "
                              "replay"}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {GOLDEN}: decays at {golden['decay_iterations']}, "
          f"bounds {golden['bounds']}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
