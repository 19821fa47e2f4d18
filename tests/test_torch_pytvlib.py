"""tomojax_torch.pytvlib and TomoTorch's remaining methods held against
tomojax, and the new methods on a slab group of one rank.

``pytvlib.run`` runs every alias on a TomoTorch and on a TomoTPU with the
same data, and the reconstructions are held at each solver's bound in the
port's other tests: 1e-5 of the largest magnitude for FBP and ART (this
PR's tests/test_torch_fbp_cgls.py, test_torch_art.py), 1e-4 for SIRT,
Cimmino, CGLS and Poisson-ML (tests/test_torch_sirt.py), rtol 2e-4 and
atol 2e-4 for SART and atol 2e-3 for ASD-POCS
(tests/test_torch_asd_pocs.py). randART draws its orders from another
stream than the reference's, so it is held against the reference's sweep
over the port's orders.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import TomoTPU  # noqa: E402
from tomojax import pytvlib as j_pytvlib  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import make_system as j_sys  # noqa: E402
from tomojax.solvers.iterative import art_sweep as j_art  # noqa: E402

from tomojax_torch import Simulator, TomoTorch, pytvlib  # noqa: E402
from tomojax_torch.dist import init_distributed  # noqa: E402
from tomojax_torch.sim import nanocube_phantom, shepp_logan  # noqa: E402

N, NS = 24, 8
ANGLES = np.linspace(-70, 70, 11)
REPO = Path(__file__).resolve().parents[1]

BOUNDS = {  # alias: (rtol, atol relative to max|ref|)
    "fbp": (1e-5, 1e-5), "wbp": (1e-5, 1e-5), "art": (1e-5, 1e-5),
    "sirt": (1e-4, 1e-4), "fista": (1e-4, 1e-4), "cimminosirt": (1e-4, 1e-4),
    "cgls": (1e-4, 1e-4), "poisson_ml": (1e-4, 1e-4),
    "kl-divergence": (1e-4, 1e-4), "sart": (2e-4, 2e-4),
    "asd-pocs": (0.0, 2e-3),
}


def _series(ns=NS, n=N, angles=ANGLES):
    """(Nslice, Nray, Nangles) series of scaled Shepp-Logan slices; 8
    slices divide the suite's 8-device mesh, so TomoTPU runs unpadded."""
    rng = np.random.default_rng(1)
    ph = np.stack([shepp_logan(n)] * ns) * rng.uniform(
        0.8, 1.2, size=(ns, 1, 1)).astype(np.float32)
    b = np.asarray(j_fp(jnp.asarray(ph), JGeometry.make(n,
                                                        np.deg2rad(angles))))
    return np.transpose(b, (0, 2, 1))


def test_new_modules_leave_jax_out():
    code = ("import sys, tomojax_torch.pytvlib, tomojax_torch.io, "
            "tomojax_torch.projector.oracle, tomojax_torch.projector.filters, "
            "tomojax_torch.solvers.wbp, tomojax_torch.solvers.cuda_art, "
            "tomojax_torch.sim, tomojax_torch.ops; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tomojax' not in sys.modules, 'tomojax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_lists_match_reference():
    assert pytvlib.wbp_filters() == j_pytvlib.wbp_filters()
    assert pytvlib.sart_orders() == j_pytvlib.sart_orders()
    assert pytvlib._ALG_ALIASES == j_pytvlib._ALG_ALIASES


@pytest.mark.parametrize("alias", sorted(BOUNDS))
def test_run_matches_reference(alias):
    ts = _series()
    got = TomoTorch(ANGLES, ts, device="cpu")
    ref = TomoTPU(ANGLES, ts)
    for tomo, lib in ((got, pytvlib), (ref, j_pytvlib)):
        lib.initialize_algorithm(tomo, alias.upper())
        assert lib.run(tomo, alias, beta=0.5, niter=2) is tomo
    rtol, atol = BOUNDS[alias]
    want = ref.get_recon()
    np.testing.assert_allclose(got.get_recon(), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))
    assert float(np.abs(want).max()) > 0.0


def test_run_randart_sweeps_the_port_s_orders():
    ts = _series()
    tomo = TomoTorch(ANGLES, ts, device="cpu")
    pytvlib.initialize_algorithm(tomo, "randART")
    pytvlib.run(tomo, "randart", beta=0.5, niter=2)
    gen = torch.Generator().manual_seed(0)
    rays = len(ANGLES) * N
    jsys = j_sys(JGeometry.make(N, np.deg2rad(ANGLES)))
    x = jnp.zeros((NS, N, N), jnp.float32)
    b = jnp.asarray(np.transpose(ts, (0, 2, 1)))
    for _ in range(2):
        order = torch.randperm(rays, generator=gen).numpy().astype(np.int32)
        x = j_art(x, b, jsys, 0.5, jnp.asarray(order))
    want = np.asarray(x)
    np.testing.assert_allclose(tomo.get_recon(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("alias, opt", [("sart", "random"), ("fbp", "hann")])
def test_run_takes_the_sub_option(alias, opt):
    ts = _series()
    tomo = TomoTorch(ANGLES, ts, device="cpu")
    pytvlib.initialize_algorithm(tomo, alias, opt)
    pytvlib.run(tomo, alias, niter=1)
    plain = TomoTorch(ANGLES, ts, device="cpu")
    if alias == "sart":
        plain.sart(Niter=1, init="random", show_convergence=False)
    else:
        plain.wbp("hann")
    np.testing.assert_array_equal(tomo.get_recon(), plain.get_recon())


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        pytvlib.initialize_algorithm(object(), "no-such-alg")


def test_check_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pytvlib.check_cuda()


def test_io_shims_match_reference(tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    monkeypatch.chdir(tmp_path)
    os.makedirs("Tilt_Series")
    ts = _series(ns=2)
    with h5py.File("Tilt_Series/256_au.h5", "w") as f:
        f["tiltSeries"] = ts
        f["tiltAngles"] = ANGLES
    np.save("Tilt_Series/256au_tiltser.npy", ts)
    for got, ref in ((pytvlib.load_h5_data("256", "au.h5"),
                      j_pytvlib.load_h5_data("256", "au.h5")),
                     (pytvlib.load_data("256", "au_tiltser.npy"),
                      j_pytvlib.load_data("256", "au_tiltser.npy"))):
        assert got[0] == ref[0]
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)
    tomo = TomoTorch(ANGLES, ts, device="cpu").wbp()
    path = pytvlib.save_results(("au", "wbp"), {"alg": "wbp"},
                                {"dd": np.ones(3)}, tomo, save_recon=True)
    assert path == "results/au/wbp.h5"
    recon, results, params = j_pytvlib._io.load_results(path)
    np.testing.assert_array_equal(recon, tomo.get_recon())
    assert params["alg"] == "wbp" and results["dd"].shape == (3,)


def test_small_methods_match_tomotpu():
    ts = _series()
    ref = TomoTPU(ANGLES, ts).sirt(Niter=2)
    got = TomoTorch(ANGLES, ts, device="cpu").sirt(Niter=2)
    assert got.lipschitz() == pytest.approx(ref.lipschitz(), rel=1e-5)
    pg, pr = got.get_projections(), ref.get_projections()
    assert pg.shape == (NS, len(ANGLES), N)  # the sinogram layout
    np.testing.assert_array_equal(pg, pr)
    mg, mr = got.get_model_projections(), ref.get_model_projections()
    assert mg.shape == pg.shape
    np.testing.assert_allclose(mg, mr, rtol=1e-4,
                               atol=1e-4 * float(np.abs(mr).max()))


def test_update_projection_angles_keeps_the_warm_start():
    ts = _series()
    more = np.concatenate([ANGLES, [75.0, -75.0]])
    ts2 = _series(angles=more)
    ref = TomoTPU(ANGLES, ts).sirt(Niter=2)
    got = TomoTorch(ANGLES, ts, device="cpu").sirt(Niter=2)
    x_before = got.get_recon().copy()
    assert got.update_projection_angles(more, ts2) is got
    ref.update_projection_angles(more, ts2)
    assert got.geom.nproj == len(more) and got.b_sl.shape == (13, N, NS)
    np.testing.assert_array_equal(got.get_recon(), x_before)
    np.testing.assert_allclose(got.get_model_projections(),
                               ref.get_model_projections(), rtol=1e-4,
                               atol=1e-3)
    # another slice count: the warm start is dropped
    got.update_projection_angles(more, ts2[:3])
    assert got.get_recon().shape == (3, N, N)
    assert float(np.abs(got.get_recon()).max()) == 0.0


def test_new_methods_on_a_group_of_one(tmp_path):
    """Simulator and the new methods with group= (gloo, world size 1, a
    file store in a temporary directory): the per-slice solvers need no
    collective, their costs and rmse all-reduce; results equal the
    unsharded run's."""
    import torch.distributed as dist

    vol = nanocube_phantom(5, 16, seed=6)
    angles = np.linspace(-60, 60, 7)
    group = init_distributed(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        sims = [Simulator(vol, angles, snr=100, group=group),
                Simulator(vol, angles, snr=100, device="cpu")]
        out = []
        for sim in sims:
            row = {"proj": sim.get_projections()}
            for name, run in (("wbp", lambda s: s.wbp("shepp-logan")),
                              ("cgls", lambda s: s.cgls(Niter=3)),
                              ("art", lambda s: s.art(Niter=1))):
                run(sim)
                row[name] = (sim.get_recon().copy(), sim.rmse(),
                             None if name == "wbp" else sim.cost.copy())
            row["model"] = sim.get_model_projections()
            out.append(row)
    finally:
        dist.destroy_process_group()
    sharded, whole = out
    np.testing.assert_array_equal(sharded["proj"], whole["proj"])
    np.testing.assert_allclose(sharded["model"], whole["model"], rtol=1e-6)
    for name in ("wbp", "cgls", "art"):
        (xs, rs, cs), (xw, rw, cw) = sharded[name], whole[name]
        np.testing.assert_allclose(xs, xw, rtol=1e-6, atol=1e-7)
        assert rs == pytest.approx(rw, rel=1e-6)
        if cs is not None:
            np.testing.assert_allclose(cs, cw, rtol=1e-6)
