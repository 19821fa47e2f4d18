"""tomojax_torch FBP (filter bank, ``filter_sinogram``, ``fbp``), CGLS,
``TomoTorch.wbp`` / ``.cgls`` held against tomojax, and the SIRT golden
trace replayed by the port.

The filter responses are the reference's numpy code, so they are held
equal bit for bit. The filtered sinograms and FBP volumes go through
each package's FFT (pocketfft under jnp.fft and torch.fft) and projector
(the reference's 'mxu' contraction, the port's 2-tap gathers), and are
held at 1e-5 of the largest magnitude. CGLS amplifies the projectors'
last-digit differences over its iterations; 5 iterations are held at
rtol 1e-4 (atol 1e-4 of the largest magnitude), the bound the port's
other iterative solvers are held at (tests/test_torch_sirt.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import TomoTPU  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector import filters as j_filters  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.solvers import make_system as j_sys  # noqa: E402
from tomojax.solvers.iterative import cgls_run as j_cgls  # noqa: E402
from tomojax.solvers.wbp import fbp as j_fbp  # noqa: E402

from tomojax_torch import TomoTorch, ops  # noqa: E402
from tomojax_torch.convert import system_from_numpy  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import filters  # noqa: E402
from tomojax_torch.projector.cuda_joseph import fp_sl  # noqa: E402
from tomojax_torch.sim import (  # noqa: E402
    create_projections, nanocube_phantom, shepp_logan,
)
from tomojax_torch.solvers import (  # noqa: E402
    cgls_run, cgls_run_sl, fbp, fbp_sl, from_sl, make_system, sirt_sweep,
    to_sl,
)

from test_golden_traces import GOLDEN_SIRT_DD  # noqa: E402

# (N, Na, Ns, Nt): one shape with Nt != N
SHAPES = [(24, 9, 3, 24), (20, 7, 4, 27)]


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _problem(n, na, ns, nt, span=70, seed=0):
    ang = np.deg2rad(np.linspace(-span, span, na))
    jgeom, geom = JGeometry.make(n, ang, nt), Geometry.make(n, ang, nt)
    vol = nanocube_phantom(ns, n, seed=seed)
    b = np.array(j_fp(jnp.asarray(vol), jgeom))
    return jgeom, geom, vol, b


def test_filter_bank_is_the_reference_s():
    assert filters.FILTERS == j_filters.FILTERS
    assert len(filters.FILTERS) == 18 and "none" in filters.FILTERS


@pytest.mark.parametrize("name", [f for f in j_filters.FILTERS
                                  if f != "none"])
@pytest.mark.parametrize("nray", [24, 27, 100])
def test_filter_response_equals_reference(name, nray):
    got, m = filters.make_filter(name, nray)
    ref, m_ref = j_filters.make_filter(name, nray)
    assert m == m_ref and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_unknown_filter_raises():
    with pytest.raises(ValueError, match="unknown FBP filter"):
        filters.make_filter("no-such-window", 32)


@pytest.mark.parametrize("name", j_filters.FILTERS)
def test_filter_sinogram_matches_reference(name):
    _, _, _, b = _problem(*SHAPES[1])
    ref = np.asarray(j_filters.filter_sinogram(jnp.asarray(b), name))
    got = filters.filter_sinogram(to_sl(torch.from_numpy(b)), name)
    assert got.shape == (7, 27, 4) and got.dtype == torch.float32
    _close(from_sl(got).numpy(), ref, 1e-5)


@pytest.mark.parametrize("name", j_filters.FILTERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fbp_matches_reference(name, shape):
    jgeom, geom, _, b = _problem(*shape)
    ref = np.asarray(j_fbp(jnp.asarray(b), jgeom, name))
    got = fbp(torch.from_numpy(b), geom, name)
    _close(got.numpy(), ref, 1e-5)
    assert float(got.min()) >= 0.0


@pytest.mark.parametrize("positivity", [True, False])
def test_fbp_sl_and_positivity(positivity):
    jgeom, geom, _, b = _problem(*SHAPES[0])
    ref = np.asarray(j_fbp(jnp.asarray(b), jgeom, "hann", positivity))
    got = fbp_sl(to_sl(torch.from_numpy(b)), geom, "hann", positivity)
    assert got.shape == (24, 24, 3)
    _close(from_sl(got).numpy(), ref, 1e-5)
    if not positivity:
        assert float(got.min()) < 0.0


def test_fbp_one_angle_uses_pi():
    jgeom, geom, _, b = _problem(16, 1, 2, 16)
    ref = np.asarray(j_fbp(jnp.asarray(b), jgeom))
    _close(fbp(torch.from_numpy(b), geom).numpy(), ref, 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_cgls_run_matches_reference(shape):
    jgeom, geom, _, b = _problem(*shape, seed=1)
    jsys = j_sys(jgeom)
    sysd = system_from_numpy(geom, np.asarray(jsys.row_sum),
                             np.asarray(jsys.col_sum),
                             np.asarray(jsys.lipschitz), "cpu")
    x0 = np.zeros((shape[2], shape[0], shape[0]), np.float32)
    ref = np.asarray(j_cgls(jnp.asarray(x0), jnp.asarray(b), jsys, 5))
    got = cgls_run(torch.from_numpy(x0), torch.from_numpy(b), sysd, 5)
    _close(got.numpy(), ref, 1e-4)
    # from a warm start, slice-last, with the port's own weights
    x1 = ref * 0.5
    ref = np.asarray(j_cgls(jnp.asarray(x1), jnp.asarray(b), jsys, 3))
    got = cgls_run_sl(to_sl(torch.from_numpy(x1)), to_sl(torch.from_numpy(b)),
                      make_system(geom, "cpu"), 3)
    _close(from_sl(got).numpy(), ref, 1e-4)


def test_cgls_per_slice_guards():
    """A zero slice keeps zero scalars (the where guards), and the other
    slices converge as they would alone."""
    _, geom, vol, b = _problem(*SHAPES[0], seed=2)
    b[1] = 0.0
    sysd = make_system(geom, "cpu")
    x = cgls_run(torch.zeros(vol.shape), torch.from_numpy(b), sysd, 4)
    assert bool(torch.isfinite(x).all()) and float(x[1].abs().max()) == 0.0
    alone = cgls_run(torch.zeros((1,) + vol.shape[1:]),
                     torch.from_numpy(b[:1]), sysd, 4)
    _close(x[:1].numpy(), alone.numpy(), 1e-6)


def _series(ns=8, n=24, angles=np.linspace(-70, 70, 13)):
    """(Nslice, Nray, Nangles) tilt series of scaled Shepp-Logan slices;
    8 slices divide the suite's 8-device mesh, so TomoTPU runs unpadded."""
    rng = np.random.default_rng(1)
    ph = np.stack([shepp_logan(n)] * ns) * rng.uniform(
        0.8, 1.2, size=(ns, 1, 1)).astype(np.float32)
    b = np.asarray(j_fp(jnp.asarray(ph), JGeometry.make(n,
                                                        np.deg2rad(angles))))
    return angles, np.transpose(b, (0, 2, 1))


@pytest.mark.parametrize("name", ["ram-lak", "hann", "no-such-filter"])
def test_tomotorch_wbp_matches_tomotpu(name, capsys):
    angles, ts = _series()
    ref = TomoTPU(angles, ts).wbp(name)
    got = TomoTorch(angles, ts, device="cpu").wbp(name)
    if name == "no-such-filter":
        assert "Defaulting to ram-lak" in capsys.readouterr().out
    _close(got.get_recon(), ref.get_recon(), 1e-5)
    no_clamp = TomoTorch(angles, ts, device="cpu").wbp(name, False)
    assert float(no_clamp.get_recon().min()) < 0.0


def test_tomotorch_cgls_matches_tomotpu():
    angles, ts = _series()
    ref = TomoTPU(angles, ts).cgls(Niter=5)
    got = TomoTorch(angles, ts, device="cpu").cgls(Niter=5)
    _close(got.get_recon(), ref.get_recon(), 1e-4)
    assert float(got.get_recon().min()) >= 0.0
    assert got.cost.shape == (1,)
    # the data distance is a residual ||A x - b||, smaller than b by two
    # orders here, so x's last-digit differences weigh more in it: it is
    # held at TomoTorch.fista's cost bound (tests/test_torch_api.py)
    np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-3)
    np.testing.assert_allclose(got.cost[0], got.data_distance(), rtol=1e-6)


def test_golden_sirt_trace():
    """The port alone (its own geometry, weights and projections) replays
    the reference's CPU golden SIRT trace (tests/test_golden_traces.py:
    32^2 Shepp-Logan, 20 angles over +-70 degrees, 2 ASTRA-SIRT iterations
    a point) at its rtol 2e-3."""
    n = 32
    geom = Geometry.make(n, np.deg2rad(np.linspace(-70, 70, 20)))
    sysd = make_system(geom, "cpu")
    ph = torch.from_numpy(shepp_logan(n)[None])
    b = create_projections(ph, geom)
    x = torch.zeros_like(ph)
    trace = []
    for _ in range(5):
        x = sirt_sweep(x, b, sysd, 2)
        trace.append(float(ops.data_distance(
            fp_sl(to_sl(x), geom), to_sl(b))))
    np.testing.assert_allclose(trace, GOLDEN_SIRT_DD, rtol=2e-3)
