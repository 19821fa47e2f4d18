"""tomojax_torch geometry and system weights held against tomojax.

Same numpy angles into both packages; the reference's weights come from
its exact-f32 'gather' projector mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import config as tjconfig  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.solvers import make_system as j_make_system  # noqa: E402

from tomojax_torch.convert import system_from_numpy  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.solvers import make_system  # noqa: E402

ANGLE_SETS = {
    "tilt76": np.deg2rad(np.linspace(-76, 76, 90)),
    "exact_axes": np.deg2rad([0.0, 45.0, 90.0, 135.0, 180.0, -90.0]),
    "random": np.random.default_rng(3).uniform(-np.pi, np.pi, 17),
}


@pytest.mark.parametrize("name", sorted(ANGLE_SETS))
def test_geometry_arrays_equal(name):
    ang = ANGLE_SETS[name]
    g, jg = Geometry.make(64, ang), JGeometry.make(64, ang)
    assert (g.n, g.nray, g.nproj) == (jg.n, jg.nray, jg.nproj)
    for attr in ("angles", "cos", "sin", "driving", "row_driven"):
        np.testing.assert_array_equal(getattr(g, attr), getattr(jg, attr))
    assert (g.det_center, g.img_center) == (jg.det_center, jg.img_center)


def _j_system_gather(jgeom):
    prev = tjconfig.projector_mode
    try:
        tjconfig.set_projector_mode("gather")
        return j_make_system(jgeom)
    finally:
        tjconfig.set_projector_mode(prev)


@pytest.mark.parametrize("n,na", [(32, 15), (33, 7), (16, 1)])
def test_make_system_matches_reference(n, na):
    ang = np.deg2rad(np.linspace(-76, 76, na))
    ref = _j_system_gather(JGeometry.make(n, ang))
    got = make_system(Geometry.make(n, ang), "cpu")
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.row_sum.numpy(),
                               np.asarray(ref.row_sum)[0], **tol)
    np.testing.assert_allclose(got.col_sum.numpy(),
                               np.asarray(ref.col_sum)[0], **tol)
    np.testing.assert_allclose(float(got.lipschitz), float(ref.lipschitz),
                               **tol)
    np.testing.assert_allclose(got.inv_row.numpy(),
                               np.asarray(ref.inv_row)[0], **tol)
    np.testing.assert_allclose(got.inv_col.numpy(),
                               np.asarray(ref.inv_col)[0], **tol)


def test_system_from_numpy_carries_reference_weights():
    ang = np.deg2rad(np.linspace(-70, 70, 11))
    ref = _j_system_gather(JGeometry.make(24, ang))
    geom = Geometry.make(24, ang)
    got = system_from_numpy(geom, np.asarray(ref.row_sum),
                            np.asarray(ref.col_sum),
                            np.asarray(ref.lipschitz), "cpu")
    assert got.row_sum.shape == (11, 24) and got.col_sum.shape == (24, 24)
    np.testing.assert_array_equal(got.inv_col.numpy(),
                                  np.asarray(ref.inv_col)[0])
    own = make_system(geom, "cpu")
    np.testing.assert_allclose(got.row_sum.numpy(), own.row_sum.numpy(),
                               rtol=1e-5, atol=1e-6)
