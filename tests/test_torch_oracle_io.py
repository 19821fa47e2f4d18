"""tomojax_torch's exact-matrix oracle and I/O held against tomojax.

``ray_matrix``, ``fp_oracle`` and ``bp_oracle`` are the reference's
numpy/scipy code, so they are held equal. ``joseph_csr`` (the CSR form of
the port's Joseph A, the yardstick of chip_smoke.py) is held against K1's
and K2's plain versions at 1e-5 of the largest magnitude (another
summation order). Files written by either package's ``io`` must be read
by the other's, in both directions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import io as j_io  # noqa: E402
from tomojax.projector import oracle as j_oracle  # noqa: E402

from tomojax_torch import io  # noqa: E402
from tomojax_torch.geometry import Geometry  # noqa: E402
from tomojax_torch.projector import oracle  # noqa: E402
from tomojax_torch.projector.cuda_joseph import bp_sl, fp_sl  # noqa: E402


@pytest.mark.parametrize("n, angles_deg", [
    (12, np.linspace(-70, 70, 7)),
    (9, np.array([0.0, 30.0, 45.0, 90.0, 135.0, -60.0])),
])
def test_ray_matrix_and_oracles_equal_reference(n, angles_deg):
    got, ref = oracle.ray_matrix(n, angles_deg), j_oracle.ray_matrix(
        n, angles_deg)
    assert got.shape == ref.shape == (len(angles_deg) * n, n * n)
    assert (got != ref).nnz == 0
    rng = np.random.default_rng(0)
    vol = rng.random((3, n, n))
    sino = rng.random((3, len(angles_deg), n))
    np.testing.assert_array_equal(oracle.fp_oracle(got, vol),
                                  j_oracle.fp_oracle(ref, vol))
    np.testing.assert_array_equal(oracle.bp_oracle(got, sino),
                                  j_oracle.bp_oracle(ref, sino))


@pytest.mark.parametrize("n, nt", [(16, 16), (13, 19)])
def test_joseph_csr_is_the_projector_pair(n, nt):
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, 9)), nt)
    a, at, nnz = oracle.joseph_csr(geom, "cpu")
    assert a.layout == torch.sparse_csr and at.layout == torch.sparse_csr
    assert nnz == oracle.joseph_nnz(geom, "cpu") == a.values().numel()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((n, n, 4)).astype(np.float32))
    y = torch.from_numpy(rng.random((9, nt, 4)).astype(np.float32))
    ax = torch.sparse.mm(a, x.reshape(n * n, 4)).reshape(9, nt, 4)
    aty = torch.sparse.mm(at, y.reshape(9 * nt, 4)).reshape(n, n, 4)
    for got, ref in ((ax, fp_sl(x, geom)), (aty, bp_sl(y, geom))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def _payload():
    rng = np.random.default_rng(2)
    recon = rng.random((3, 8, 8)).astype(np.float32)
    meta = {"alg": "sirt", "Niter": 10, "beta": 0.25}
    results = {"dd": rng.random(10), "tv": rng.random(10)}
    return recon, meta, results


def _same(loaded, recon, meta, results):
    got_recon, got_results, got_params = loaded
    np.testing.assert_array_equal(got_recon, recon)
    assert set(got_results) == set(results)
    for k, v in results.items():
        np.testing.assert_array_equal(got_results[k], v.astype(np.float32))
    assert {k: (v.item() if hasattr(v, "item") else v)
            for k, v in got_params.items()} == meta


@pytest.mark.parametrize("writer, reader", [(io, j_io), (j_io, io)])
def test_results_files_interchange(tmp_path, writer, reader):
    h5py = pytest.importorskip("h5py")
    recon, meta, results = _payload()
    path = str(tmp_path / "sub" / "res.h5")
    writer.save_results(path, meta, results, recon)
    _same(reader.load_results(path), recon, meta, results)
    with h5py.File(path, "r") as f:
        assert f["Reconstruction"].attrs["Nslice"] == 3
        assert f["Reconstruction"].attrs["Nray"] == 8


@pytest.mark.parametrize("writer, reader", [(io, j_io), (j_io, io)])
def test_checkpoints_interchange(tmp_path, writer, reader):
    pytest.importorskip("h5py")
    recon, meta, results = _payload()
    path = str(tmp_path / "ckpt.h5")
    writer.save_checkpoint(path, recon, results, meta)
    _same(reader.load_checkpoint(path), recon, meta, results)
    side = str(tmp_path / "side.h5")  # history only
    writer.save_checkpoint(side, None, results)
    got = reader.load_checkpoint(side)
    assert got[0] is None and set(got[1]) == set(results)


def test_tilt_series_loaders_match_reference(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    series = rng.random((4, 10, 6)).astype(np.float32)
    angles = np.linspace(-60, 60, 6)
    h5 = str(tmp_path / "ts.h5")
    with h5py.File(h5, "w") as f:
        f["tiltSeries"] = series
        f["tiltAngles"] = angles
    for a, b in zip(io.load_h5_data(h5), j_io.load_h5_data(h5)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    npy = str(tmp_path / "ts.npy")
    np.save(npy, series.astype(np.float64))
    np.testing.assert_array_equal(io.load_tilt_series(npy),
                                  j_io.load_tilt_series(npy))
    image = pytest.importorskip("PIL.Image")
    tif = str(tmp_path / "ts.tif")
    frames = [image.fromarray(s) for s in series]
    frames[0].save(tif, save_all=True, append_images=frames[1:])
    got = io.load_tilt_series(tif)
    np.testing.assert_array_equal(got, j_io.load_tilt_series(tif))
    assert got.shape == (6, 10, 4)
    with pytest.raises(ValueError, match="unsupported"):
        io.load_tilt_series(str(tmp_path / "ts.txt"))
