"""tomojax_torch.stream (the file helpers, TiltWatcher and
DynamicReconstructor) held against tomojax.stream.

The reference projects in its 'gather' mode here (a fixture sets
``tomojax.config.projector_mode`` and restores it), the 2-tap gathers the
port's plain versions compute; its default on the CPU, 'mxu', rounds
differently in the last digits. The port runs on device="cpu". Bounds,
each stated at its assertion: masked SIRT dd at rtol 1e-5 and the volume
within 1e-5 max|x|; the CS rounds' dd at rtol 1e-3 (the ASD-POCS bound of
tests/test_torch_asd_pocs.py), dPOCS at rtol 1e-5 with the same decay
iterations, and the volume at atol 2e-3 (that file's x bound). The file
helpers are numpy in both packages and must agree bit for bit.

The reference keeps its carried A x when `iterate_cs` or `resume`
reassigns x (its ``stream.py`` iterate_cs / resume), so its next
`iterate` takes one step with a stale A x. Every test here that runs
`iterate` after either resets the reference's ``_ax`` first, so that both
packages start from A x of the current x; the port drops its carried
residual there by itself, which `test_port_reseeds_after_reassigning_x`
holds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tomojax import config as tjconfig  # noqa: E402
from tomojax import stream as j_stream  # noqa: E402
from tomojax.geometry import Geometry as JGeometry  # noqa: E402
from tomojax.projector.joseph import fp as j_fp  # noqa: E402
from tomojax.sim import shepp_logan  # noqa: E402

from tomojax_torch import stream  # noqa: E402

N = 32
SIRT_RTOL = 1e-5  # dd; the volume within SIRT_RTOL * max|x|
CS_DD_RTOL, CS_DPOCS_RTOL, CS_X_ATOL = 1e-3, 1e-5, 2e-3


@pytest.fixture
def gather():
    prev = tjconfig.projector_mode
    tjconfig.set_projector_mode("gather")
    try:
        yield
    finally:
        tjconfig.set_projector_mode(prev)


def dose_symmetric(n: int, step: float) -> np.ndarray:
    """0, +step, -step, +2 step, ...: the signs interleave, as a
    dose-symmetric tilt scheme acquires them."""
    k = np.arange(1, n)
    return np.concatenate([[0.0], ((k + 1) // 2) * step
                           * np.where(k % 2, 1.0, -1.0)])


def _sinogram(ns: int, angles_deg, seed: int = 0) -> np.ndarray:
    """(Ns, Na, Nt) projections of Shepp-Logan slices scaled from `seed`,
    by the reference's gather projector."""
    rng = np.random.default_rng(seed)
    ph = np.stack([shepp_logan(N) * s for s in rng.uniform(0.5, 1.5, ns)])
    geom = JGeometry.make(N, np.deg2rad(angles_deg))
    return np.asarray(j_fp(jnp.asarray(ph, jnp.float32), geom,
                           mode="gather"))


def _arrivals(b, angles, lo, hi):
    return [(float(angles[i]), b[:, i, :]) for i in range(lo, hi)]


def _pair(alg="sirt", max_angles=12, bucket=8, **kw):
    return (j_stream.DynamicReconstructor(N, max_angles, bucket, alg=alg,
                                          **kw),
            stream.DynamicReconstructor(N, max_angles, bucket, alg=alg,
                                        device="cpu", **kw))


def _x_close(got, ref, atol=None):
    x_ref = np.asarray(ref.x)
    assert got.get_recon().shape == x_ref.shape
    bound = SIRT_RTOL * np.abs(x_ref).max() if atol is None else atol
    np.testing.assert_allclose(got.get_recon(), x_ref, atol=bound)


# --------------------------------------------------------- file helpers --


@pytest.mark.parametrize("name", [
    "proj_-42.5.npy", "a/b/tilt_10.0deg.h5", "x_3.tif", "x_-0.25.tiff",
    "frame_7.dm4", "frame_7.dm3", "nonsense.npy", "proj_1.0.png"])
def test_parse_angle_matches_reference(name):
    try:
        want = j_stream.parse_angle_from_name(name)
    except ValueError:
        with pytest.raises(ValueError):
            stream.parse_angle_from_name(name)
        return
    assert stream.parse_angle_from_name(name) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("patch,clamp", [(None, True), (None, False),
                                         (5, True)])
def test_preprocess_matches_reference_bit_for_bit(seed, patch, clamp):
    rng = np.random.default_rng(seed)
    img = rng.gamma(2.0, 1.0, size=(24 + seed, 30)).astype(np.float32)
    img[10:18, 12:25] += 6.0
    got = stream.background_subtract(img.copy(), patch, clamp)
    ref = j_stream.background_subtract(img.copy(), patch, clamp)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(stream.center_of_mass_align(got),
                          j_stream.center_of_mass_align(ref))
    zero = np.zeros((6, 6), np.float32)  # total <= 0: unchanged
    assert np.array_equal(stream.center_of_mass_align(zero), zero)


def test_read_projection_formats_match_reference(tmp_path):
    import h5py
    from PIL import Image

    rng = np.random.default_rng(4)
    img = rng.random((12, 20)).astype(np.float32)
    paths = {ext: str(tmp_path / f"p_1.0{ext}")
             for ext in (".npy", ".h5", ".tif", ".dm4")}
    np.save(paths[".npy"], img.astype(np.float64))
    with h5py.File(paths[".h5"], "w") as f:
        f["frame"] = img
    Image.fromarray(img).save(paths[".tif"])
    stream.dm.write_dm4(paths[".dm4"], img, stage_alpha=1.0)
    for path in paths.values():
        got, ref = stream.read_projection(path), j_stream.read_projection(path)
        assert got.dtype == ref.dtype == np.float32
        assert np.array_equal(got, ref) and np.array_equal(got, img)
    with pytest.raises(ValueError):
        stream.read_projection(str(tmp_path / "p.png"))


def test_watcher_log_matches_reference_file(tmp_path):
    import h5py

    data = tmp_path / "acq"
    data.mkdir()
    logs = [str(tmp_path / "port.h5"), str(tmp_path / "ref.h5")]
    watchers = [stream.TiltWatcher(str(data), log_path=logs[0]),
                j_stream.TiltWatcher(str(data), log_path=logs[1])]
    rng = np.random.default_rng(5)
    for batch in ((-3.0, 7.5), (1.0,), ()):
        for a in batch:
            np.save(str(data / f"proj_{a}.npy"),
                    rng.random((6, 10)).astype(np.float32))
        got, ref = (w.poll() for w in watchers)
        assert [a for a, _ in got] == [a for a, _ in ref]
    with h5py.File(logs[0], "r") as fg, h5py.File(logs[1], "r") as fr:
        assert sorted(fg) == sorted(fr) == ["projections", "tiltAngles"]
        for key in fg:
            assert fg[key].dtype == fr[key].dtype
            assert fg[key].maxshape == fr[key].maxshape
            assert np.array_equal(fg[key][...], fr[key][...])
    assert watchers[0].check_for_new_tilts() is False


# ------------------------------------------------- DynamicReconstructor --


def test_device_rules():
    with pytest.raises(ValueError, match="device or a group"):
        stream.DynamicReconstructor(N, 8, device="cpu", group=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            stream.DynamicReconstructor(N, 8)


def test_masked_sirt_matches_reference(gather):
    """Two acquisition rounds, 8 then 16 angles (bucket 8) in a
    dose-symmetric order, past max_angles = 12; two calls a round, the
    second on the carried residual."""
    ang = dose_symmetric(16, 7.5)
    b = _sinogram(4, ang)
    ref, got = _pair(max_angles=12)
    for lo, hi in ((0, 8), (8, 16)):
        for rec in (ref, got):
            rec.add_projections(_arrivals(b, ang, lo, hi))
            rec.iterate(5)
            rec.iterate(3)
    assert got._buf.shape[0] == 16  # the capacity grew past max_angles
    np.testing.assert_allclose(got.dd_history, ref.dd_history,
                               rtol=SIRT_RTOL)
    _x_close(got, ref)
    assert got.dd_history[-1] < got.dd_history[-2]


@pytest.mark.parametrize("bucket", [1, 3, 8])
def test_masked_sirt_one_angle_at_a_time(gather, bucket):
    """Arrivals of one angle each, from one angle up, with the buffer's
    capacity at the angle count (bucket 1) or above it. One or two angles
    leave a problem that two sweeps solve to the rounding floor, where dd
    is a last-digit residue: dd is held at rtol 1e-5 and within 1e-5 of
    the data's norm."""
    ang = dose_symmetric(5, 20.0)
    b = _sinogram(2, ang, seed=1)
    ref, got = _pair(max_angles=5, bucket=bucket)
    for i in range(5):
        for rec in (ref, got):
            rec.add_projections(_arrivals(b, ang, i, i + 1))
            rec.iterate(2)
    np.testing.assert_allclose(got.dd_history, ref.dd_history,
                               rtol=SIRT_RTOL,
                               atol=SIRT_RTOL * np.linalg.norm(b))
    _x_close(got, ref)


def test_cs_rounds_match_reference(gather):
    """Two acquisition rounds of CS iterations, one iteration a call so
    that every dPOCS is seen (it carries across calls), then one call of
    three."""
    ang = dose_symmetric(16, 7.5)
    b = _sinogram(4, ang)
    ref, got = _pair("cs")
    dpocs = {ref: [], got: []}
    for lo, hi in ((0, 8), (8, 16)):
        for rec in (ref, got):
            rec.add_projections(_arrivals(b, ang, lo, hi))
            for _ in range(4):
                rec.iterate_cs(1)
                dpocs[rec].append(rec._dpocs)
            rec.iterate_cs(3)
            dpocs[rec].append(rec._dpocs)
    np.testing.assert_allclose(got.dd_history, ref.dd_history,
                               rtol=CS_DD_RTOL)
    np.testing.assert_allclose(dpocs[got], dpocs[ref], rtol=CS_DPOCS_RTOL)
    decays = [np.diff(np.log(dpocs[r])) < -0.01 for r in (got, ref)]
    assert np.array_equal(*decays) and decays[0].any()
    _x_close(got, ref, atol=CS_X_ATOL)


def test_iterate_after_iterate_cs_matches_reference(gather):
    ang = dose_symmetric(8, 10.0)
    b = _sinogram(3, ang)
    ref, got = _pair(max_angles=8)
    for rec in (ref, got):
        rec.add_projections(_arrivals(b, ang, 0, 8))
        rec.iterate(3)
        rec.iterate_cs(2)
    assert got._resid is None  # x reassigned: the residual was dropped
    ref._ax = None  # the reference's stale carried A x (module docstring)
    for rec in (ref, got):
        rec.iterate(3)
    np.testing.assert_allclose(got.dd_history, ref.dd_history,
                               rtol=CS_DD_RTOL)
    _x_close(got, ref, atol=CS_X_ATOL)


def test_port_reseeds_after_reassigning_x():
    """After iterate_cs, and after assigning x, the next iterate equals
    that of a fresh reconstructor given the same x (which has to seed its
    residual with one K1)."""
    ang = dose_symmetric(8, 10.0)
    b = _sinogram(3, ang)
    rec = stream.DynamicReconstructor(N, 8, device="cpu", alg="cs")
    rec.add_projections(_arrivals(b, ang, 0, 8))
    rec.iterate(4)
    rec.iterate_cs(2)
    for step in ("after iterate_cs", "after assigning x"):
        fresh = stream.DynamicReconstructor(N, 8, device="cpu")
        fresh.add_projections(_arrivals(b, ang, 0, 8))
        fresh.x = rec.x.clone()
        assert fresh.iterate(3) == rec.iterate(3), step
        assert torch.equal(fresh.x, rec.x), step
        rec.x = rec.x * 0.5


def test_checkpoints_resume_across_packages(gather, tmp_path):
    """A checkpoint of either package resumes in the other with the same
    volume and history; iterate after resume matches the reference."""
    ang = dose_symmetric(8, 10.0)
    b = _sinogram(3, ang)
    paths = {"ref": str(tmp_path / "ref.h5"), "port": str(tmp_path / "p.h5")}
    ref = j_stream.DynamicReconstructor(N, 8, checkpoint_path=paths["ref"])
    got = stream.DynamicReconstructor(N, 8, device="cpu",
                                      checkpoint_path=paths["port"])
    for rec in (ref, got):
        assert rec.resume() is False  # no file yet
        rec.checkpoint()  # x is None: nothing is written
        rec.add_projections(_arrivals(b, ang, 0, 8))
        rec.iterate(4)
        rec.checkpoint()
    for writer, cls, kw in (("ref", stream.DynamicReconstructor,
                             {"device": "cpu"}),
                            ("port", j_stream.DynamicReconstructor, {})):
        src = ref if writer == "ref" else got
        back = cls(N, 8, checkpoint_path=paths[writer], **kw)
        assert back.resume() is True
        np.testing.assert_array_equal(np.asarray(back.x), np.asarray(src.x))
        np.testing.assert_array_equal(back.dd_history, src.dd_history)
    # the reference resumes the port's file, the port the reference's;
    # then both take 3 sweeps on the same data
    ref2 = j_stream.DynamicReconstructor(N, 8, checkpoint_path=paths["port"])
    got2 = stream.DynamicReconstructor(N, 8, device="cpu",
                                       checkpoint_path=paths["ref"])
    for rec in (ref2, got2):
        rec.resume()
        rec.add_projections(_arrivals(b, ang, 0, 8))
    assert got2._resid is None
    ref2._ax = None  # the reference's stale carried A x (module docstring)
    for rec in (ref2, got2):
        rec.iterate(3)
    np.testing.assert_allclose(got2.dd_history, ref2.dd_history,
                               rtol=SIRT_RTOL)
    _x_close(got2, ref2)


class _Reveal:
    """list_fn revealing `per_poll` more of the files at each call."""

    def __init__(self, paths, per_poll):
        self.paths, self.per_poll, self.shown = paths, per_poll, 0

    def __call__(self):
        self.shown = min(self.shown + self.per_poll, len(self.paths))
        return self.paths[:self.shown]


@pytest.mark.parametrize("alg", ["sirt", "cs"])
def test_run_matches_reference(gather, tmp_path, alg):
    ang = dose_symmetric(12, 10.0)
    b = _sinogram(2, ang)
    paths = []
    for i, a in enumerate(ang):
        paths.append(str(tmp_path / f"proj_{a:.1f}.npy"))
        np.save(paths[-1], b[:, i, :])
    recs = {}
    for tag, mod, kw in (("ref", j_stream, {}),
                         ("port", stream, {"device": "cpu"})):
        watcher = mod.TiltWatcher(str(tmp_path), preprocess=False,
                                  list_fn=_Reveal(paths, 4))
        rec = mod.DynamicReconstructor(
            N, 12, 4, alg=alg, checkpoint_path=str(tmp_path / f"{tag}.h5"),
            **kw)
        x = rec.run(watcher, iters_per_round=3, expected_angles=12)
        assert tuple(x.shape) == (2, N, N)
        recs[tag] = rec
    ref, got = recs["ref"], recs["port"]
    assert len(got.dd_history) == len(ref.dd_history) == 4
    assert got.angles == ref.angles and len(got.angles) == 12
    rtol = SIRT_RTOL if alg == "sirt" else CS_DD_RTOL
    np.testing.assert_allclose(got.dd_history, ref.dd_history, rtol=rtol)
    if alg == "cs":
        assert got._dpocs > 0
    back = stream.DynamicReconstructor(N, 12, device="cpu",
                                       checkpoint_path=str(tmp_path
                                                           / "port.h5"))
    assert back.resume()
    np.testing.assert_array_equal(back.get_recon(), got.get_recon())
    assert os.path.exists(tmp_path / "ref.h5")


def test_stream_modules_leave_jax_out():
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, tomojax_torch.stream, tomojax_torch.dm, "
            "tomojax_torch.io; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tomojax' not in sys.modules, 'tomojax imported'")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parents[1], check=True,
                   timeout=120)


@pytest.mark.cuda
def test_stream_rounds_match_plain_on_card():
    """The kernels against the plain versions through the reconstructor: masked
    SIRT rounds (dd rtol 1e-5, the volume within 1e-5 max|x|), and every
    CS iteration taken on the card from the plain run's state (x and
    dPOCS: the free-running trajectories amplify last-digit differences),
    dd at rtol 1e-3 and dPOCS at rtol 1e-5; then iterate after iterate_cs
    equals a fresh reconstructor's on the same x, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ang = dose_symmetric(16, 7.5)
    b = _sinogram(4, ang)
    recs = {dev: stream.DynamicReconstructor(N, 16, 8, device=dev)
            for dev in ("cuda", "cpu")}
    for lo, hi in ((0, 5), (5, 16)):
        for rec in recs.values():
            rec.add_projections(_arrivals(b, ang, lo, hi))
            rec.iterate(6)
    np.testing.assert_allclose(recs["cuda"].dd_history,
                               recs["cpu"].dd_history, rtol=SIRT_RTOL)
    x_p = recs["cpu"].get_recon()
    np.testing.assert_allclose(recs["cuda"].get_recon(), x_p,
                               atol=SIRT_RTOL * np.abs(x_p).max())
    card, plain = (stream.DynamicReconstructor(N, 16, 8, alg="cs",
                                               device=dev)
                   for dev in ("cuda", "cpu"))
    for lo, hi in ((0, 5), (5, 16)):
        for rec in (card, plain):
            rec.add_projections(_arrivals(b, ang, lo, hi))
        for _ in range(5):
            card.x, card._dpocs = plain.x, plain._dpocs
            dd_k, dd_p = card.iterate_cs(1), plain.iterate_cs(1)
            np.testing.assert_allclose(dd_k, dd_p, rtol=CS_DD_RTOL)
            np.testing.assert_allclose(card._dpocs, plain._dpocs,
                                       rtol=CS_DPOCS_RTOL)
    fresh = stream.DynamicReconstructor(N, 16, 8, device="cuda")
    fresh.add_projections(list(zip(card.angles, card.projections)))
    fresh.x = card.x.clone()
    assert card.iterate(3) == fresh.iterate(3)
    assert torch.equal(card.x, fresh.x)
