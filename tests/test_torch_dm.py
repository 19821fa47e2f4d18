"""tomojax_torch.dm (the numpy DM3/DM4 reader and writer, a copy) and the
acquisition front end of tomojax_torch.stream (DM angles, SFTP mirroring
with a faked client) held against tomojax's.

Every comparison is exact: both packages run the same numpy code on the
same bytes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tomojax import dm as j_dm  # noqa: E402
from tomojax import stream as j_stream  # noqa: E402

from tomojax_torch import dm  # noqa: E402
from tomojax_torch import stream  # noqa: E402


@pytest.fixture
def img():
    rng = np.random.default_rng(3)
    return (rng.random((48, 40)) + 1.0).astype(np.float32)


def _same_tags(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), k
        else:
            assert type(va) is type(vb) and va == vb, k


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("thumbnail", [True, False])
def test_dm4_written_by_one_reads_the_same_in_both(img, tmp_path, writer,
                                                   thumbnail):
    path = str(tmp_path / "t.dm4")
    write = j_dm.write_dm4 if writer == "reference" else dm.write_dm4
    write(path, img, stage_alpha=-42.5, thumbnail=thumbnail,
          extra_tags={"Microscope Info.Voltage": 200000.0})
    got, ref = dm.read_dm(path), j_dm.read_dm(path)
    assert np.array_equal(got["data"], img)
    assert np.array_equal(got["data"], ref["data"])
    assert got["stage_alpha"] == ref["stage_alpha"] == -42.5
    _same_tags(got["tags"], ref["tags"])
    _same_tags(dm.read_tags(path), j_dm.read_tags(path))
    assert dm.stage_alpha(got["tags"]) == j_dm.stage_alpha(ref["tags"])


def test_writers_emit_the_same_bytes(img, tmp_path):
    a, b = str(tmp_path / "a.dm4"), str(tmp_path / "b.dm4")
    j_dm.write_dm4(a, img, stage_alpha=13.25)
    dm.write_dm4(b, img, stage_alpha=13.25)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_dm_angle_and_filename_fallback(img, tmp_path):
    tagged = str(tmp_path / "frame_7.0.dm4")
    plain = str(tmp_path / "tilt_-12.0.dm4")
    dm.write_dm4(tagged, img, stage_alpha=31.5)
    dm.write_dm4(plain, img)
    assert dm.stage_alpha(dm.read_tags(plain)) is None
    for path, want in ((tagged, 31.5), (plain, -12.0)):
        assert stream.dm_angle(path) == j_stream.dm_angle(path) == want


def test_non_dm_file_raises(tmp_path):
    path = str(tmp_path / "x.dm4")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError):
        dm.read_tags(path)


def test_tiltwatcher_dm4_matches_reference(img, tmp_path):
    for i, ang in enumerate((30.0, -30.0, 0.0)):
        dm.write_dm4(str(tmp_path / f"frame_{i:03d}.dm4"), img + i,
                     stage_alpha=ang)
    for preprocess in (False, True):
        got = stream.TiltWatcher(str(tmp_path), extension=".dm4",
                                 preprocess=preprocess).poll()
        ref = j_stream.TiltWatcher(str(tmp_path), extension=".dm4",
                                   preprocess=preprocess).poll()
        assert [a for a, _ in got] == [a for a, _ in ref] == [30.0, -30.0,
                                                              0.0]
        for (_, g), (_, r) in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)


class FakeSftp:
    """Duck-typed paramiko SFTPClient serving files from a dict that the
    test grows, with names in `fail` raising as a half-written file
    does."""

    def __init__(self):
        self.files = {}
        self.fail = set()

    def listdir(self):
        return list(self.files)

    def get(self, name, local):
        if name in self.fail:
            raise OSError("incomplete")
        with open(local, "wb") as f:
            f.write(self.files[name])


def _dm4_bytes(img, ang, tmp_path, name):
    p = str(tmp_path / ("src_" + name))
    dm.write_dm4(p, img, stage_alpha=ang)
    with open(p, "rb") as f:
        return f.read()


def test_sftp_streaming_and_vanished_file_retry(img, tmp_path):
    """A faked remote acquisition: files appear between polls, one fails
    to download once and is fetched at the next poll; the port's watcher
    yields what the reference's yields, poll by poll."""
    remote = FakeSftp()
    watchers = [cls(str(tmp_path / tag), extension=".dm4", preprocess=False,
                    sftp_client=remote)
                for tag, cls in (("port", stream.TiltWatcher),
                                 ("ref", j_stream.TiltWatcher))]

    def poll():
        got, ref = (w.poll() for w in watchers)
        assert [a for a, _ in got] == [a for a, _ in ref]
        for (_, g), (_, r) in zip(got, ref):
            assert np.array_equal(g, r)
        return [a for a, _ in got]

    assert poll() == []
    remote.files["a_000.dm4"] = _dm4_bytes(img, -60.0, tmp_path, "a.dm4")
    remote.files["b_001.dm4"] = _dm4_bytes(img + 1, -57.0, tmp_path, "b.dm4")
    remote.fail.add("b_001.dm4")
    assert poll() == [-60.0]
    assert os.path.exists(tmp_path / "port" / "a_000.dm4")
    assert not os.path.exists(tmp_path / "port" / "b_001.dm4")
    remote.fail.clear()
    remote.files["c_002.dm4"] = _dm4_bytes(img + 2, -54.0, tmp_path, "c.dm4")
    assert poll() == [-57.0, -54.0]
    assert watchers[0].angles == watchers[1].angles == [-60.0, -57.0, -54.0]
    assert poll() == []


@pytest.mark.parametrize("url,remote_dir", [
    ("sftp://user:pw@scope.lab:2222/data/run1", "/data/run1"),
    ("sftp://scope.lab", "."),
])
def test_sftp_url_parsing(tmp_path, url, remote_dir):
    m = stream.SftpMirror.from_url(url, str(tmp_path / "loc"),
                                   client=FakeSftp())
    r = j_stream.SftpMirror.from_url(url, str(tmp_path / "loc"),
                                     client=FakeSftp())
    assert m.remote_dir == r.remote_dir == remote_dir
    assert m.sync(".dm4") == []
    with pytest.raises(ValueError):
        stream.SftpMirror.from_url("http://scope.lab/x", str(tmp_path))


def test_watcher_remote_url_wires_the_mirror(img, tmp_path):
    remote = FakeSftp()
    remote.files["f_1.5.dm4"] = _dm4_bytes(img, 1.5, tmp_path, "f.dm4")
    w = stream.TiltWatcher(str(tmp_path / "m"), extension=".dm4",
                           preprocess=False,
                           remote="sftp://u:p@host:2022/acq",
                           sftp_client=remote)
    assert w.mirror.remote_dir == "/acq"
    assert [a for a, _ in w.poll()] == [1.5]
