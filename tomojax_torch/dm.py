"""Minimal pure-NumPy Digital Micrograph (.dm3/.dm4) reader and test
writer (a copy of ``tomojax/dm.py``, which cannot be imported here because
importing ``tomojax`` imports JAX).

The reference's acquisition front door reads Gatan DM4 micrographs via
ncempy and pulls the tilt angle from the DM metadata tag
`.ImageList.2.ImageTags.Microscope Info.Stage Position.Stage Alpha`
(its cpu/utils/logger.py:87-93, 177-181). ncempy is not a dependency
here; this module implements the DM container format directly (header +
recursive tag directories), exposing the same flattened-tag naming
convention ncempy uses so the reference's tag path works verbatim.

Format notes (DM3/DM4 are public, widely re-implemented):
  * header: u32 version (3|4), file length (u32 DM3 / u64 DM4),
    u32 byte-order flag (1 = little-endian tag data). All header/struct
    fields are big-endian; tag *data* endianness follows the flag.
  * tag tree: each directory = (sorted u8, closed u8, count), entries =
    (kind u8: 20=subdir, 21=tag, 0=EOF; label u16-len + ascii;
    DM4 adds a u64 total-byte field), tag payload = '%%%%', info array
    (i32 DM3 / i64 DM4), then raw data.
  * info encodings: [simple-type], [18, len] string, [15, 0, nfields,
    (0, type)*] struct, [20, elem..., len] array.

`write_dm4` emits a minimal valid file (thumbnail at ImageList.1 and the
image at ImageList.2, like real Gatan acquisitions) so the streaming
pipeline can be tested without microscope data.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

# DM simple data-type codes -> numpy dtypes (little-endian applied later)
_DTYPES = {
    2: "i2", 3: "i4", 4: "u2", 5: "u4", 6: "f4", 7: "f8",
    8: "u1", 9: "i1", 10: "i1", 11: "i8", 12: "u8",
}
_STAGE_ALPHA_TAG = (
    ".ImageList.2.ImageTags.Microscope Info.Stage Position.Stage Alpha"
)


class _Reader:
    def __init__(self, buf: bytes, version: int, little: bool):
        self.buf = buf
        self.pos = 0
        self.version = version
        self.end = "<" if little else ">"

    def read(self, fmt: str):
        # header/structure fields are always big-endian
        size = struct.calcsize(">" + fmt)
        vals = struct.unpack_from(">" + fmt, self.buf, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def read_len(self):
        """Directory counts / info lengths: u32 in DM3, u64 in DM4."""
        return self.read("I" if self.version == 3 else "Q")

    def raw(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def _simple_size(code: int) -> int:
    return int(_DTYPES[code][1])


def _read_tag_data(r: _Reader, info):
    """Decode one tag payload from its info array."""
    t = info[0]
    if t in _DTYPES:
        return np.frombuffer(
            r.raw(_simple_size(t)), dtype=r.end + _DTYPES[t]
        )[0]
    if t == 18:  # string
        return r.raw(info[1]).decode("latin1")
    if t == 15:  # struct
        nfields = info[2]
        types = [info[4 + 2 * i] for i in range(nfields)]
        return tuple(
            np.frombuffer(
                r.raw(_simple_size(ft)), dtype=r.end + _DTYPES[ft]
            )[0]
            for ft in types
        )
    if t == 20:  # array
        elem = info[1]
        if elem in _DTYPES:
            n = info[2]
            return np.frombuffer(
                r.raw(n * _simple_size(elem)), dtype=r.end + _DTYPES[elem],
                count=n,
            ).copy()
        if elem == 15:  # array of structs (e.g. RGB CLUTs) — skip content
            nfields = info[3]
            types = [info[5 + 2 * i] for i in range(nfields)]
            itemsize = sum(_simple_size(ft) for ft in types)
            n = info[-1]
            r.raw(n * itemsize)
            return None
        if elem == 18:  # array of strings — unsupported, skip by length
            raise ValueError("string arrays unsupported")
    raise ValueError(f"unknown DM tag type {t}")


def _read_dir(r: _Reader, prefix: str, tags: Dict[str, object]):
    r.read("BB")  # sorted, closed
    count = r.read_len()
    unnamed = 0
    for _ in range(count):
        kind = r.read("B")
        if kind == 0:  # EOF marker
            break
        nlabel = r.read("H")
        label = r.raw(nlabel).decode("latin1")
        if r.version == 4:
            r.read("Q")  # total bytes (redundant; we parse the content)
        if not label:
            unnamed += 1
            label = str(unnamed)
        name = f"{prefix}.{label}"
        if kind == 20:
            _read_dir(r, name, tags)
        elif kind == 21:
            assert r.raw(4) == b"%%%%", "corrupt DM tag marker"
            ninfo = r.read_len()
            info = [r.read_len() for _ in range(ninfo)]
            tags[name] = _read_tag_data(r, info)
        else:
            raise ValueError(f"unknown DM entry kind {kind}")


def read_tags(path: str) -> Dict[str, object]:
    """Parse a .dm3/.dm4 file into a flat {'.A.B.C': value} tag dict
    (ncempy `fileDM.allTags` naming: unnamed directory members are
    numbered from 1)."""
    with open(path, "rb") as f:
        buf = f.read()
    version = struct.unpack_from(">I", buf, 0)[0]
    if version not in (3, 4):
        raise ValueError(f"not a DM3/DM4 file (version={version})")
    off = 12 if version == 3 else 16
    little = struct.unpack_from(">I", buf, off - 4)[0] == 1
    r = _Reader(buf, version, little)
    r.pos = off
    tags: Dict[str, object] = {}
    _read_dir(r, "", tags)
    return tags


def read_dm(path: str) -> Dict[str, object]:
    """Read image + tags: returns {'data': 2D float array, 'tags': dict,
    'stage_alpha': angle or None}. Prefers ImageList.2 (the acquisition;
    .1 is the thumbnail in real Gatan files), falls back to .1."""
    tags = read_tags(path)
    data = None
    for idx in ("2", "1"):
        key = f".ImageList.{idx}.ImageData.Data"
        if key in tags:
            dims = []
            d = 1
            while f".ImageList.{idx}.ImageData.Dimensions.{d}" in tags:
                dims.append(
                    int(tags[f".ImageList.{idx}.ImageData.Dimensions.{d}"])
                )
                d += 1
            arr = np.asarray(tags[key])
            # DM stores dimensions fastest-first (width, height, ...)
            data = arr.reshape(tuple(reversed(dims))) if dims else arr
            break
    if data is None:
        raise ValueError(f"no image data found in {path}")
    return {"data": data, "tags": tags, "stage_alpha": stage_alpha(tags)}


def stage_alpha(tags: Dict[str, object]) -> Optional[float]:
    """Tilt angle from the DM stage-position metadata (the reference's
    exact tag, logger.py:177-181), falling back to any tag path ending
    in 'Stage Alpha' (files with no thumbnail index differently)."""
    if _STAGE_ALPHA_TAG in tags:
        return float(tags[_STAGE_ALPHA_TAG])
    for key, val in tags.items():
        if key.endswith(".Stage Alpha"):
            return float(val)
    return None


# --------------------------------------------------------------------------
# Minimal DM4 writer (for tests / simulated acquisitions).
# --------------------------------------------------------------------------


def _w_label(label: str) -> bytes:
    enc = label.encode("latin1")
    return struct.pack(">H", len(enc)) + enc


def _w_tag(label: str, value) -> bytes:
    """Encode one data tag (f8 scalar, string, or numeric array)."""
    if isinstance(value, str):
        enc = value.encode("latin1")
        info = [18, len(enc)]
        payload = enc
    elif isinstance(value, np.ndarray):
        code = {np.dtype(v): k for k, v in (
            (2, "i2"), (3, "i4"), (4, "u2"), (5, "u4"), (6, "f4"),
            (7, "f8"), (11, "i8"), (12, "u8"),
        )}[value.dtype.newbyteorder("=")]
        info = [20, code, value.size]
        payload = value.astype(value.dtype.newbyteorder("<")).tobytes()
    elif isinstance(value, (int, np.integer)):
        info = [5]
        payload = struct.pack("<I", int(value))
    else:
        info = [7]
        payload = struct.pack("<d", float(value))
    body = (
        b"%%%%"
        + struct.pack(">Q", len(info))
        + b"".join(struct.pack(">q", i) for i in info)
        + payload
    )
    return b"\x15" + _w_label(label) + struct.pack(">Q", len(body)) + body


def _w_dir(label: str, entries: bytes, count: int) -> bytes:
    body = b"\x00\x00" + struct.pack(">Q", count) + entries
    return b"\x14" + _w_label(label) + struct.pack(">Q", len(body)) + body


def _w_image(data: np.ndarray, image_tags: Dict[str, float]) -> bytes:
    """One unnamed ImageList member: ImageData(Data+Dimensions)+ImageTags."""
    data = np.ascontiguousarray(data, np.float32)
    dims = b"".join(
        _w_tag("", np.uint32(d)) for d in reversed(data.shape)
    )
    image_data = _w_dir(
        "ImageData",
        _w_tag("Data", data.ravel())
        + _w_dir("Dimensions", dims, data.ndim),
        2,
    )
    # nested tag groups from dotted keys, e.g.
    # "Microscope Info.Stage Position.Stage Alpha"
    def nest(path_parts, value):
        if len(path_parts) == 1:
            return _w_tag(path_parts[0], value)
        return _w_dir(path_parts[0], nest(path_parts[1:], value), 1)

    tag_entries = b"".join(nest(k.split("."), v) for k, v in image_tags.items())
    itags = _w_dir("ImageTags", tag_entries, len(image_tags))
    return _w_dir("", image_data + itags, 2)


def write_dm4(
    path: str,
    data: np.ndarray,
    stage_alpha: Optional[float] = None,
    extra_tags: Optional[Dict[str, float]] = None,
    thumbnail: bool = True,
):
    """Write a minimal valid .dm4: thumbnail at ImageList.1 + the image
    at ImageList.2 (mirroring real Gatan layout so the reference's
    `.ImageList.2...Stage Alpha` tag path resolves)."""
    tags = dict(extra_tags or {})
    if stage_alpha is not None:
        tags["Microscope Info.Stage Position.Stage Alpha"] = float(stage_alpha)
    members = b""
    count = 0
    if thumbnail:
        thumb = np.asarray(data, np.float32)[::4, ::4]
        members += _w_image(thumb, {})
        count += 1
    members += _w_image(np.asarray(data, np.float32), tags)
    count += 1
    root_entries = _w_dir("ImageList", members, count)
    root = b"\x00\x00" + struct.pack(">Q", 1) + root_entries
    header = struct.pack(">IQI", 4, len(root), 1)
    with open(path, "wb") as f:
        f.write(header + root)
