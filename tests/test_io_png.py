"""The numpy + zlib PNG decoder (utils/io.read_png) that loads the bundled
pairs: every file under data/ decodes to a pinned shape and checksum, and
each of the five scanline filter types round-trips."""

import hashlib
import os
import struct
import zlib

import numpy as np
import pytest

from stereo_tpu.utils import io

# sha256 prefixes of the decoded bytes, pinned against an independent decoder
BUNDLED = [
    ("baby2/im2.png", (370, 413, 3), "7d5ec818fea77d7b"),
    ("baby2/im6.png", (370, 413, 3), "e8d1cd2d44086c45"),
    ("synth/disp2.png", (160, 224), "b8795fe5678a4551"),
    ("synth/im2.png", (160, 224, 3), "f1ee34ef923a69c0"),
    ("synth/im6.png", (160, 224, 3), "ea3302333b2d5edf"),
    ("teddy/im2.png", (375, 450, 3), "d3ba4607bd48b55d"),
    ("teddy/im6.png", (375, 450, 3), "466cc670b2d7bcd7"),
]


@pytest.mark.parametrize("name,shape,digest", BUNDLED,
                         ids=[b[0] for b in BUNDLED])
def test_bundled_png_decodes(name, shape, digest):
    a = io.read_png(os.path.join(io.DATA_ROOT, name))
    assert a.shape == shape and a.dtype == np.uint8
    assert hashlib.sha256(a.tobytes()).hexdigest()[:16] == digest


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img, ftype):
    """Reference encoder: every scanline filtered with ``ftype``."""
    H, W = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(H, -1).astype(np.int64)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(H):
        line = rows[y]
        f = np.empty_like(line)
        for i in range(len(line)):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            f[i] = (line[i] - pred) % 256
        out += bytes([ftype]) + f.astype(np.uint8).tobytes()
        prev = line

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    hdr = struct.pack(">IIBBBBB", W, H, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_filter_roundtrip(ftype, tmp_path):
    rng = np.random.default_rng(ftype)
    for img in (rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
                rng.integers(0, 256, (4, 9), dtype=np.uint8)):
        path = tmp_path / "x.png"
        path.write_bytes(_encode(img, ftype))
        np.testing.assert_array_equal(io.read_png(str(path)), img)
