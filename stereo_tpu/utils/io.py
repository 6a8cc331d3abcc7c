"""Image / dataset IO for the bundled Middlebury pairs.

Replaces the reference's imread + download_stereo conventions: images are
loaded as double-valued float arrays in [0, 255] (MATLAB ``double(imread(.))``)
and stereo datasets carry the P-matrix convention of
imrender/ojw/download_stereo.m:116-117 — P of view n shifts x by
-(n-1)/(disparity_factor * im_space) per disparity unit; for the bundled
2-view pairs that is P(1,4,2) = -0.25 (example_global.m:17-18).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

DATA_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "data")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3}  # colour type -> samples per pixel


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter (PNG spec section 9) on uint8 rows."""
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: running sum per byte lane, modulo 256
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return (line.astype(np.int64) + prev).astype(np.uint8)
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {ftype}")
    out = line.astype(np.int64)
    up = prev.astype(np.int64)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            out[i] = (out[i] + (a + b) // 2) & 255
            continue
        c = up[i - bpp] if i >= bpp else 0  # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit greyscale ([H, W]) or RGB ([H, W, 3]) non-interlaced
    PNG to uint8 with numpy and zlib alone."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: bad CRC in {ctype!r} chunk")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); need 8-bit grey or RGB, "
            f"non-interlaced")
    bpp = _PNG_CHANNELS[colour]
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = raw.reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(H, W, bpp) if bpp > 1 else out


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """[H, W, 3] float image with values in [0, 255]."""
    im = read_png(path)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    return im.astype(dtype)


@dataclass
class StereoPair:
    name: str
    images: list  # two [H, W, 3] float arrays, images[0] = reference view
    P: np.ndarray  # [2, 3, 4] camera matrices
    disp_range: tuple  # (min, max) in dataset disparity units
    disparity_factor: int

    @property
    def shape(self):
        return self.images[0].shape[:2]


_PAIRS = {
    # example_global.m:17-20 / example_simultaneous.m:15-18
    "teddy": dict(disp_range=(0, 59), disparity_factor=4, p_shift=-0.25),
    "baby2": dict(disp_range=(0, 85), disparity_factor=3, p_shift=-0.25),
    # synthetic pair with bundled exact GT (tools/make_synth_pair.py) — the
    # bad-pixel metric's end-to-end fixture; Middlebury GT itself is a
    # runtime download in the reference (download_stereo.m) and absent here
    "synth": dict(disp_range=(0, 16), disparity_factor=8, p_shift=-0.125),
}


def load_ground_truth(name: str, root: str | None = None,
                      dtype=np.float32) -> np.ndarray | None:
    """Ground-truth disparity map of the reference view, or None if absent.

    The reference downloads GT at runtime (download_stereo.m) — impossible in
    a zero-egress environment, so GT is optional: place ``disp2.png`` (the
    Middlebury GT image for view 2, values = disparity_factor * disparity,
    0 = unknown) under ``<root>/<name>/`` or point the ``STEREO_TPU_GT_DIR``
    env var at a directory with ``<name>/disp2.png``.  Returns [H, W] float
    disparities in dataset units with NaN at unknown pixels.
    """
    if name not in _PAIRS:
        raise KeyError(f"Unknown bundled pair {name!r}; have {sorted(_PAIRS)}")
    roots = [r for r in (root, os.environ.get("STEREO_TPU_GT_DIR"), DATA_ROOT)
             if r]
    for r in roots:
        path = os.path.join(r, name, "disp2.png")
        if os.path.exists(path):
            raw = read_png(path).astype(dtype)
            if raw.ndim == 3:
                raise ValueError(f"{path}: ground truth must be greyscale")
            gt = raw / _PAIRS[name]["disparity_factor"]
            gt[raw == 0] = np.nan  # Middlebury: 0 marks unknown
            return gt
    return None


def load_pair(name: str, root: str | None = None, dtype=np.float32) -> StereoPair:
    if name not in _PAIRS:
        raise KeyError(f"Unknown bundled pair {name!r}; have {sorted(_PAIRS)}")
    cfg = _PAIRS[name]
    root = root or DATA_ROOT
    im0 = load_image(os.path.join(root, name, "im2.png"), dtype)
    im1 = load_image(os.path.join(root, name, "im6.png"), dtype)
    P = np.zeros((2, 3, 4))
    P[:, :, :3] = np.eye(3)
    P[1, 0, 3] = cfg["p_shift"]
    return StereoPair(
        name=name,
        images=[im0, im1],
        P=P,
        disp_range=cfg["disp_range"],
        disparity_factor=cfg["disparity_factor"],
    )
