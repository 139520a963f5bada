"""Host-side image sequence loading (port of ``libwave_tpu.vision.images``;
wave_vision utils ``readImageSequence``, utils.hpp:139-156).

The reference decodes with PIL and returns one dense ``(T, H, W)`` uint8
grayscale stack. The port reads and writes PNG itself, with ``zlib`` and
numpy, so it needs no imaging library: 8-bit grayscale, RGB and RGBA, not
interlaced, every scanline filter. Colour is turned to L as PIL's
``convert("L")`` does (ITU-R 601-2 luma in 16-bit fixed point, rounded).
Any other format raises a ``ValueError`` naming what it got; nothing falls
back to another decoder. Frames must share one resolution: a mismatch is an
error, not a silent resize.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Sequence

import numpy as np

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".ppm", ".tif",
               ".tiff")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOUR_NAMES = {0: "grayscale", 2: "RGB", 3: "palette",
                 4: "grayscale + alpha", 6: "RGBA"}


def _natural_key(name: str):
    """Sort 'frame2' before 'frame10'."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def list_image_sequence(directory: str) -> List[str]:
    """Sorted absolute paths of all image files directly under
    ``directory``."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"not a directory: {directory}")
    names = [
        n for n in os.listdir(directory)
        if n.lower().endswith(_IMAGE_EXTS)
    ]
    names.sort(key=_natural_key)
    return [os.path.abspath(os.path.join(directory, n)) for n in names]


def _chunks(data: bytes, path: str):
    """(type, body) of every chunk after the signature, CRCs checked."""
    pos = len(_PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, body
        pos = end + 4


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters: ``raw`` (H, S) filtered bytes, ``ftype``
    (H,) filter per row (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), ``bpp``
    bytes per pixel. Byte (y, x) depends on its left, upper and upper-left
    neighbours only, so the pixels of one anti-diagonal decode together."""
    H, S = raw.shape
    if not ftype.any():
        return raw
    W = S // bpp
    # one zero row above and one zero pixel to the left
    out = np.zeros((H + 1, S + bpp), np.int32)
    r = raw.astype(np.int32)
    ch = np.arange(bpp)
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H, d + 1))
        cols = ((d - ys) * bpp)[:, None] + ch[None, :]  # (n, bpp) byte cols
        rows = ys[:, None]
        a = out[rows + 1, cols]  # left (padded column index = cols)
        b = out[rows, cols + bpp]  # up
        c = out[rows, cols]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [ftype[rows] == 1, ftype[rows] == 2, ftype[rows] == 3,
             ftype[rows] == 4],
            [a, b, (a + b) >> 1, paeth], 0,
        )
        out[rows + 1, cols + bpp] = (r[rows, cols] + pred) & 0xFF
    return out[1:, bpp:].astype(np.uint8)


def _to_luma(px: np.ndarray) -> np.ndarray:
    """(H, W, 3 or 4) uint8 -> (H, W) uint8 L as PIL's ``convert("L")``:
    (R 19595 + G 38470 + B 7471 + 2^15) >> 16, alpha ignored."""
    rgb = px[..., :3].astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
    return ((luma + 0x8000) >> 16).astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) uint8 grayscale. 8-bit grayscale, RGB and RGBA,
    not interlaced; anything else raises ``ValueError``."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (signature {data[:8]!r}); "
                         "only 8-bit grayscale, RGB and RGBA PNG is read")
    header, idat, ended = None, [], False
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            ended = True
            break
    if header is None or not idat or not ended:
        raise ValueError(f"{path}: PNG without IHDR, IDAT or IEND")
    W, H, depth, colour, compression, filt, interlace = header
    if colour not in _CHANNELS:
        name = _COLOUR_NAMES.get(colour, f"colour type {colour}")
        raise ValueError(f"{path}: {name} PNG (colour type {colour}) is not "
                         "read; only grayscale, RGB and RGBA")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not read; only 8-bit")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not read")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression {compression} or "
                         f"filter method {filt}")
    bpp = _CHANNELS[colour]
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{H * (stride + 1)} for {W}x{H}")
    rows = raw.reshape(H, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: scanline filter {int(ftype.max())} "
                         "is not one of PNG's five")
    px = _unfilter(rows[:, 1:], ftype, bpp).reshape(H, W, bpp)
    return px[..., 0].copy() if bpp == 1 else _to_luma(px)


def load_image(path: str) -> np.ndarray:
    """Decode one PNG image to (H, W) uint8 grayscale (the detector input
    format; cv::imread(..., IMREAD_GRAYSCALE) equivalent)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


def save_png(path: str, frame: np.ndarray) -> None:
    """Write an (H, W) uint8 frame as an 8-bit grayscale PNG, filter 0 on
    every row."""
    frame = np.asarray(frame)
    if frame.ndim != 2 or frame.dtype != np.uint8:
        raise ValueError(f"save_png takes an (H, W) uint8 frame, got "
                         f"{frame.dtype} of shape {frame.shape}")
    H, W = frame.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), frame], axis=1)

    def chunk(ctype, body):
        crc = zlib.crc32(ctype + body)
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(
            ">I", crc)

    header = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    data = (_PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)


def read_image_sequence(source) -> np.ndarray:
    """Load a directory or an explicit list of paths into a (T, H, W) uint8
    stack (readImageSequence parity, utils.hpp:139-156)."""
    paths: Sequence[str]
    if isinstance(source, (str, os.PathLike)):
        paths = list_image_sequence(os.fspath(source))
    else:
        paths = list(source)
    if not paths:
        raise ValueError("no images found")
    frames = [load_image(p) for p in paths]
    shape = frames[0].shape
    for p, f in zip(paths, frames):
        if f.shape != shape:
            raise ValueError(
                f"frame {p} has shape {f.shape}, expected {shape}: "
                "sequences must share one resolution"
            )
    return np.stack(frames)
