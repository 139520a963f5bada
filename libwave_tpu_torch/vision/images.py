"""Host-side image sequence loading (port of ``libwave_tpu.vision.images``;
wave_vision utils ``readImageSequence``, utils.hpp:139-156).

The reference decodes with PIL's ``convert("L")`` and returns one dense
``(T, H, W)`` uint8 grayscale stack. The port decodes itself, with ``zlib``
and numpy, so it needs no imaging library, and gives the pixels PIL gives:

- PNG of every colour type (grayscale, RGB, palette, grayscale + alpha,
  RGBA) and bit depth, plain or Adam7-interlaced, every scanline filter.
  Colour turns to L as PIL does (ITU-R 601-2 luma in 16-bit fixed point,
  rounded; a palette through its entries' luma, ``tRNS`` ignored); alpha
  is dropped; 1-, 2- and 4-bit gray is scaled to 0-255; 16-bit samples
  keep their high byte, except 16-bit grayscale, which PIL opens as
  ``I;16`` and clips to 255;
- binary PGM and PPM (P5, P6; any maxval, scaled as PIL scales it);
- uncompressed BMP (1-, 4- and 8-bit palette, 24- and 32-bit), bottom-up
  or top-down.

JPEG and TIFF need a codec library, which this package does not depend
on: they raise ``ValueError``, as does any other format, a truncated file
or a bad PNG CRC. Nothing falls back to another decoder. Frames must share one
resolution: a mismatch is an error, not a silent resize.
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
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples


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
    """(..., 3 or 4) uint8 -> (...) uint8 L as PIL's ``convert("L")``:
    (R 19595 + G 38470 + B 7471 + 2^15) >> 16, alpha ignored."""
    rgb = px[..., :3].astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
    return ((luma + 0x8000) >> 16).astype(np.uint8)


# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# allowed bit depths per colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _unpack(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(h, S) unfiltered scanline bytes -> (h, n) samples (uint8, or uint16
    at depth 16; sub-byte samples big-endian within their byte)."""
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16)
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    s = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return s.reshape(rows.shape[0], -1)[:, :n].astype(np.uint8)


def _scanlines(raw: np.ndarray, pos: int, w: int, h: int, spp: int,
               depth: int, path: str):
    """The (h, w * spp) samples of one (sub-)image starting at ``raw[pos]``
    and the position after it."""
    if w == 0 or h == 0:
        return np.zeros((h, w * spp), np.uint8), pos
    stride = (w * spp * depth + 7) // 8
    end = pos + h * (stride + 1)
    if end > raw.size:
        raise ValueError(f"{path}: {raw.size} bytes of image data, too few "
                         f"for the PNG's {w}x{h} (sub-)image at {pos}")
    rows = raw[pos:end].reshape(h, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: scanline filter {int(ftype.max())} "
                         "is not one of PNG's five")
    bpp = max(1, spp * depth // 8)
    return _unpack(_unfilter(rows[:, 1:], ftype, bpp), depth, w * spp), end


def _png_to_l(px: np.ndarray, colour: int, depth: int, palette) -> np.ndarray:
    """(H, W, spp) samples -> (H, W) uint8 as PIL's ``convert("L")`` of the
    mode PIL opens the PNG in."""
    if colour == 3:
        return palette[px[..., 0]]
    if depth == 16:
        if colour == 0:  # PIL's I;16 -> L clips
            return np.minimum(px[..., 0], 255).astype(np.uint8)
        px = (px >> 8).astype(np.uint8)  # RGB;16B, LA;16B, RGBA;16B
    elif depth < 8:  # colour 0: "1", "L;2", "L;4" stretch to 0-255
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if colour in (0, 4):
        return px[..., 0].copy()
    return _to_luma(px)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) uint8 grayscale, as PIL's ``convert("L")``:
    every colour type, bit depth and interlace mode. A file that is not a
    PNG, a bad CRC or a malformed stream raises ``ValueError``."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (signature {data[:8]!r})")
    header, idat, plte, ended = None, [], None, False
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            ended = True
            break
    if header is None or not idat or not ended:
        raise ValueError(f"{path}: PNG without IHDR, IDAT or IEND")
    W, H, depth, colour, compression, filt, interlace = header
    if colour not in _DEPTHS or depth not in _DEPTHS[colour]:
        raise ValueError(f"{path}: colour type {colour} at bit depth {depth} "
                         "is not a valid PNG")
    if compression != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"{path}: unknown PNG compression {compression}, "
                         f"filter method {filt} or interlace {interlace}")
    palette = None
    if colour == 3:
        if plte is None or len(plte) % 3:
            raise ValueError(f"{path}: palette PNG without a valid PLTE")
        # entries past the PLTE are black, as in PIL's palette
        rgb = np.zeros((256, 3), np.uint8)
        n = min(len(plte) // 3, 256)
        rgb[:n] = np.frombuffer(plte, np.uint8)[:3 * n].reshape(n, 3)
        palette = _to_luma(rgb)
    spp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        px, end = _scanlines(raw, 0, W, H, spp, depth, path)
    else:
        px = np.zeros((H, W * spp), np.uint16 if depth == 16 else np.uint8)
        end = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
            w, h = max(w, 0), max(h, 0)
            sub, end = _scanlines(raw, end, w, h, spp, depth, path)
            view = px.reshape(H, W, spp)
            view[y0::dy, x0::dx] = sub.reshape(h, w, spp)
    if end != raw.size:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{end} for {W}x{H}")
    return _png_to_l(px.reshape(H, W, spp), colour, depth, palette)


def _pnm_tokens(data: bytes, path: str):
    """The width, height and maxval of a binary PGM/PPM header and the
    offset of its pixel data."""
    vals, pos = [], 2
    while len(vals) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace()
                                   or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                nl = data.find(b"\n", pos)
                pos = len(data) if nl < 0 else nl
            pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: malformed PGM/PPM header")
        vals.append(int(data[start:pos]))
    if not data[pos:pos + 1].isspace():
        raise ValueError(f"{path}: malformed PGM/PPM header")
    return (*vals, pos + 1)


def decode_pnm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) bytes -> (H, W) uint8 as PIL's
    ``convert("L")``: samples scaled to 0-255 by round(v / maxval * 255)
    (P5 above maxval 255: to 0-65535, then clipped to 255)."""
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM file ({magic!r})")
    W, H, maxval, pos = _pnm_tokens(data, path)
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: PGM/PPM maxval {maxval} outside 1-65535")
    spp = 1 if magic == b"P5" else 3
    wide = maxval > 255
    n = W * H * spp
    if len(data) - pos < n * (2 if wide else 1):
        raise ValueError(f"{path}: truncated PGM/PPM pixel data")
    v = np.frombuffer(data, ">u2" if wide else np.uint8, count=n,
                      offset=pos).reshape(H, W, spp)
    if maxval == 255 or (maxval == 65535 and spp == 1):
        pass  # PIL reads these raw ("L", "RGB", "I;16B")
    else:  # P5 above 255 opens as mode I (0-65535), the rest as L or RGB
        out_max = 65535.0 if spp == 1 and wide else 255.0
        v = np.minimum(out_max, np.round(v / maxval * out_max))
    if spp == 1:
        return np.minimum(v[..., 0], 255).astype(np.uint8)
    return _to_luma(v.astype(np.uint8))


def decode_bmp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Uncompressed BMP bytes (1-, 4- or 8-bit palette, 24- or 32-bit) ->
    (H, W) uint8 as PIL's ``convert("L")``. Compressed (RLE, bitfields) and
    16-bit BMP raise ``ValueError``."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError(f"{path}: not a BMP file ({data[:2]!r})")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:
        W, H, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, colors, pad, top_down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        W, H, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
        (colors,) = struct.unpack_from("<I", data, 46)
        pad, top_down = 4, H < 0
        H = -H if top_down else H
    else:
        raise ValueError(f"{path}: BMP header of {hsize} bytes is not read")
    if compression != 0 or bits not in (1, 4, 8, 24, 32):
        raise ValueError(f"{path}: {bits}-bit BMP with compression "
                         f"{compression} is not read; only uncompressed 1-, "
                         "4-, 8-, 24- and 32-bit")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    stride = ((W * bits + 31) >> 3) & ~3
    if len(data) < offset + stride * H:
        raise ValueError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * H,
                         offset=offset).reshape(H, stride)
    if not top_down:
        rows = rows[::-1]
    if bits >= 24:
        bgr = rows[:, :W * (bits // 8)].reshape(H, W, bits // 8)[..., :3]
        return _to_luma(bgr[..., ::-1])
    start = 14 + hsize
    if len(data) < start + pad * colors or not 0 < colors <= 65536:
        raise ValueError(f"{path}: BMP palette of {colors} entries is "
                         "truncated or invalid")
    entries = np.frombuffer(data, np.uint8, count=pad * colors,
                            offset=start).reshape(colors, pad)
    lut = np.zeros(1 << bits, np.uint8)
    n = min(colors, 1 << bits)
    lut[:n] = _to_luma(entries[:n, 2::-1])
    return lut[_unpack(rows, bits, W)]


def decode_image(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Image bytes -> (H, W) uint8 grayscale by their signature: PNG,
    binary PGM/PPM or uncompressed BMP. JPEG, TIFF and anything else raise
    ``ValueError``."""
    if data[:8] == _PNG_SIGNATURE:
        return decode_png(data, path)
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data, path)
    if data[:2] == b"BM":
        return decode_bmp(data, path)
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: JPEG needs a codec library, which this "
                         "package does not use; convert it to PNG")
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        raise ValueError(f"{path}: TIFF needs a codec library, which this "
                         "package does not use; convert it to PNG")
    raise ValueError(f"{path}: not a PNG, PGM/PPM or BMP file "
                     f"(signature {data[:8]!r})")


def load_image(path: str) -> np.ndarray:
    """Decode one image to (H, W) uint8 grayscale (the detector input
    format; cv::imread(..., IMREAD_GRAYSCALE) equivalent): see
    :func:`decode_image`."""
    with open(path, "rb") as fh:
        return decode_image(fh.read(), path)


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
