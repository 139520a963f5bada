"""The port's PNG reader and writer (``libwave_tpu_torch.vision.images``)
against the JAX package's PIL-based reader, and against hand-built files.

Tolerance: exact. PNG is lossless, and colour frames turn to L with PIL's
own integer rounding. The port's simulator writes the JAX simulator's
pixels (the file bytes may differ).
"""

import os
import struct
import zlib

import numpy as np
import pytest

from libwave_tpu.datasets.euroc import load_euroc_camera_index
from libwave_tpu.sim import EurocSimParams, generate_euroc_sequence
from libwave_tpu.vision import images as ji
from libwave_tpu_torch.sim import euroc_sim
from libwave_tpu_torch.vision import images as ti

SMALL = dict(nb_landmarks=120, fx=229.0, fy=228.0, cx=188.0, cy=120.0,
             width=376, height_px=240)
CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png(px, colour, filters, depth=8, interlace=0):
    """A PNG of ``px`` (H, W, C) uint8, row y filtered with filters[y]
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), the filters computed
    byte by byte as the PNG specification defines them."""
    H, W, C = px.shape
    raw = px.reshape(H, W * C).astype(np.int64)
    out = bytearray()
    for y in range(H):
        f = int(filters[y])
        out.append(f)
        for i in range(W * C):
            a = int(raw[y, i - C]) if i >= C else 0
            b = int(raw[y - 1, i]) if y > 0 else 0
            c = int(raw[y - 1, i - C]) if y > 0 and i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append((int(raw[y, i]) - pred) % 256)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    head = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace)
    data = zlib.compress(bytes(out))
    # split the data over two IDAT chunks, as encoders may
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
            + chunk(b"IDAT", data[:7]) + chunk(b"IDAT", data[7:])
            + chunk(b"IEND", b""))


def _luma(px):
    """PIL's convert("L") of RGB(A) (libImaging/Convert.c, rgb2l): ITU-R
    601-2 in 16-bit fixed point, rounded: (R 19595 + G 38470 + B 7471 +
    2^15) >> 16."""
    p = px[..., :3].astype(np.int64)
    return ((p[..., 0] * 19595 + p[..., 1] * 38470 + p[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


@pytest.mark.parametrize("colour", [0, 2, 6])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_hand_built_filters_and_colour_types(filt, colour):
    rng = np.random.default_rng(11)
    H, W, C = 13, 17, CHANNELS[colour]
    px = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    px[:4] = px[:1]  # repeated rows and flat runs: small residuals
    px[:, 5:9] = px[:, 5:6]
    filters = (rng.integers(0, 5, H) if filt == "mixed"
               else np.full(H, filt))
    got = ti.decode_png(_png(px, colour, filters))
    want = px[..., 0] if colour == 0 else _luma(px)
    assert got.dtype == np.uint8 and got.shape == (H, W)
    np.testing.assert_array_equal(got, want)


def test_colour_to_luma_rounds_as_pil():
    """Every (R, G) pair at 52 blue levels through PIL's convert("L") and
    through the port's decoder of the same RGB PNG."""
    from PIL import Image

    v = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v, v[::5], indexing="ij"), -1)
    rgb = grid.reshape(256, -1, 3)
    ref = np.asarray(Image.fromarray(rgb, "RGB").convert("L"))
    np.testing.assert_array_equal(ti._to_luma(rgb), ref)
    small = rgb[:16, :40]
    got = ti.decode_png(_png(small, 2, np.arange(16) % 5))
    np.testing.assert_array_equal(got, ref[:16, :40])


@pytest.mark.parametrize("case,match", [
    ("jpeg", "not a PNG"),
    ("bad crc", "CRC"),
])
def test_other_formats_raise_value_error(case, match):
    px = np.zeros((4, 5, 1), np.uint8)
    data = {
        "jpeg": lambda: b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(20),
        "bad crc": lambda: _png(px, 0, np.zeros(4))[:-1] + b"\x00",
    }[case]()
    with pytest.raises(ValueError, match=match):
        ti.decode_png(data)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filtered(rows, bpp, rng):
    """Scanline bytes (h, S) filtered row by row with random filters, the
    filter computed byte by byte as the PNG specification defines it."""
    out = bytearray()
    raw = rows.astype(np.int64)
    for y in range(raw.shape[0]):
        f = int(rng.integers(0, 5))
        out.append(f)
        for i in range(raw.shape[1]):
            a = int(raw[y, i - bpp]) if i >= bpp else 0
            b = int(raw[y - 1, i]) if y > 0 else 0
            c = int(raw[y - 1, i - bpp]) if y > 0 and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append((int(raw[y, i]) - pred) % 256)
    return bytes(out)


def _pack(samples, depth):
    """(h, n) samples -> (h, S) scanline bytes at ``depth`` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    shifts = 8 - depth * (np.arange(per) + 1)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _png_any(samples, colour, depth, interlace=0, plte=None, trns=None,
             seed=0):
    """A PNG of ``samples`` (H, W, spp) at any colour type, bit depth and
    interlace mode, each scanline with a random filter."""
    rng = np.random.default_rng(seed)
    H, W, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filtered(_pack(sub.reshape(sub.shape[0], -1), depth),
                              bpp, rng)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, colour, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


def _pil_l(data):
    from PIL import Image
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"))


SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("case", [
    "interlaced", "16-bit", "palette", "gray+alpha",
    "gray 1-bit", "gray 2-bit", "gray 4-bit", "gray 16-bit tRNS",
    "RGB 16-bit", "RGBA 16-bit", "gray+alpha 16-bit",
    "palette 1-bit", "palette 2-bit", "palette 4-bit tRNS",
    "palette short PLTE", "RGB tRNS",
    "interlaced RGBA", "interlaced palette 4-bit", "interlaced 16-bit RGB",
    "interlaced 1x1", "interlaced 3x2",
])
def test_png_decodes_as_pil_convert_l(case):
    """Every PNG colour type, bit depth and interlace mode against PIL's
    ``convert("L")`` of the same bytes. The first four cases raised before
    the codec read them."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(len(case))
    colour = {"interlaced": 0, "16-bit": 0, "palette": 3, "gray+alpha": 4,
              "RGB": 2, "RGBA": 6, "gray": 0}
    kind = next(k for k in ("interlaced", "gray+alpha", "palette", "RGBA",
                            "RGB", "gray", "16-bit") if case.startswith(k))
    words = case.split()
    c = colour[kind]
    if kind == "interlaced" and len(words) > 1:
        c = {"RGBA": 6, "palette": 3, "16-bit": 2, "1x1": 0, "3x2": 0}[
            words[1]]
    depth = next((int(w.split("-")[0]) for w in words if w.endswith("-bit")),
                 8)
    H, W = {"interlaced 1x1": (1, 1), "interlaced 3x2": (2, 3)}.get(
        case, (11, 19))
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (H, W, SPP[c]))
    if depth == 16:
        samples[0, :4, 0] = (0, 255, 256, 65535)  # around PIL's clip
    plte = trns = None
    if c == 3:
        n = top + 1 if "short" not in case else 5
        plte = rng.integers(0, 256, (n, 3))
        if "tRNS" in case:
            trns = bytes(rng.integers(0, 256, n).astype(np.uint8))
    elif "tRNS" in case:
        trns = struct.pack(">" + "H" * SPP[c], *rng.integers(0, top + 1,
                                                             SPP[c]))
    data = _png_any(samples, c, depth, interlace=int("interlaced" in case),
                    plte=plte, trns=trns, seed=len(case))
    got = ti.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (H, W)
    np.testing.assert_array_equal(got, _pil_l(data))


def _pnm(magic, W, H, maxval, samples, comment=False):
    head = magic + b"\n"
    if comment:
        head += b"# written by hand\n"
    head += b"%d %d\n%d\n" % (W, H, maxval)
    dt = ">u2" if maxval > 255 else np.uint8
    return head + samples.astype(dt).tobytes()


@pytest.mark.parametrize("magic", [b"P5", b"P6"])
@pytest.mark.parametrize("maxval", [255, 100, 1000, 65535])
def test_pgm_ppm_decode_as_pil_convert_l(magic, maxval):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(maxval)
    H, W, spp = 7, 10, 1 if magic == b"P5" else 3
    samples = rng.integers(0, maxval + 1, (H, W, spp))
    data = _pnm(magic, W, H, maxval, samples, comment=maxval == 100)
    got = ti.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (H, W)
    np.testing.assert_array_equal(got, _pil_l(data))


def _bmp(px, bits, palette=None, top_down=False, core=False):
    """An uncompressed BMP: ``px`` (H, W) palette indices or (H, W, 3) RGB,
    rows padded to 4 bytes and stored bottom-up unless ``top_down``."""
    H, W = px.shape[:2]
    stride = ((W * bits + 31) >> 3) & ~3
    if bits >= 24:
        rgb = px[..., ::-1].astype(np.uint8)
        if bits == 32:
            rgb = np.concatenate([rgb, np.full((H, W, 1), 7, np.uint8)], -1)
        rows = rgb.reshape(H, -1)
    else:
        rows = _pack(px, bits)
    body = np.zeros((H, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    if not top_down:
        body = body[::-1]
    pal = b""
    if palette is not None:
        bgr = palette[:, ::-1].astype(np.uint8)
        if not core:
            bgr = np.concatenate([bgr, np.zeros((len(bgr), 1), np.uint8)], 1)
        pal = bgr.tobytes()
    if core:
        dib = struct.pack("<IHHHH", 12, W, H, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1,
                          bits, 0, stride * H, 2835, 2835,
                          0 if palette is None else len(palette), 0)
    offset = 14 + len(dib) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + stride * H, 0, 0, offset)
    return head + dib + pal + body.tobytes()


@pytest.mark.parametrize("case", ["8-bit", "8-bit top-down", "4-bit",
                                  "1-bit", "24-bit", "24-bit top-down",
                                  "32-bit", "8-bit core header"])
def test_bmp_decodes_as_pil_convert_l(case):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(len(case))
    H, W = 9, 13
    bits = int(case.split("-")[0])
    palette = None
    if bits <= 8:
        palette = rng.integers(0, 256, (1 << bits, 3))
        px = rng.integers(0, 1 << bits, (H, W))
    else:
        px = rng.integers(0, 256, (H, W, 3))
    data = _bmp(px, bits, palette, top_down="top-down" in case,
                core="core" in case)
    got = ti.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (H, W)
    np.testing.assert_array_equal(got, _pil_l(data))


@pytest.mark.parametrize("data,match", [
    (b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(20), "JPEG"),
    (b"II*\x00" + bytes(20), "TIFF"),
    (b"MM\x00*" + bytes(20), "TIFF"),
    (b"GIF89a" + bytes(20), "not a PNG, PGM/PPM or BMP"),
    (b"P5\n4 3\n255\n" + bytes(5), "truncated"),
])
def test_jpeg_tiff_and_unknown_raise_value_error(tmp_path, data, match):
    path = tmp_path / "frame.img"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        ti.load_image(str(path))


def test_sequence_of_other_formats_reads_as_pil_reads(tmp_path):
    """A directory of PGM, BMP and palette PNG frames: the same stack from
    both packages' readers."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(5)
    H, W = 6, 8
    (tmp_path / "f1.pgm").write_bytes(
        _pnm(b"P5", W, H, 255, rng.integers(0, 256, (H, W, 1))))
    (tmp_path / "f2.bmp").write_bytes(
        _bmp(rng.integers(0, 256, (H, W, 3)), 24))
    (tmp_path / "f3.png").write_bytes(_png_any(
        rng.integers(0, 16, (H, W, 1)), 3, 4,
        plte=rng.integers(0, 256, (16, 3))))
    ref = ji.read_image_sequence(str(tmp_path))
    got = ti.read_image_sequence(str(tmp_path))
    assert got.shape == (3, H, W)
    np.testing.assert_array_equal(got, ref)


def test_pil_written_sequence_reads_as_pil_reads(tmp_path):
    """The JAX simulator's PNGs (written by PIL, adaptive filters) through
    both readers; the port's simulator writes the same pixels with
    ``save_png``."""
    sim = EurocSimParams(duration=1.2, cam_hz=5.0, render_images=True, **SMALL)
    generate_euroc_sequence(str(tmp_path / "jax"), sim, seed=3)
    _, paths = load_euroc_camera_index(str(tmp_path / "jax"))
    ref = ji.read_image_sequence(paths)
    got = ti.read_image_sequence(paths)
    assert got.shape == ref.shape == (7, 240, 376)
    np.testing.assert_array_equal(got, ref)
    euroc_sim.generate_euroc_sequence(
        str(tmp_path / "port"),
        euroc_sim.EurocSimParams(duration=1.2, cam_hz=5.0,
                                 render_images=True, **SMALL),
        seed=3, device="cpu")
    data = tmp_path / "port" / "mav0" / "cam0" / "data"
    port = ti.read_image_sequence(str(data))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(
        port, euroc_sim.cam0_frames(euroc_sim.EurocSimParams(
            duration=1.2, cam_hz=5.0, **SMALL), seed=3))


def test_save_png_reads_back_in_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    frame = np.random.default_rng(2).integers(0, 256, (31, 45), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    ti.save_png(path, frame)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), frame)
    np.testing.assert_array_equal(ti.load_image(path), frame)
    with pytest.raises(ValueError, match="uint8"):
        ti.save_png(path, frame.astype(np.float32))


def test_natural_order_and_one_resolution(tmp_path):
    for name in ("frame10.png", "frame2.png", "frame1.png", "notes.txt"):
        if name.endswith(".png"):
            ti.save_png(str(tmp_path / name), np.full((3, 4), len(name),
                                                      np.uint8))
        else:
            (tmp_path / name).write_text("x")
    listed = [os.path.basename(p) for p in
              ti.list_image_sequence(str(tmp_path))]
    assert listed == ["frame1.png", "frame2.png", "frame10.png"]
    assert listed == [os.path.basename(p) for p in
                      ji.list_image_sequence(str(tmp_path))]
    assert ti.read_image_sequence(str(tmp_path)).shape == (3, 3, 4)
    ti.save_png(str(tmp_path / "frame11.png"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="one resolution"):
        ti.read_image_sequence(str(tmp_path))
    with pytest.raises(ValueError, match="no images"):
        ti.read_image_sequence([])
    with pytest.raises(FileNotFoundError):
        ti.list_image_sequence(str(tmp_path / "missing"))
