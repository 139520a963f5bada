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
    ("interlaced", "interlaced"),
    ("16-bit", "16-bit"),
    ("palette", "palette"),
    ("gray+alpha", "grayscale \\+ alpha"),
    ("jpeg", "not a PNG"),
    ("bad crc", "CRC"),
])
def test_other_formats_raise_value_error(case, match):
    px = np.zeros((4, 5, 1), np.uint8)
    data = {
        "interlaced": lambda: _png(px, 0, np.zeros(4), interlace=1),
        "16-bit": lambda: _png(px, 0, np.zeros(4), depth=16),
        "palette": lambda: _png(px, 3, np.zeros(4)),
        "gray+alpha": lambda: _png(px, 4, np.zeros(4)),
        "jpeg": lambda: b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(20),
        "bad crc": lambda: _png(px, 0, np.zeros(4))[:-1] + b"\x00",
    }[case]()
    with pytest.raises(ValueError, match=match):
        ti.decode_png(data)


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
