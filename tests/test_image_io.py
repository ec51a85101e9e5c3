"""The numpy + zlib image code (utils/image_io.py): PNG round trips,
bit-exact agreement with Pillow in both directions (Pillow is only a
test-time reference here), the Pillow-compatible bilinear resample, and
clear errors."""

import io
import struct
import sys
import zlib

import numpy as np
import pytest

from sycl_ray_tracer_tpu.utils import image_io

Image = pytest.importorskip("PIL.Image")

SHAPES = [(37, 53, 4), (20, 31, 3), (16, 9), (5, 7, 2)]


def _img(rs, shape):
    return rs.randint(0, 256, shape).astype(np.uint8)


def _rgba(a):
    """What decode_png returns for a: RGBA, gray replicated."""
    a = a[..., None] if a.ndim == 2 else a
    c = a.shape[-1]
    rgb = a[..., :3] if c >= 3 else np.repeat(a[..., :1], 3, axis=-1)
    alpha = a[..., -1:] if c in (2, 4) else np.full(a.shape[:2] + (1,),
                                                     255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


@pytest.mark.parametrize("shape", SHAPES)
def test_round_trip(rs, shape):
    a = _img(rs, shape)
    assert np.array_equal(image_io.decode_png(image_io.encode_png(a)),
                          _rgba(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_pillow_reads_our_png(rs, shape):
    a = _img(rs, shape)
    with Image.open(io.BytesIO(image_io.encode_png(a))) as im:
        assert np.array_equal(np.asarray(im), a)


@pytest.mark.parametrize("shape", SHAPES)
def test_we_read_pillows_png(rs, shape):
    """Pillow's optimizing encoder picks adaptive per-row filters, so
    Sub, Up, Average and Paeth rows all occur."""
    a = _img(rs, shape)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG", optimize=True)
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        ref = np.asarray(im.convert("RGBA"))
    assert np.array_equal(image_io.decode_png(buf.getvalue()), ref)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_each_row_filter(rs, filt):
    """A PNG whose rows all use one filter type, built by hand."""
    a = rs.randint(0, 256, (6, 5, 3)).astype(np.int64)
    h, w, c = a.shape
    rows = []
    prev = np.zeros((w, c), np.int64)
    for r in range(h):
        left = np.concatenate([np.zeros((1, c), np.int64), a[r, :-1]])
        upleft = np.concatenate([np.zeros((1, c), np.int64), prev[:-1]])
        p = left + prev - upleft
        pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                      np.abs(p - upleft))
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][filt]
        rows.append(bytes([filt]) + ((a[r] - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = a[r]

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d)))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"".join(rows)))
           + chunk(b"IEND", b""))
    assert np.array_equal(image_io.decode_png(png)[..., :3], a)


@pytest.mark.parametrize("src,dst", [((1024, 1024), (512, 512)),
                                     ((64, 64), (512, 512)),
                                     ((300, 700), (512, 512))])
def test_resize_matches_pillow(rs, src, dst):
    a = rs.rand(*src).astype(np.float32)
    ours = image_io.resize_bilinear(a, *dst)
    ref = np.asarray(Image.fromarray(a, mode="F").resize(
        dst[::-1], Image.BILINEAR), np.float32)
    assert ours.shape == dst
    assert np.abs(ours - ref).max() <= 1e-6


def test_corrupt_chunk_is_rejected(rs):
    png = bytearray(image_io.encode_png(_img(rs, (4, 4, 3))))
    png[-20] ^= 0xFF  # inside the IDAT payload
    with pytest.raises(ValueError, match="corrupt PNG"):
        image_io.decode_png(bytes(png))


def test_non_png_without_pillow_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="without Pillow"):
        image_io.decode_image(b"\xff\xd8\xff\xe0 a jpeg")


def test_write_and_read_png(tmp_path, rs):
    img = rs.rand(12, 10, 3).astype(np.float32)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, img)
    back = image_io.read_png(path)
    assert back.shape == img.shape
    assert np.abs(back - img).max() <= 1.0 / 255.0
