"""Image I/O in numpy + zlib: PNG encode/decode and a bilinear resample.

PNG writeback is the util.hpp:8-33 equivalent. The decoder covers what
glTF textures use in practice: 8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, with all five row filters. Other formats inside a
user's .glb (JPEG, palette or 16-bit PNG) go through Pillow when it is
installed; without it, decode_image raises a clear error. Nothing the
procedural scenes or the CLI write needs Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W] or [H, W, C] uint8 (C = 1, 2, 3 or 4) -> PNG bytes. Every
    row uses the Up filter (the first row's prior is zero)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    ctype = {v: k for k, v in _CHANNELS.items()}[c]
    rows = a.reshape(h, w * c)
    prior = np.concatenate([np.zeros((1, w * c), np.uint8), rows[:-1]])
    filt = rows - prior  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), filt], axis=1)
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


class UnsupportedPng(ValueError):
    """A valid PNG outside the formats decode_png handles."""


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters. raw: [H, 1 + W*bpp] uint8.

    Images whose rows use only None, Sub and Up are undone one row at a
    time. Otherwise: pixel (r, x) depends on (r, x-1), (r-1, x) and
    (r-1, x-1) only, so the pixels of one anti-diagonal r + x = k are
    independent, and H+W-1 vectorized steps cover every filter type,
    Average and Paeth included."""
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError("corrupt PNG: unknown row filter")
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int64)
    if ftype.max(initial=0) <= 2:
        out = np.empty((h, w, bpp), np.int64)
        prev = np.zeros((w, bpp), np.int64)
        for r in range(h):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            prev = out[r] = row & 0xFF
        return out.astype(np.uint8)
    # padded reconstruction: row 0 and pixel column 0 are the zero
    # prior / left neighbours of the real pixels
    rec = np.zeros((h + 1, w + 1, bpp), np.int64)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        x = k - r
        a = rec[r + 1, x]          # left
        b = rec[r, x + 1]          # up
        c = rec[r, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8 RGBA (gray replicated, alpha 255
    where the image has none). Raises UnsupportedPng for palette,
    16-bit, sub-byte or interlaced images."""
    if data[:8] != _SIG:
        raise UnsupportedPng("not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(
                ">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"corrupt PNG: bad {kind!r} chunk")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError("corrupt PNG: missing IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise UnsupportedPng(f"PNG with bit depth {depth}, color type "
                             f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("corrupt PNG: wrong IDAT size")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if bpp in (1, 2):
        px = np.concatenate([px[..., :1].repeat(3, axis=-1),
                             px[..., 1:]], axis=-1)
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)],
                            axis=-1)
    return px


def decode_image(raw: bytes) -> np.ndarray:
    """Encoded image bytes -> [H, W, 4] uint8 RGBA: PNG in numpy,
    anything else through Pillow if it is installed."""
    try:
        return decode_png(raw)
    except UnsupportedPng as e:
        why = str(e)
    try:
        import io

        from PIL import Image
    except ImportError:
        raise ValueError(
            f"cannot decode a texture ({why}) without Pillow: textures "
            "other than 8-bit gray/RGB/RGBA PNG need `pip install "
            "pillow`") from None
    with Image.open(io.BytesIO(raw)) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def _bilinear_taps(n_in: int, n_out: int):
    """(first index, weights [n_out, taps]) of an antialiased bilinear
    resample, with the support widened by the scale when shrinking
    (the tent filter of Pillow's Image.resize(..., BILINEAR))."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = fscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    lo = np.maximum((center - support + 0.5).astype(np.int64), 0)
    hi = np.minimum((center + support + 0.5).astype(np.int64), n_in)
    j = np.arange(taps)
    x = lo[:, None] + j[None, :]
    wgt = np.maximum(1.0 - np.abs((x - center[:, None] + 0.5) / fscale),
                     0.0)
    wgt = np.where(x < hi[:, None], wgt, 0.0)
    wgt /= wgt.sum(axis=1, keepdims=True)
    return np.minimum(x, n_in - 1), wgt


def resize_bilinear(img: np.ndarray, height: int, width: int
                    ) -> np.ndarray:
    """[H, W] float32 -> [height, width] float32: horizontal pass, then
    vertical, accumulating in float64 and storing float32 between the
    passes."""
    a = np.asarray(img, np.float32)
    if a.shape[1] != width:
        idx, wgt = _bilinear_taps(a.shape[1], width)
        a = (a[:, idx].astype(np.float64) * wgt).sum(-1).astype(np.float32)
    if a.shape[0] != height:
        idx, wgt = _bilinear_taps(a.shape[0], height)
        a = (a[idx].astype(np.float64) * wgt[:, :, None]).sum(1).astype(
            np.float32)
    return a


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] float32 in [0, 1] (already gamma-encoded, as the
    reference's kernel output is) -> 8-bit RGBA PNG, alpha=255."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    if u8.shape[-1] == 3:
        a = np.full(u8.shape[:2] + (1,), 255, np.uint8)
        u8 = np.concatenate([u8, a], axis=-1)
    with open(path, "wb") as f:
        f.write(encode_png(u8))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())[..., :3].astype(np.float32) / 255.0
