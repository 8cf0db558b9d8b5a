"""Image files of the data layer: one place for reading and writing them.

PNG is read and written here with the standard library's ``zlib`` and numpy:
8- and 16-bit grey and RGB, not interlaced, every one of the five row
filters on read (the writer uses filter 0). The KITTI tree's
16-bit depth maps are PNG. JPEG goes through Pillow, imported where it is
used; without Pillow a JPEG raises an ``ImportError`` that names it.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB
_CHANNELS = {0: 1, 2: 3}


def _pillow():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("JPEG images need Pillow (the PIL package), which is not "
                          "installed") from exc
    return Image


def _is_png(path) -> bool:
    return Path(path).suffix.lower() == ".png"


def _png_chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _png_header(head: bytes):
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", head)
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    return h, w, depth, _CHANNELS[ctype]


def _unfilter_sequential(ftype: int, cur: bytearray, prior: bytes, bpp: int):
    """Average (3) and Paeth (4): each byte depends on the one ``bpp``
    before it in the same row."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _read_png(path) -> np.ndarray:
    data = Path(path).read_bytes()
    head, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            head = _png_header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError(f"{path}: no IHDR chunk")
    h, w, depth, channels = head
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, want {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            rec = cur
        elif ftype == 1:  # Sub: a running sum of each byte lane, mod 256
            rec = (np.cumsum(cur.reshape(w, bpp), axis=0, dtype=np.int64) & 0xFF
                   ).astype(np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            rec = cur + prior  # uint8 wraps mod 256
        elif ftype in (3, 4):
            buf = bytearray(cur.tobytes())
            _unfilter_sequential(ftype, buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        out[y] = rec
        prior = out[y]
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write_png(path, img: np.ndarray):
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, channels = img.shape
    ctype = {c: t for t, c in _CHANNELS.items()}.get(channels)
    if ctype is None:
        raise ValueError(f"PNG takes 1 or 3 channels, not {channels}")
    depth = 16 if img.dtype == np.uint16 else 8
    pixels = img.astype(">u2") if depth == 16 else img
    rows = pixels.reshape(h, -1).view(np.uint8)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    Path(path).write_bytes(
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
        + _chunk(b"IEND", b""))


def read_image(path) -> np.ndarray:
    """The pixels of an image file: (H, W) for grey, (H, W, 3) for RGB,
    uint8 or (16-bit PNG) uint16."""
    if _is_png(path):
        return _read_png(path)
    with _pillow().open(str(path)) as im:
        return np.asarray(im)


def write_image(path, img: np.ndarray):
    """Write (H, W) or (H, W, 3) pixels; PNG here, JPEG (Pillow's default
    quality) through Pillow."""
    if _is_png(path):
        _write_png(path, img)
    else:
        _pillow().fromarray(np.asarray(img)).save(str(path))


def image_shape(path) -> np.ndarray:
    """(height, width) of an image file, int32, without decoding its pixels."""
    if _is_png(path):
        with open(path, "rb") as f:
            data = f.read(33)  # signature + the IHDR chunk
        h, w, _, _ = _png_header(next(_png_chunks(data))[1])
        return np.array([h, w], np.int32)
    with _pillow().open(str(path)) as im:
        w, h = im.size
    return np.array([h, w], np.int32)
