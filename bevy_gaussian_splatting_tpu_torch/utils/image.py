"""Image IO: linear RGBA -> 8-bit sRGB PNG, and back.

The counterpart of the JAX package's ``utils/image.py``.  The reference's
shaders write linear premultiplied colour into an Rgba8UnormSrgb target
(src/render/mod.rs:914-982), so scanout applies the sRGB OETF; its headless
example copies that target into a PNG (examples/headless.rs:349-411).

PNG files are written and read with the standard library alone (``zlib``,
``struct``): 8-bit RGBA, not interlaced.  The reader takes every PNG row
filter, so it reads what other encoders write in that format too.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_RGBA = 6  # PNG colour type of 8-bit RGBA


def _host(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    return np.asarray(image, dtype=np.float32)


def to_srgb_u8(image, premultiplied: bool = True) -> np.ndarray:
    """[H, W, 4] linear (premultiplied) RGBA float, a tensor on any device
    or an array -> [H, W, 4] uint8 sRGB."""
    img = _host(image)
    rgb = img[..., :3]
    a = img[..., 3:4]
    rgb = np.clip(rgb, 0.0, 1.0)
    # sRGB OETF
    srgb = np.where(
        rgb <= 0.0031308, rgb * 12.92, 1.055 * np.power(np.maximum(rgb, 1e-12), 1 / 2.4) - 0.055
    )
    out = np.concatenate([srgb, np.clip(a, 0.0, 1.0)], axis=-1)
    return (out * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(rgba: np.ndarray) -> bytes:
    """[H, W, 4] uint8 -> the bytes of an 8-bit RGBA PNG (filter 0 on every
    row)."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected [H, W, 4] uint8, got {rgba.shape}")
    height, width = rgba.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), rgba.reshape(height, width * 4)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, _RGBA, 0, 0, 0)
    return (
        _SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _unfilter(raw: bytes, width: int, height: int) -> np.ndarray:
    """Undo the per-row filters (PNG 1.2, section 6) -> [H, W * 4] uint8."""
    bpp = 4
    stride = width * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind, line = int(data[y, 0]), data[y, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 2:  # up
            row = (line + prev) & 0xFF
        elif kind in (1, 3, 4):  # sub, average, Paeth: depend on the pixel to the left
            row = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                left = row[x - bpp:x] if x else np.zeros(bpp, np.int32)
                up = prev[x:x + bpp]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) >> 1
                else:
                    up_left = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
                row[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {kind}")
        out[y] = row
        prev = row
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """The bytes of an 8-bit RGBA PNG, not interlaced -> [H, W, 4] uint8."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color != _RGBA or interlace:
        raise ValueError(
            f"only 8-bit RGBA PNGs without interlacing are read (bit depth {depth}, colour type {color}, "
            f"interlace {interlace})"
        )
    return _unfilter(zlib.decompress(b"".join(idat)), width, height).reshape(height, width, 4)


def save_png(image, path, premultiplied: bool = True) -> None:
    """Write [H, W, 4] linear RGBA (a tensor or an array) as an sRGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_srgb_u8(image, premultiplied)))


def load_png(path) -> np.ndarray:
    """An 8-bit RGBA PNG -> [H, W, 4] float32 linear RGBA (sRGB decoded)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read()).astype(np.float32) / 255.0
    rgb = arr[..., :3]
    lin = np.where(rgb <= 0.04045, rgb / 12.92, np.power((rgb + 0.055) / 1.055, 2.4))
    return np.concatenate([lin, arr[..., 3:4]], axis=-1)


def non_black_pixel_count(image, threshold: float = 1.0 / 255.0) -> int:
    """The reference's coarse render check (tests/visibility_render.rs:36-37):
    pixels whose largest colour channel exceeds ``threshold``."""
    img = _host(image)
    return int((img[..., :3].max(axis=-1) > threshold).sum())
