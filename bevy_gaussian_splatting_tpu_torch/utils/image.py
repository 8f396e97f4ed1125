"""Image IO: linear RGBA -> 8-bit sRGB PNG, and back.

The counterpart of the JAX package's ``utils/image.py``.  The reference's
shaders write linear premultiplied colour into an Rgba8UnormSrgb target
(src/render/mod.rs:914-982), so scanout applies the sRGB OETF; its headless
example copies that target into a PNG (examples/headless.rs:349-411).

PNG files are written and read with the standard library alone (``zlib``,
``struct``): 8-bit RGBA, not interlaced.  The reader takes every PNG row
filter, so it reads what other encoders write in that format too.  Animated
GIFs (:func:`save_gif`, the JAX package's turntable GIF without PIL) are
GIF89a with one fixed 6x6x6 colour cube and LZW written here.
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


GIF_LEVELS = 6  # levels per channel of the fixed palette (a 6x6x6 cube)
GIF_MAX_ERROR = 255.0 / (GIF_LEVELS - 1) / 2.0  # largest u8 error of a channel


def _lzw(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW (GIF89a, appendix F) of palette indices,
    least significant bit first, with a clear code whenever the table is
    full."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    size = min_code_size + 1

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table: dict = {}
    next_code = end + 1
    emit(clear)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # the decoder adds each entry one code later, so it widens after
            # reading the code that follows entry 2**size
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table.clear()
            next_code = end + 1
            size = min_code_size + 1
        prefix = b
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames, delay_ms: int = 120, loop: int = 0) -> bytes:
    """[H, W, 4] uint8 sRGB frames (the premultiplied colour over black; the
    alpha is dropped) -> the bytes of a looping GIF89a.  Each channel is
    rounded to the nearest of ``GIF_LEVELS`` levels of one global palette,
    so it is within ``GIF_MAX_ERROR`` of the input."""
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    if not frames or any(f.ndim != 3 or f.shape[2] < 3 or f.shape[:2] != frames[0].shape[:2] for f in frames):
        raise ValueError("expected one or more [H, W, 3 or 4] uint8 frames of one size")
    height, width = frames[0].shape[:2]
    step = 255.0 / (GIF_LEVELS - 1)
    levels = np.round(np.arange(GIF_LEVELS) * step).astype(np.uint8)
    cube = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), axis=-1).reshape(-1, 3)
    palette = np.zeros((256, 3), np.uint8)
    palette[: len(cube)] = cube
    out = [b"GIF89a", struct.pack("<HHBBB", width, height, 0xF7, 0, 0), palette.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        q = np.rint(f[..., :3].astype(np.float32) / np.float32(step)).astype(np.int32)
        idx = (q[..., 0] * GIF_LEVELS + q[..., 1]) * GIF_LEVELS + q[..., 2]
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", max(0, round(delay_ms / 10))) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0))
        out.append(b"\x08" + _sub_blocks(_lzw(idx.astype(np.uint8).tobytes())))
    out.append(b"\x3b")
    return b"".join(out)


def save_gif(images, path, delay_ms: int = 120) -> None:
    """Write [H, W, 4] linear RGBA frames (tensors or arrays) as a looping
    animated GIF of their sRGB colour, ``delay_ms`` a frame."""
    with open(path, "wb") as f:
        f.write(encode_gif([to_srgb_u8(img) for img in images], delay_ms))
