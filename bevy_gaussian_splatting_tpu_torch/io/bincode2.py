"""bincode2 + gzip ``.gcloud`` / ``.gc4d`` codec, the reference's alternate
cloud codec (src/io/gcloud/bincode2.rs:11-66: gzip(bincode(PlanarCloud)),
read back raw when the gzip layer fails), as the JAX package's
``io/bincode2.py`` writes it.

bincode 2 "standard" configuration for the serde data model: struct fields
in declaration order without tags; ``Vec<T>`` as a varint length then the
elements; ``[T; N]`` as N elements; f32 as 4 little-endian bytes; varint
< 251 in one byte, 251 / 252 / 253 then a u16 / u32 / u64.  Field order is
the reference's (src/gaussian/f32.rs): PlanarGaussian3d {position_visibility,
spherical_harmonic, rotation, scale_opacity}, PlanarGaussian4d
{position_visibility, spherindrical_harmonic, isotropic_rotations,
scale_opacity, timestamp_timescale}.  Every row is a fixed-width f32 run, so
both directions are numpy slices.

The gzip layer is one gzip member whose deflate stream is compressed in
16 MiB chunks on threads, each chunk but the last ended by a sync flush (the
layout pigz writes), so any gzip reader reads it: ``gzip.compress`` on one
thread took 12.4 s for a 1M-gaussian cloud, the chunks on 8 threads 2.9 s
(the 8-core host of an H100 machine, ``chip_smoke.py``'s io phase).  The
header holds the time, so compressed bytes differ from run to run (and
from the JAX package's); the raw payload (``compress=False``) does not.
"""

from __future__ import annotations

import gzip as _gzip
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    Gaussian4dCloud,
    cloud_from_numpy,
    cloud_to_numpy,
)

# spherical_harmonic width None: the degree axis (sh0..sh4).  The encoder
# writes the array's width; the decoder infers it from the bytes left, since
# every other field is fixed-width with the same row count.
_FIELDS_3D = [("position_visibility", 4), ("spherical_harmonic", None),
              ("rotation", 4), ("scale_opacity", 4)]
_FIELDS_4D = [("position_visibility", 4), ("spherindrical_harmonic", 144),
              ("isotropic_rotations", 8), ("scale_opacity", 4),
              ("timestamp_timescale", 2)]


def _write_varint(out: bytearray, v: int) -> None:
    if v < 251:
        out.append(v)
    elif v < (1 << 16):
        out.append(251)
        out += struct.pack("<H", v)
    elif v < (1 << 32):
        out.append(252)
        out += struct.pack("<I", v)
    else:
        out.append(253)
        out += struct.pack("<Q", v)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    b = data[pos]
    if b < 251:
        return b, pos + 1
    if b == 251:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if b == 252:
        return struct.unpack_from("<I", data, pos + 1)[0], pos + 5
    if b == 253:
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9
    raise ValueError("unsupported varint discriminant")


GZIP_LEVEL = 4  # the JAX package's compresslevel
GZIP_CHUNK = 16 << 20


def _gzip_compress(raw: bytes) -> bytes:
    """gzip at ``GZIP_LEVEL``, the deflate chunks made in parallel (zlib
    releases the interpreter lock)."""
    view = memoryview(raw)
    starts = range(0, max(len(raw), 1), GZIP_CHUNK)

    def deflate(start: int) -> bytes:
        c = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
        last = start + GZIP_CHUNK >= len(raw)
        return c.compress(view[start:start + GZIP_CHUNK]) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    with ThreadPoolExecutor(max_workers=min(len(starts), os.cpu_count() or 1)) as pool:
        body = b"".join(pool.map(deflate, starts))
    header = b"\x1f\x8b\x08\x00" + struct.pack("<I", int(time.time())) + b"\x00\xff"  # as gzip.compress
    return header + body + struct.pack("<II", zlib.crc32(raw), len(raw) & 0xFFFFFFFF)


def _varint_size(v: int) -> int:
    return 1 if v < 251 else 3 if v < (1 << 16) else 5 if v < (1 << 32) else 9


def _encode(cloud, fields) -> bytes:
    arrays = cloud_to_numpy(cloud)
    out = bytearray()
    for name, width in fields:
        arr = np.ascontiguousarray(arrays[name], np.float32)
        if width is not None and arr.shape[1] != width:
            raise ValueError(f"{name}: expected {width} columns, got {arr.shape}")
        _write_varint(out, arr.shape[0])
        out += arr.tobytes()
    return bytes(out)


def _decode(data: bytes, fields) -> dict:
    pos = 0
    arrays = {}
    for i, (name, width) in enumerate(fields):
        n, pos = _read_varint(data, pos)
        if width is None:
            # every later field is fixed-width, with the same row count and
            # its own varint
            rest = sum(w for _, w in fields[i + 1:])
            tail = _varint_size(n) * (len(fields) - 1 - i) + n * rest * 4
            floats = len(data) - pos - tail
            if n == 0:
                width = 48  # an empty cloud: the default degree-3 layout
            elif floats < 0 or floats % (4 * n):
                raise ValueError("cannot infer variable field width")
            else:
                width = floats // (4 * n)
        if pos + n * width * 4 > len(data):
            raise ValueError(f"{name}: {n} rows of {width} floats run past the end of the data")
        arrays[name] = np.frombuffer(data, np.float32, count=n * width, offset=pos).reshape(n, width)
        pos += n * width * 4
    if pos != len(data):
        raise ValueError(f"trailing bytes: {len(data) - pos}")
    return arrays


def encode_bincode_3d(cloud: Gaussian3dCloud, compress: bool = True) -> bytes:
    raw = _encode(cloud, _FIELDS_3D)
    return _gzip_compress(raw) if compress else raw


def encode_bincode_4d(cloud: Gaussian4dCloud, compress: bool = True) -> bytes:
    raw = _encode(cloud, _FIELDS_4D)
    return _gzip_compress(raw) if compress else raw


def _maybe_gunzip(data: bytes) -> bytes:
    # gzip first, raw bincode when that fails (bincode2.rs:40-57)
    if data[:2] == b"\x1f\x8b":
        try:
            return _gzip.decompress(data)
        except OSError:
            pass
    return data


def decode_bincode_3d(data: bytes, device: DeviceLike = None) -> Gaussian3dCloud:
    return cloud_from_numpy(_decode(_maybe_gunzip(data), _FIELDS_3D), device)


def decode_bincode_4d(data: bytes, device: DeviceLike = None) -> Gaussian4dCloud:
    return cloud_from_numpy(_decode(_maybe_gunzip(data), _FIELDS_4D), device)
