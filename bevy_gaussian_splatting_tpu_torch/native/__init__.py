"""The native host runtime: ``gsplat_native.cpp`` (beside this file), built
with ``g++`` at first use and bound with ctypes.

    g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread \\
        gsplat_native.cpp -o _build/libgsplat_native-<hash>.so

The command line is the JAX package's, flag for flag: under
``-march=native`` GCC contracts ``a*b+c`` into fused multiply-adds, so
another flag set could round the quaternion norm or the scale mean apart,
and the two packages would decode a PLY to different bits.  The library
lands in ``bevy_gaussian_splatting_tpu_torch/_build/`` (ignored by git),
named by a hash of the source, the compiler, the flags and the compiler's
reading of ``-march=native`` on this host, so a checkout copied to another
machine builds its own.  Builds that run at once, in threads or in
processes, each compile to a name of their own and ``os.replace`` it into
place.  A missing compiler, a failed build or a failed load raises
:class:`NativeBuildError`: nothing falls back to numpy on its own.

The functions take and give numpy arrays.  ctypes releases the GIL for
each call, so a loader thread decodes while the interpreter runs on; the
build lock covers the first call from any thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np

Bytes = Union[bytes, bytearray]
SOURCE = Path(__file__).resolve().with_name("gsplat_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LOCK = threading.RLock()
_LIB: Optional[ctypes.CDLL] = None
_TARGETS: dict = {}  # compiler -> its reading of -march=native

_F32 = ctypes.POINTER(ctypes.c_float)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_BUF = ctypes.c_void_p  # a file's bytes, passed without a copy
_I64, _C32 = ctypes.c_int64, ctypes.c_int32

# name -> (restype, argtypes), the C ABI of gsplat_native.cpp
_SIGNATURES = {
    "ply3d_parse": (_I64, [_BUF, _I64, _F32, _F32, _F32, _F32, _C32, _C32, _C32, _C32]),
    "ply3d_count": (_I64, [_BUF, _I64]),
    "gcloud3d_size": (_I64, [_I64, _C32]),
    "gcloud4d_size": (_I64, [_I64]),
    "gcloud3d_encode": (_I64, [_F32, _F32, _F32, _F32, _I64, _U8, _C32]),
    "gcloud4d_encode": (_I64, [_F32, _F32, _F32, _F32, _F32, _I64, _U8]),
    "gcloud_probe": (_I64, [_BUF, _I64, _I32, _I32]),
    "gcloud3d_decode": (_I64, [_BUF, _I64, _F32, _F32, _F32, _F32, _I64, _C32]),
    "gcloud4d_decode": (_I64, [_BUF, _I64, _F32, _F32, _F32, _F32, _F32, _I64]),
    "radix_sort_pairs_u32": (None, [_U32, _U32, _I64]),
}

SH_4D_WIDTH = 144  # the only spherindrical width the 4D decoder reads


class NativeBuildError(RuntimeError):
    """The compiler is missing, the build failed or the library did not load."""


def _target(cxx: str) -> str:
    """What ``-march=native`` means to ``cxx`` on this host."""
    if cxx not in _TARGETS:
        try:
            out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True, check=True)
        except (OSError, subprocess.CalledProcessError) as exc:
            raise NativeBuildError(f"cannot run the C++ compiler {cxx!r}: {exc}") from exc
        _TARGETS[cxx] = out.stdout.decode(errors="replace")
    return _TARGETS[cxx]


def library_path() -> Path:
    """The library of the source as this host's compiler builds it."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update("\0".join([CXX, *FLAGS, _target(CXX)]).encode())
    return BUILD_DIR / f"libgsplat_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists -> the library's path."""
    with _LOCK:
        final = library_path()
        if final.exists():
            return final
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")  # the lock serialises this process's threads
        try:
            proc = subprocess.run([CXX, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True)
        except OSError as exc:
            raise NativeBuildError(f"cannot run the C++ compiler {CXX!r}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{CXX} failed for {SOURCE.name} (exit {proc.returncode}):\n" + proc.stderr.decode(errors="replace")
            )
        os.replace(tmp, final)
        return final


def load() -> ctypes.CDLL:
    """The loaded library, built first where needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise NativeBuildError(f"cannot load {path}: {exc}") from exc
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
        return _LIB


def _buffer(data: Bytes):
    """``data`` as a ctypes argument that points at its bytes, without a copy
    (a bytearray through ``from_buffer``)."""
    return data if isinstance(data, bytes) else (ctypes.c_char * len(data)).from_buffer(data)


def _ptr(a: np.ndarray, kind=_F32):
    return a.ctypes.data_as(kind)


def _columns(arrays, widths) -> list:
    """The cloud's fields as contiguous float32 ``[n, width]`` arrays, one
    ``n`` for all (the encoders read ``n`` rows of each) -> ValueError
    otherwise; a width of None is the data's own (at least 1)."""
    out = [np.ascontiguousarray(a, np.float32) for a in arrays]
    n = len(out[0])
    for a, width in zip(out, widths):
        if a.ndim != 2 or len(a) != n or a.shape[1] != (width or max(a.shape[1], 1)):
            raise ValueError(f"expected {len(widths)} arrays of [{n}, C] with C {widths}, got "
                             f"{[x.shape for x in out]}")
    return out


def parse_ply_3d_native(
    data: Bytes,
    strict_reference: bool = True,
    n_threads: int = 0,
    sh_width: int = 48,
    sh_per_channel: int = 16,
):
    """Binary little-endian PLY -> ``(pv, sh, rot, so)`` float32 arrays with
    the reference's activations and 1..32 padding rows, decoded on
    ``n_threads`` threads (0: one per core) -> None where the native reader
    refuses the file by its status: -1 for a layout its header parser does
    not take (ASCII, big-endian, a list property, zero rows), -2 for a
    missing required property, -3 for a truncated body.

    ``sh_width`` / ``sh_per_channel`` select the SH degree's layout: the
    padded storage width (4/12/28/48/76) and the coefficients per channel,
    (d+1)^2, that drive the reference's f_rest remap quirk."""
    if sh_width < 3:  # the decoder always writes the three f_dc values
        raise ValueError(f"sh_width {sh_width} holds no degree-0 coefficients")
    lib = load()
    buf, size = _buffer(data), len(data)
    padded = lib.ply3d_count(buf, size)
    if padded <= 0:
        return None
    pv = np.zeros((padded, 4), np.float32)
    sh = np.zeros((padded, sh_width), np.float32)
    rot = np.zeros((padded, 4), np.float32)
    so = np.zeros((padded, 4), np.float32)
    got = lib.ply3d_parse(
        buf, size, _ptr(pv), _ptr(sh), _ptr(rot), _ptr(so), 1 if strict_reference else 0,
        int(n_threads or os.cpu_count() or 1), int(sh_width), int(sh_per_channel),
    )
    return None if got < 0 else (pv, sh, rot, so)


def encode_gcloud_3d_native(pv, sh, rot, so) -> bytes:
    """A planar 3D cloud -> its ``.gcloud`` FlexBuffer."""
    lib = load()
    pv, sh, rot, so = _columns((pv, sh, rot, so), (4, None, 4, 4))
    n, width = len(pv), int(sh.shape[1])
    out = np.empty(lib.gcloud3d_size(n, width), np.uint8)
    got = lib.gcloud3d_encode(_ptr(pv), _ptr(sh), _ptr(rot), _ptr(so), n, _ptr(out, _U8), width)
    return out[:got].tobytes()


def encode_gcloud_4d_native(pv, sh, iso, so, ts) -> bytes:
    """A planar 4D cloud -> its ``.gc4d`` FlexBuffer."""
    lib = load()
    pv, sh, iso, so, ts = _columns((pv, sh, iso, so, ts), (4, SH_4D_WIDTH, 8, 4, 2))
    n = len(pv)
    out = np.empty(lib.gcloud4d_size(n), np.uint8)
    got = lib.gcloud4d_encode(_ptr(pv), _ptr(sh), _ptr(iso), _ptr(so), _ptr(ts), n, _ptr(out, _U8))
    return out[:got].tobytes()


def decode_gcloud_native(data: Bytes) -> Optional[dict]:
    """A ``.gcloud`` / ``.gc4d`` FlexBuffer -> ``{"pv", "sh", "rot" | "iso",
    "so"[, "ts"], "is4d"}`` -> None where the probe refuses the buffer (not a
    cloud map, a 4D harmonic width other than 144, a 3D width of 0): those
    go to the FlexBuffers reader.  A buffer the probe took that then decodes
    short raises ``ValueError``."""
    lib = load()
    buf, size = _buffer(data), len(data)
    is4d, width = ctypes.c_int32(0), ctypes.c_int32(0)
    n = lib.gcloud_probe(buf, size, ctypes.byref(is4d), ctypes.byref(width))
    if n < 0:
        return None
    if is4d.value:
        if width.value != SH_4D_WIDTH:
            return None
        out = {k: np.zeros((n, c), np.float32) for k, c in (("pv", 4), ("sh", SH_4D_WIDTH), ("iso", 8), ("so", 4),
                                                             ("ts", 2))}
        got = lib.gcloud4d_decode(buf, size, *(_ptr(out[k]) for k in ("pv", "sh", "iso", "so", "ts")), n)
    else:
        if width.value <= 0:
            return None
        out = {k: np.zeros((n, c), np.float32) for k, c in (("pv", 4), ("sh", width.value), ("rot", 4), ("so", 4))}
        got = lib.gcloud3d_decode(buf, size, *(_ptr(out[k]) for k in ("pv", "sh", "rot", "so")), n, width.value)
    if got != n:
        raise ValueError(f"malformed {'.gc4d' if is4d.value else '.gcloud'} FlexBuffer: the probe found {n} rows, "
                         f"the decoder returned {got}")
    out["is4d"] = bool(is4d.value)
    return out


def radix_sort_pairs(keys: np.ndarray, values: np.ndarray):
    """Stable ascending 8-bit LSD radix sort of u32 ``keys`` with their u32
    ``values`` -> ``(keys, values)``, sorted in place where the inputs are
    contiguous ``uint32`` arrays (otherwise in contiguous copies)."""
    lib = load()
    keys = np.ascontiguousarray(keys, np.uint32)
    values = np.ascontiguousarray(values, np.uint32)
    if keys.ndim != 1 or keys.shape != values.shape:
        raise ValueError(f"radix_sort_pairs: keys {keys.shape} and values {values.shape} must be one 1-D shape")
    lib.radix_sort_pairs_u32(_ptr(keys, _U32), _ptr(values, _U32), len(keys))
    return keys, values
