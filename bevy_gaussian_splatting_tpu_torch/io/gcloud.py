"""``.gcloud`` / ``.gc4d`` in FlexBuffers, the reference's default cloud
codec (src/io/gcloud/flexbuffers.rs:10-37: serde of the planar cloud), and
the columnar ``.npz`` of the JAX package's ``io/gcloud.py``.

The root map holds one column per cloud field, a vector of row structs
(field names from src/gaussian/f32.rs):

  PlanarGaussian3d  position_visibility [{position: [f32; 3], visibility}],
                    spherical_harmonic [{coefficients: [f32; W]}],
                    rotation [{rotation: [f32; 4]}],
                    scale_opacity [{scale: [f32; 3], opacity}]
  PlanarGaussian4d  position_visibility, spherindrical_harmonic
                    [{coefficients: [f32; 144]}], isotropic_rotations
                    [{rotation, rotation_r: [f32; 4]}], scale_opacity,
                    timestamp_timescale [{timestamp, timescale}]
  precompute_covariance_3d (planar_3d.rs:76-85): covariance_3d_opacity_packed128
                    [{cov3d: [u32; 3], opacity: u32}] (f16 pairs,
                    ``models/f16.py``), position_visibility, spherical_harmonic

3D and 4D files go through the native codec (``native/gsplat_native.cpp``)
by default, as in the JAX package: its files are byte for byte the JAX
package's default files.  Decoding dispatches as the JAX package's does: a
buffer that the native probe refuses (not a cloud map, a 4D harmonic width
other than 144, a 3D width of 0) goes to the FlexBuffers reader
``io/flexbuffers.py``; one it took that then decodes short raises.
``decode_paths`` counts the decoder each call took.  ``use_native=False``
runs the port's own FlexBuffers writer and reader: it lays out the columns
in the C++ encoder's order, so a 3D file is the native file byte for byte,
a 4D one differs in the order of the key strings only.  The covariance
flavour has no native path, in either package.  The ``.npz`` keeps the JAX
package's field names and its ``__format__`` entry, so either package reads
the other's files.
"""

from __future__ import annotations

import io as _io
from typing import Optional

import numpy as np

from bevy_gaussian_splatting_tpu_torch import native
from bevy_gaussian_splatting_tpu_torch.device import DeviceLike
from bevy_gaussian_splatting_tpu_torch.io import flexbuffers
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    Gaussian3dCovCloud,
    Gaussian4dCloud,
    cloud_from_numpy,
    cloud_to_numpy,
)
from bevy_gaussian_splatting_tpu_torch.models.f16 import (
    pack_covariance_3d_opacity,
    unpack_covariance_3d_opacity,
)

F32, U32 = np.float32, np.uint32
COV3D_COLUMN = "covariance_3d_opacity_packed128"

# column name -> its row fields (key, vector length or 0 for a scalar or
# None for the data's own, dtype), in the order of the cloud array's columns
_COLUMNS = {
    "position_visibility": [("position", 3, F32), ("visibility", 0, F32)],
    "spherical_harmonic": [("coefficients", None, F32)],
    "rotation": [("rotation", 4, F32)],
    "scale_opacity": [("scale", 3, F32), ("opacity", 0, F32)],
    "spherindrical_harmonic": [("coefficients", 144, F32)],
    "isotropic_rotations": [("rotation", 4, F32), ("rotation_r", 4, F32)],
    "timestamp_timescale": [("timestamp", 0, F32), ("timescale", 0, F32)],
    COV3D_COLUMN: [("cov3d", 3, U32), ("opacity", 0, U32)],
}
# the order each file writes its columns in (gsplat_native.cpp's for 3D and 4D)
_ORDER_3D = ("position_visibility", "rotation", "scale_opacity", "spherical_harmonic")
_ORDER_4D = ("position_visibility", "isotropic_rotations", "scale_opacity", "spherindrical_harmonic",
             "timestamp_timescale")
_ORDER_COV3D = (COV3D_COLUMN, "position_visibility", "spherical_harmonic")
# the native codec's arguments and results, in the C ABI's order
_NATIVE_3D = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
_NATIVE_4D = ("position_visibility", "spherindrical_harmonic", "isotropic_rotations", "scale_opacity",
              "timestamp_timescale")
_NATIVE_KEYS = {False: ("pv", "sh", "rot", "so"), True: ("pv", "sh", "iso", "so", "ts")}

decode_paths = {"native": 0, "flexbuffers": 0}


def _encode(arrays: dict, order) -> bytes:
    columns = []
    for name in order:
        arr, fields, c = arrays[name], [], 0
        for key, dim, _ in _COLUMNS[name]:
            width = arr.shape[1] if dim is None else max(dim, 1)
            fields.append((key, arr[:, c] if dim == 0 else arr[:, c:c + width]))
            c += width
        columns.append((name, fields))
    return flexbuffers.encode_map(columns)


def _decode(data: bytes, order) -> dict:
    return flexbuffers.read_columns(data, [(name, _COLUMNS[name]) for name in order])


def encode_gcloud_3d(cloud: Gaussian3dCloud, use_native: bool = True) -> bytes:
    arrays = cloud_to_numpy(cloud)
    if use_native:
        return native.encode_gcloud_3d_native(*(arrays[name] for name in _NATIVE_3D))
    return _encode(arrays, _ORDER_3D)


def encode_gcloud_4d(cloud: Gaussian4dCloud, use_native: bool = True) -> bytes:
    arrays = cloud_to_numpy(cloud)
    if use_native:
        return native.encode_gcloud_4d_native(*(arrays[name] for name in _NATIVE_4D))
    return _encode(arrays, _ORDER_4D)


def _decode_native(data: bytes, want_4d: bool, names) -> Optional[dict]:
    """The native decoder's columns by field name -> None where it leaves
    the buffer to the FlexBuffers reader, or where the buffer holds the
    other dimension's cloud (the reader then raises, as the JAX package's
    Python decoder does)."""
    columns = native.decode_gcloud_native(data)
    if columns is None or columns["is4d"] != want_4d:
        return None
    decode_paths["native"] += 1
    return dict(zip(names, (columns[k] for k in _NATIVE_KEYS[want_4d])))


def decode_gcloud_3d(data: bytes, device: DeviceLike = None, use_native: bool = True) -> Gaussian3dCloud:
    arrays = _decode_native(data, False, _NATIVE_3D) if use_native else None
    if arrays is None:
        decode_paths["flexbuffers"] += 1
        arrays = _decode(data, _ORDER_3D)
    return cloud_from_numpy(arrays, device)


def decode_gcloud_4d(data: bytes, device: DeviceLike = None, use_native: bool = True) -> Gaussian4dCloud:
    arrays = _decode_native(data, True, _NATIVE_4D) if use_native else None
    if arrays is None:
        decode_paths["flexbuffers"] += 1
        arrays = _decode(data, _ORDER_4D)
    return cloud_from_numpy(arrays, device)


def encode_gcloud_cov3d(cloud: Gaussian3dCovCloud) -> bytes:
    arrays = cloud_to_numpy(cloud)
    co = arrays.pop("covariance_3d_opacity")
    arrays[COV3D_COLUMN] = pack_covariance_3d_opacity(co[:, :6], co[:, 6])
    return _encode(arrays, _ORDER_COV3D)


def decode_gcloud_cov3d(data: bytes, device: DeviceLike = None) -> Gaussian3dCovCloud:
    arrays = _decode(data, _ORDER_COV3D)
    cov3d, opacity = unpack_covariance_3d_opacity(arrays.pop(COV3D_COLUMN))
    arrays["covariance_3d_opacity"] = np.concatenate(
        [cov3d, opacity[:, None], np.zeros((len(cov3d), 1), np.float32)], axis=1
    )
    return cloud_from_numpy(arrays, device)


def gcloud_is_cov3d(data: bytes) -> bool:
    """Whether the file has the precompute_covariance_3d schema (its packed
    covariance column)."""
    try:
        return COV3D_COLUMN in flexbuffers.root_keys(data)
    except ValueError:
        return False


_NPZ_FORMATS = {"3d": Gaussian3dCloud, "4d": Gaussian4dCloud, "3dcov": Gaussian3dCovCloud}


def encode_npz(cloud) -> bytes:
    """Columnar npz: the cloud's fields by name, and ``__format__``."""
    arrays = cloud_to_numpy(cloud)
    arrays["__format__"] = np.array([next(f for f, cls in _NPZ_FORMATS.items() if isinstance(cloud, cls))])
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_npz(data: bytes, device: DeviceLike = None):
    with np.load(_io.BytesIO(data)) as z:
        fmt = str(z["__format__"][0])
        fields = {k: z[k] for k in z.files if k != "__format__"}
    cloud = cloud_from_numpy(fields, device)
    if type(cloud) is not _NPZ_FORMATS.get(fmt, Gaussian3dCloud):
        raise ValueError(f"npz format {fmt!r} does not match its fields {sorted(fields)}")
    return cloud
