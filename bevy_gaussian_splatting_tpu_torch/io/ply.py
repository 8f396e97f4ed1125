"""PLY import and export for 3D and 4D gaussian clouds, the JAX package's
``io/ply.py`` with the reference loader's activations (src/io/ply.rs):

  3D (parse_ply_3d, ply.rs:76-132): opacity sigmoid (ply.rs:40-42); scale
  clamped to its row mean +- 4, then exp (ply.rs:105-116); rotation
  normalised (ply.rs:118-124); f_rest channel-planar -> interleaved
  (ply.rs:56-66); padding to a multiple of 32 (ply.rs:127-129).

  4D (parse_ply_4d, ply.rs:185-247): x/y/z/t/st, feat_[rgb]_i
  spherindrical coefficients, raw sx/sy/sz and opacity, both quaternions
  normalised.

``parse_ply_3d`` decodes bytes with the native decoder
(``native/gsplat_native.cpp``, threaded over row ranges) by default, as the
JAX package does: the same source and compiler flags, so the same bits.
Where the native reader refuses a file by its status (a layout its header
parser does not take: ASCII, big-endian, list properties, zero rows; a
missing required property; a truncated body) the numpy decoder runs, and
decodes or raises as the JAX package's does.  ``parse_ply_3d.paths`` counts
the decoder each call took.  A native build that fails raises.

Reference quirks kept (``strict_reference=False`` gives the correct
mapping): the f_rest channel divides by 16 while the coefficient wraps
modulo 15, so f_rest_0 and f_rest_15 both land on slot 3 and the later one
wins (ply.rs:60-66); the padding always appends 1..32 rows
(ply.rs:127-128).  So ``parse_ply_3d(write_ply_3d(c))`` gives back ``c``'s
SH only with ``strict_reference=False``.

The writers emit binary little-endian PLY with the inverse activations.
``write_ply_4d`` has no counterpart in the JAX package: it writes the raw
4D schema that ``parse_ply_4d`` reads (``.ply4d``).
"""

from __future__ import annotations

import io as _io
from typing import BinaryIO, Optional, Union

import numpy as np

from bevy_gaussian_splatting_tpu_torch import native
from bevy_gaussian_splatting_tpu_torch.device import DeviceLike
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    SH_4D_COEFF_COUNT,
    SH_MAX_DEGREE,
    Gaussian3dCloud,
    Gaussian4dCloud,
    cloud_from_numpy,
    cloud_to_numpy,
    num_sh_coefficients,
    sh_coeff_width,
    sh_degree_from_width,
)

MAX_SIZE_VARIANCE = 4.0  # src/io/ply.rs:21

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "char": "<i1",
    "int8": "<i1",
    "uchar": "<u1",
    "uint8": "<u1",
    "short": "<i2",
    "int16": "<i2",
    "ushort": "<u2",
    "uint16": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}

_ROT_4D = ("rot_x", "rot_y", "rot_z", "rot_w", "rot_r_x", "rot_r_y", "rot_r_z", "rot_r_w")


def _read_header(f: BinaryIO):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_str)])
    current = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        parts = line.decode("ascii", "replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] in ("comment", "obj_info"):
            continue
        elif parts[0] == "element":
            current = (parts[1], int(parts[2]), [])
            elements.append(current)
        elif parts[0] == "property":
            if current is None:
                raise ValueError("property before element")
            if parts[1] == "list":
                current[2].append((parts[-1], ("list", parts[2], parts[3])))
            else:
                current[2].append((parts[-1], _PLY_DTYPES[parts[1]]))
        elif parts[0] == "end_header":
            break
    return fmt, elements


def _read_vertex_data(f: BinaryIO, fmt: str, elements) -> dict:
    """Read every element; return the vertex element's float32 columns."""
    vertex = None
    for name, count, props in elements:
        if any(isinstance(d, tuple) for _, d in props):
            raise ValueError("list properties are not supported in gaussian PLYs")
        if fmt == "ascii":
            rows = np.loadtxt(
                _io.StringIO("\n".join(f.readline().decode("ascii") for _ in range(count))),
                dtype=np.float64,
                ndmin=2,
            )
            data = {p: rows[:, i].astype(np.float32) for i, (p, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(p, d) for p, d in props])
            arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
            data = {p: arr[p].astype(np.float32) for p, _ in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        if name == "vertex":
            vertex = data
    if vertex is None:
        raise ValueError("missing vertex element")
    return vertex


def _read(source: Union[bytes, BinaryIO]) -> dict:
    f = _io.BytesIO(source) if isinstance(source, (bytes, bytearray)) else source
    return _read_vertex_data(f, *_read_header(f))


def _require(data: dict, names) -> None:
    missing = [n for n in names if n not in data]
    if missing:
        raise ValueError(f"missing required properties: {missing}")


def _pad_rows(n: int) -> int:
    """Reference padding rule: always appends 1..32 rows (ply.rs:127-128)."""
    return 32 - (n % 32)


def _padded(a: np.ndarray, pad: int) -> np.ndarray:
    return np.concatenate([a, np.zeros((pad, a.shape[1]), np.float32)])


def _infer_sh_degree_from_rest(n_rest: int) -> int:
    """Smallest SH degree whose layout holds ``n_rest`` f_rest properties,
    capped at SH_MAX_DEGREE (the reference's compile-time shN feature)."""
    per_ch = n_rest // 3 + 1
    degree = 0
    while degree < SH_MAX_DEGREE and num_sh_coefficients(degree) < per_ch:
        degree += 1
    return degree


def _header_rest_count(source: Union[bytes, bytearray]) -> int:
    """The f_rest_* vertex properties declared as ``float`` or ``float32``,
    counted in the header bytes only (the native path's degree inference)."""
    end = source.find(b"end_header")
    head = source[: end if end >= 0 else 4096]
    return head.count(b"property float f_rest_") + head.count(b"property float32 f_rest_")


def parse_ply_3d(
    source: Union[bytes, BinaryIO],
    strict_reference: bool = True,
    use_native: bool = True,
    sh_degree: Optional[int] = None,
    device: DeviceLike = None,
) -> Gaussian3dCloud:
    """A 3DGS PLY (binary little-endian or ascii) -> ``Gaussian3dCloud`` on
    ``device``.  ``sh_degree``: the SH storage degree (the reference's
    sh0..sh4 feature); ``None`` infers it from the f_rest property count, an
    explicit degree truncates or zero-extends.  ``use_native``: bytes go to
    the native decoder first (module docstring); file objects and
    ``use_native=False`` take the numpy decoder."""
    if use_native and isinstance(source, (bytes, bytearray)):
        degree = sh_degree if sh_degree is not None else _infer_sh_degree_from_rest(_header_rest_count(source))
        out = native.parse_ply_3d_native(
            source, strict_reference, sh_width=sh_coeff_width(degree), sh_per_channel=num_sh_coefficients(degree)
        )
        if out is not None:
            parse_ply_3d.paths["native"] += 1
            names = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
            return cloud_from_numpy(dict(zip(names, out)), device)
    parse_ply_3d.paths["numpy"] += 1
    data = _read(source)
    _require(
        data,
        ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "scale_0", "scale_1",
         "opacity", "rot_0", "rot_1", "rot_2", "rot_3"],
    )  # ply.rs:81-85
    n = len(data["x"])

    pos = np.stack([data["x"], data["y"], data["z"]], axis=1)
    vis = data.get("visibility", np.ones(n, np.float32))
    pv = np.concatenate([pos, vis[:, None]], axis=1).astype(np.float32)

    if sh_degree is None:
        sh_degree = _infer_sh_degree_from_rest(sum(1 for k in data if k.startswith("f_rest_")))
    sh_width = sh_coeff_width(sh_degree)
    sh = np.zeros((n, sh_width), np.float32)
    sh[:, 0] = data["f_dc_0"]
    sh[:, 1] = data["f_dc_1"]
    sh[:, 2] = data["f_dc_2"]
    per_ch = num_sh_coefficients(sh_degree)  # 16 at the default degree 3
    for key, col in data.items():
        if not key.startswith("f_rest_") or per_ch <= 1:
            continue
        i = int(key[7:])
        # the reference divides by 16, not 15 (ply.rs:60)
        channel = i // per_ch if strict_reference else i // (per_ch - 1)
        coefficient = (i % (per_ch - 1)) + 1
        idx = coefficient * 3 + channel
        if idx < sh_width:
            sh[:, idx] = col

    rot = np.stack([data["rot_0"], data["rot_1"], data["rot_2"], data["rot_3"]], axis=1)
    rot = (rot / np.linalg.norm(rot, axis=1, keepdims=True)).astype(np.float32)

    scale = np.stack([data["scale_0"], data["scale_1"], data.get("scale_2", data["scale_1"])], axis=1)
    mean_scale = scale.mean(axis=1, keepdims=True)
    scale = np.exp(np.clip(scale, mean_scale - MAX_SIZE_VARIANCE, mean_scale + MAX_SIZE_VARIANCE))
    opacity = 1.0 / (1.0 + np.exp(-data["opacity"]))
    so = np.concatenate([scale, opacity[:, None]], axis=1).astype(np.float32)

    pad = _pad_rows(n)
    return cloud_from_numpy(
        {
            "position_visibility": _padded(pv, pad),
            "spherical_harmonic": _padded(sh, pad),
            "rotation": _padded(rot, pad),
            "scale_opacity": _padded(so, pad),
        },
        device,
    )


parse_ply_3d.paths = {"native": 0, "numpy": 0}


def parse_ply_4d(source: Union[bytes, BinaryIO], device: DeviceLike = None) -> Gaussian4dCloud:
    """A 4DGS PLY -> ``Gaussian4dCloud`` on ``device``."""
    data = _read(source)
    _require(data, ["x", "y", "z", "t", "st", "sx", "sy", "sz", "opacity", *_ROT_4D])
    n = len(data["x"])

    pos = np.stack([data["x"], data["y"], data["z"]], axis=1)
    vis = data.get("visibility", np.ones(n, np.float32))
    pv = np.concatenate([pos, vis[:, None]], axis=1).astype(np.float32)

    sh = np.zeros((n, SH_4D_COEFF_COUNT), np.float32)
    for key, col in data.items():
        if not key.startswith("feat_"):
            continue
        channel = {"r": 0, "g": 1, "b": 2}[key[5]]
        idx = int(key[7:]) * 3 + channel
        if idx < SH_4D_COEFF_COUNT:
            sh[:, idx] = col

    def unit(q):
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    # rot_{x,y,z,w} is stored as-is into rotation[0..3] (ply.rs:204-213);
    # the shader then reads component 0 as w
    rot_l = unit(np.stack([data[k] for k in _ROT_4D[:4]], axis=1))
    rot_r = unit(np.stack([data[k] for k in _ROT_4D[4:]], axis=1))
    iso = np.concatenate([rot_l, rot_r], axis=1).astype(np.float32)
    so = np.stack([data["sx"], data["sy"], data["sz"], data["opacity"]], axis=1).astype(np.float32)
    ts = np.stack([data["t"], data["st"]], axis=1).astype(np.float32)

    pad = _pad_rows(n)
    return cloud_from_numpy(
        {
            "position_visibility": _padded(pv, pad),
            "spherindrical_harmonic": _padded(sh, pad),
            "isotropic_rotations": _padded(iso, pad),
            "scale_opacity": _padded(so, pad),
            "timestamp_timescale": _padded(ts, pad),
        },
        device,
    )


def _ply_bytes(props: list, cols: list, n: int) -> bytes:
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    ).encode("ascii")
    return header + np.stack(cols, axis=1).astype("<f4").tobytes()


def write_ply_3d(cloud: Gaussian3dCloud, include_padding: bool = True) -> bytes:
    """Standard channel-planar 3DGS PLY (binary little endian) with inverse
    activations (log scale, logit opacity), so ``parse_ply_3d(write_ply_3d(c),
    strict_reference=False)`` round-trips.  Every row is written, padding
    rows too: ``include_padding`` is ignored, as in the JAX package."""
    a = cloud_to_numpy(cloud)
    pv, sh, rot, so = a["position_visibility"], a["spherical_harmonic"], a["rotation"], a["scale_opacity"]
    per_ch = num_sh_coefficients(sh_degree_from_width(sh.shape[1]))
    n_rest = (per_ch - 1) * 3
    props = (
        ["x", "y", "z", "visibility", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["scale_0", "scale_1", "scale_2", "opacity", "rot_0", "rot_1", "rot_2", "rot_3"]
    )
    cols = [pv[:, 0], pv[:, 1], pv[:, 2], pv[:, 3], sh[:, 0], sh[:, 1], sh[:, 2]]
    for i in range(n_rest):
        channel = i // (per_ch - 1)
        coefficient = (i % (per_ch - 1)) + 1
        cols.append(sh[:, coefficient * 3 + channel])
    log_scale = np.log(np.maximum(so[:, :3], 1e-12))
    op = np.clip(so[:, 3], 1e-6, 1.0 - 1e-6)
    logit_op = np.log(op / (1.0 - op))
    cols += [log_scale[:, 0], log_scale[:, 1], log_scale[:, 2], logit_op,
             rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]]
    return _ply_bytes(props, cols, len(pv))


def write_ply_4d(cloud: Gaussian4dCloud) -> bytes:
    """The 4D schema that :func:`parse_ply_4d` reads, with the raw values it
    stores (no activation): ``parse_ply_4d(write_ply_4d(c))`` is ``c`` with
    its quaternions normalised again and 1..32 padding rows."""
    a = cloud_to_numpy(cloud)
    pv, sh, iso = a["position_visibility"], a["spherindrical_harmonic"], a["isotropic_rotations"]
    so, ts = a["scale_opacity"], a["timestamp_timescale"]
    per_ch = SH_4D_COEFF_COUNT // 3
    props = (
        ["x", "y", "z", "visibility", "t", "st", "sx", "sy", "sz", "opacity", *_ROT_4D]
        + [f"feat_{ch}_{i}" for ch in "rgb" for i in range(per_ch)]
    )
    cols = [pv[:, 0], pv[:, 1], pv[:, 2], pv[:, 3], ts[:, 0], ts[:, 1], so[:, 0], so[:, 1], so[:, 2], so[:, 3]]
    cols += [iso[:, k] for k in range(8)]
    cols += [sh[:, i * 3 + ch] for ch in range(3) for i in range(per_ch)]
    return _ply_bytes(props, cols, len(pv))
