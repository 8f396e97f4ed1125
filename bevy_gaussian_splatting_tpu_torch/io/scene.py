"""glTF / GLB ``KHR_gaussian_splatting`` scene IO: the JAX package's
``io/scene.py`` (the reference's src/io/scene.rs) in numpy, json and struct,
its clouds on a device.

  Load (scene.rs:288-764): GLB containers and .gltf JSON with side files or
  base64 data URIs (scene.rs:556-687); mode-0 (POINTS) primitives with the
  KHR_gaussian_splatting extension, which extensionsUsed must list
  (scene.rs:358); accessors with byteStride and i8/i16/u8/u16 normalisation
  (scene.rs:1590-2013): rotation renormalised, a zero quaternion the
  identity; scale exp-activated; opacity range-checked; SH attributes
  ``KHR_gaussian_splatting:SH_DEGREE_{d}_COEF_{c}`` validated per degree
  (scene.rs:1436-1562), COLOR_0 / 0.282095 where there are none
  (scene.rs:36, 1355-1361); the node tree with world transforms and the
  cameras (scene.rs:689-764).

  Export (scene.rs:766-1134): one binary buffer of f32 accessors, log scale,
  clamped opacity, renormalised rotations (zero ones dropped), SH per
  degree, the extension object, node matrices and an optional perspective
  camera.  For the same clouds and camera the bytes are the JAX package's.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
from typing import Optional

import numpy as np

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    cloud_from_numpy,
    cloud_to_numpy,
    num_sh_coefficients,
    sh_coeff_width,
    sh_degree_from_width,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianColorSpace

KHR_EXTENSION = "KHR_gaussian_splatting"
ATTR_POSITION = "POSITION"
ATTR_COLOR_0 = "COLOR_0"
ATTR_ROTATION = "KHR_gaussian_splatting:ROTATION"
ATTR_SCALE = "KHR_gaussian_splatting:SCALE"
ATTR_OPACITY = "KHR_gaussian_splatting:OPACITY"
ATTR_SH_PREFIX = "KHR_gaussian_splatting:SH_DEGREE_"
SH_DEGREE_ZERO_BASIS = 0.282095  # scene.rs:36

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class SceneError(ValueError):
    pass


@dataclasses.dataclass
class SceneCamera:
    name: str
    transform: np.ndarray  # [4, 4] world transform of the camera node
    yfov_radians: Optional[float] = None
    znear: Optional[float] = None
    zfar: Optional[float] = None


@dataclasses.dataclass
class SceneCloud:
    name: str
    cloud: Gaussian3dCloud
    transform: np.ndarray  # [4, 4] world transform
    settings: CloudSettings
    extension: dict  # raw KHR_gaussian_splatting extension object


@dataclasses.dataclass
class GaussianScene:
    clouds: list
    cameras: list

    def __len__(self):
        return len(self.clouds)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _parse_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise SceneError("not a GLB container")
    if version != 2:
        raise SceneError(f"unsupported GLB version {version}")
    offset = 12
    json_chunk = None
    bin_chunk = None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # 'JSON'
            json_chunk = chunk
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
    if json_chunk is None:
        raise SceneError("GLB missing JSON chunk")
    return json.loads(json_chunk), bin_chunk


def _load_buffers(root: dict, bin_chunk: Optional[bytes], base_dir: Optional[str]):
    """scene.rs:556-687: GLB-embedded, data-URI, or external file buffers."""
    buffers = []
    for i, buf in enumerate(root.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise SceneError(f"buffer {i} has no uri and no GLB binary chunk")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            _, _, b64 = uri.partition("base64,")
            if not b64:
                raise SceneError(f"buffer {i} data URI is not base64-encoded")
            buffers.append(base64.b64decode(b64))
        else:
            if base_dir is None:
                raise SceneError(f"buffer {i} references external file {uri!r}")
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
        if len(buffers[-1]) < buf.get("byteLength", 0):
            raise SceneError(f"buffer {i} shorter than declared byteLength")
    return buffers


def _read_accessor(root: dict, buffers, accessor_index: int) -> tuple[np.ndarray, dict]:
    """Decode an accessor into a [count, comps] float/int array (raw, no
    normalization) — scene.rs read_items (scene.rs:2015+)."""
    acc = root["accessors"][accessor_index]
    if "sparse" in acc:
        raise SceneError("sparse accessors are not supported")
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    bv = root["bufferViews"][acc["bufferView"]]
    buf = buffers[bv["buffer"]]
    base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize * n_comp
    stride = bv.get("byteStride", itemsize)
    if stride == itemsize:
        arr = np.frombuffer(buf, dtype=dtype, count=count * n_comp, offset=base)
        arr = arr.reshape(count, n_comp)
    else:
        if count and base + (count - 1) * stride + itemsize > len(buf):
            raise SceneError(f"accessor {accessor_index} runs past the end of its buffer")
        arr = np.ndarray(
            (count, n_comp), dtype=dtype, buffer=buf, offset=base, strides=(stride, np.dtype(dtype).itemsize)
        ).copy()
    return arr, acc


def _norm_signed(v: np.ndarray, denom: float) -> np.ndarray:
    return np.maximum(v.astype(np.float32) / denom, -1.0)


def _decode_rotation(arr, acc) -> np.ndarray:
    """scene.rs:1631-1707: f32 or normalized i8/i16; renormalize, zero-length
    quaternions replaced with identity (w-first, matching wgsl order w,x,y,z
    stored as rotation[0..3])."""
    if acc["type"] != "VEC4":
        raise SceneError(f"'{ATTR_ROTATION}' must be VEC4")
    ct, normalized = acc["componentType"], acc.get("normalized", False)
    if ct == 5126:
        vals = arr.astype(np.float32)
    elif ct == 5120 and normalized:
        vals = _norm_signed(arr, 127.0)
    elif ct == 5122 and normalized:
        vals = _norm_signed(arr, 32767.0)
    else:
        raise SceneError(f"'{ATTR_ROTATION}' must be float or normalized signed int")
    norm = np.linalg.norm(vals, axis=1, keepdims=True)
    identity = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    out = np.where(norm > 1e-12, vals / np.maximum(norm, 1e-12), identity)
    if not np.isfinite(out).all():
        raise SceneError(f"'{ATTR_ROTATION}' contains non-finite values")
    return out.astype(np.float32)


def _decode_scale(arr, acc) -> np.ndarray:
    """scene.rs:1709-1776: f32 or i8/i16 (normalized or raw), then exp."""
    if acc["type"] != "VEC3":
        raise SceneError(f"'{ATTR_SCALE}' must be VEC3")
    ct, normalized = acc["componentType"], acc.get("normalized", False)
    if ct == 5126:
        vals = arr.astype(np.float32)
    elif ct == 5120:
        vals = _norm_signed(arr, 127.0) if normalized else arr.astype(np.float32)
    elif ct == 5122:
        vals = _norm_signed(arr, 32767.0) if normalized else arr.astype(np.float32)
    else:
        raise SceneError(f"'{ATTR_SCALE}' must be float or signed int")
    out = np.exp(vals)
    if not np.isfinite(out).all():
        raise SceneError(f"'{ATTR_SCALE}' produces non-finite scale after exp")
    return out.astype(np.float32)


def _decode_opacity(arr, acc) -> np.ndarray:
    """scene.rs:1778-1826: f32 or normalized u8/u16; must lie in [0, 1]."""
    if acc["type"] != "SCALAR":
        raise SceneError(f"'{ATTR_OPACITY}' must be SCALAR")
    ct, normalized = acc["componentType"], acc.get("normalized", False)
    if ct == 5126:
        vals = arr[:, 0].astype(np.float32)
    elif ct == 5121 and normalized:
        vals = arr[:, 0].astype(np.float32) / 255.0
    elif ct == 5123 and normalized:
        vals = arr[:, 0].astype(np.float32) / 65535.0
    else:
        raise SceneError(f"'{ATTR_OPACITY}' must be float or normalized unsigned int")
    if (~np.isfinite(vals)).any() or (vals < 0).any() or (vals > 1).any():
        raise SceneError(f"'{ATTR_OPACITY}' contains out-of-range values")
    return vals


def _decode_color(arr, acc) -> np.ndarray:
    """scene.rs:1828-1924: VEC3/VEC4 f32 or normalized u8/u16, rgb only."""
    ct = acc["componentType"]
    if acc["type"] not in ("VEC3", "VEC4"):
        raise SceneError(f"'{ATTR_COLOR_0}' must be VEC3 or VEC4")
    rgb = arr[:, :3]
    if ct == 5126:
        return rgb.astype(np.float32)
    if ct == 5121:
        return rgb.astype(np.float32) / 255.0
    if ct == 5123:
        return rgb.astype(np.float32) / 65535.0
    raise SceneError(f"'{ATTR_COLOR_0}' has unsupported component type")


def _collect_sh_map(attributes: dict, sh_degree: int = 3) -> list:
    """scene.rs:1457-1562: validated (coefficient_index, accessor_index).

    ``sh_degree`` plays the reference's compile-time shN feature: attributes
    above it are validated but dropped (scene.rs caps at its SH_COEFF_COUNT)."""
    degrees: dict = {}
    for semantic, accessor_index in attributes.items():
        if not semantic.startswith(ATTR_SH_PREFIX):
            continue
        rest = semantic[len(ATTR_SH_PREFIX):]
        if "_COEF_" not in rest:
            continue
        d_str, _, c_str = rest.partition("_COEF_")
        try:
            degree, coefficient = int(d_str), int(c_str)
        except ValueError:
            continue
        degrees.setdefault(degree, {})[coefficient] = accessor_index

    if not degrees:
        return []
    if 0 not in degrees or 0 not in degrees[0]:
        raise SceneError(
            "missing required spherical harmonics attribute "
            "'KHR_gaussian_splatting:SH_DEGREE_0_COEF_0'"
        )
    max_degree = max(degrees)
    if max_degree > 3:
        raise SceneError(f"unsupported spherical harmonics degree {max_degree}")
    supported = sh_degree
    for degree in range(max_degree + 1):
        expected = 2 * degree + 1
        if degree not in degrees:
            raise SceneError(f"spherical harmonics degree {degree} is missing")
        if len(degrees[degree]) != expected:
            raise SceneError(
                f"spherical harmonics degree {degree} must define exactly {expected} coefficients"
            )
        for c in range(expected):
            if c not in degrees[degree]:
                raise SceneError(f"degree {degree} missing coefficient {c}")

    out = []
    for degree in range(min(max_degree, supported) + 1):
        for c in range(2 * degree + 1):
            out.append((degree * degree + c, degrees[degree][c]))
    return out


def _decode_primitive(root, buffers, attributes: dict, sh_degree: Optional[int] = 3) -> dict:
    """decode_gaussian_primitive (scene.rs:1305-1396) -> the cloud's arrays.

    ``sh_degree`` selects the SH storage layout (sh0..sh4 axis); ``None``
    stores at the file's own max degree (data-driven width)."""
    for semantic in (ATTR_POSITION, ATTR_ROTATION, ATTR_SCALE, ATTR_OPACITY):
        if semantic not in attributes:
            raise SceneError(f"missing required attribute semantic '{semantic}'")

    pos_arr, pos_acc = _read_accessor(root, buffers, attributes[ATTR_POSITION])
    if pos_acc["type"] != "VEC3" or pos_acc["componentType"] != 5126:
        raise SceneError(f"'{ATTR_POSITION}' must be VEC3 float")
    if not np.isfinite(pos_arr).all():
        raise SceneError(f"'{ATTR_POSITION}' contains non-finite values")
    count = pos_acc["count"]

    rot = _decode_rotation(*_read_accessor(root, buffers, attributes[ATTR_ROTATION]))
    scale = _decode_scale(*_read_accessor(root, buffers, attributes[ATTR_SCALE]))
    opacity = _decode_opacity(*_read_accessor(root, buffers, attributes[ATTR_OPACITY]))
    for name, a in (("rotation", rot), ("scale", scale), ("opacity", opacity)):
        if len(a) != count:
            raise SceneError(f"attribute '{name}' has {len(a)} entries; expected {count}")

    if sh_degree is None:
        file_degrees = [
            int(sem[len(ATTR_SH_PREFIX):].partition("_COEF_")[0])
            for sem in attributes
            if sem.startswith(ATTR_SH_PREFIX) and "_COEF_" in sem
        ]
        sh_degree = min(max(file_degrees, default=0), 3)
    sh_width = sh_coeff_width(sh_degree)
    sh = np.zeros((count, sh_width), np.float32)
    sh_map = _collect_sh_map(attributes, sh_degree)
    if sh_map:
        for coefficient_index, accessor_index in sh_map:
            arr, acc = _read_accessor(root, buffers, accessor_index)
            if acc["type"] != "VEC3" or acc["componentType"] != 5126:
                raise SceneError("SH coefficient accessors must be VEC3 float")
            if acc["count"] != count:
                raise SceneError("SH accessor count mismatch")
            base = coefficient_index * 3
            if base + 2 < sh_width:
                sh[:, base : base + 3] = arr
    elif ATTR_COLOR_0 in attributes:
        color = _decode_color(*_read_accessor(root, buffers, attributes[ATTR_COLOR_0]))
        if len(color) != count:
            raise SceneError(f"'{ATTR_COLOR_0}' count mismatch")
        sh[:, :3] = color / SH_DEGREE_ZERO_BASIS  # scene.rs:1355-1361

    pv = np.concatenate([pos_arr.astype(np.float32), np.ones((count, 1), np.float32)], axis=1)
    so = np.concatenate([scale, opacity[:, None]], axis=1)
    return {"position_visibility": pv, "spherical_harmonic": sh, "rotation": rot, "scale_opacity": so}


def _node_local_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major
    m = np.eye(4, dtype=np.float32)
    if "rotation" in node:  # glTF quat xyzw
        x, y, z, w = node["rotation"]
        m[:3, :3] = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.asarray(node["scale"], np.float32)[None, :]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _color_space_from_extension(ext: dict) -> GaussianColorSpace:
    cs = ext.get("colorSpace", "srgb_rec709_display")
    if cs in ("lin_rec709_display", "linRec709Display"):
        return GaussianColorSpace.LIN_REC709_DISPLAY
    return GaussianColorSpace.SRGB_REC709_DISPLAY


def load_khr_gaussian_scene(
    source, base_dir: Optional[str] = None, sh_degree: Optional[int] = 3, device: DeviceLike = None
) -> GaussianScene:
    """Load a .glb/.gltf scene (bytes or path) -> GaussianScene, its clouds
    on ``device``.

    ``sh_degree``: SH storage degree for decoded clouds (the reference's
    sh0..sh4 compile feature; default 3 matches its default build).  ``None``
    stores each primitive at its file's own max degree."""
    if isinstance(source, str):
        base_dir = base_dir or os.path.dirname(source)
        with open(source, "rb") as f:
            data = f.read()
    else:
        data = source

    if data[:4] == b"glTF":
        root, bin_chunk = _parse_glb(data)
    else:
        root, bin_chunk = json.loads(data), None

    if KHR_EXTENSION not in root.get("extensionsUsed", []):
        # scene.rs:358 requires the extension listed when primitives use it;
        # check after scanning primitives
        extension_listed = False
    else:
        extension_listed = True

    buffers = _load_buffers(root, bin_chunk, base_dir)

    # collect gaussian primitives per (mesh, primitive)
    primitive_sources = {}
    for mesh_index, mesh in enumerate(root.get("meshes", [])):
        for prim_index, prim in enumerate(mesh.get("primitives", [])):
            ext = prim.get("extensions", {}).get(KHR_EXTENSION)
            if ext is None:
                continue
            mode = prim.get("mode", 4)
            if mode != 0:
                raise SceneError(
                    f"mesh {mesh_index} primitive {prim_index} has {KHR_EXTENSION} "
                    f"but mode={mode}; mode must be POINTS (0)"
                )
            if not extension_listed:
                raise SceneError(
                    f"{KHR_EXTENSION} primitives are present but the extension is "
                    "missing from extensionsUsed"
                )
            primitive_sources[(mesh_index, prim_index)] = (prim.get("attributes", {}), ext)

    if not primitive_sources:
        raise SceneError(f"no {KHR_EXTENSION} primitives found")

    clouds: list = []
    cameras: list = []
    nodes = root.get("nodes", [])
    cameras_json = root.get("cameras", [])

    def walk(node_index: int, parent: np.ndarray):
        node = nodes[node_index]
        world = parent @ _node_local_transform(node)
        name = node.get("name", "gaussian_node")
        if "camera" in node:
            cam_def = cameras_json[node["camera"]] if node["camera"] < len(cameras_json) else {}
            persp = cam_def.get("perspective", {})
            cameras.append(
                SceneCamera(
                    name=name,
                    transform=world,
                    yfov_radians=persp.get("yfov"),
                    znear=persp.get("znear"),
                    zfar=persp.get("zfar"),
                )
            )
        if "mesh" in node:
            mesh_index = node["mesh"]
            mesh = root["meshes"][mesh_index]
            for prim_index in range(len(mesh.get("primitives", []))):
                src = primitive_sources.get((mesh_index, prim_index))
                if src is None:
                    continue
                attributes, ext = src
                cloud = cloud_from_numpy(_decode_primitive(root, buffers, attributes, sh_degree), device)
                settings = CloudSettings(color_space=_color_space_from_extension(ext))
                clouds.append(
                    SceneCloud(
                        name=f"{name}_mesh{mesh_index}_primitive{prim_index}",
                        cloud=cloud,
                        transform=world,
                        settings=settings,
                        extension=ext,
                    )
                )
        for child in node.get("children", []):
            walk(child, world)

    scene_index = root.get("scene", 0)
    scenes = root.get("scenes", [{}])
    root_nodes = scenes[scene_index].get("nodes", list(range(len(nodes)))) if scenes else []
    for node_index in root_nodes:
        walk(node_index, np.eye(4, dtype=np.float32))

    if not clouds:
        raise SceneError(
            f"{KHR_EXTENSION} scene contained no loadable gaussian primitives"
        )
    return GaussianScene(clouds=clouds, cameras=cameras)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def _sh_index_to_degree_coefficient(i: int) -> tuple[int, int]:
    degree = int(np.floor(np.sqrt(i)))
    return degree, i - degree * degree


def _extension_object(settings: Optional[CloudSettings]) -> dict:
    color_space = "srgb_rec709_display"
    if settings is not None and settings.color_space == GaussianColorSpace.LIN_REC709_DISPLAY:
        color_space = "lin_rec709_display"
    return {
        "kernel": "ellipse",
        "colorSpace": color_space,
        "projection": "perspective",
        "sortingMethod": "cameraDistance",
    }


def _encode_scene(clouds, camera: Optional[SceneCamera], data_uri: bool) -> tuple[bytes, bytes]:
    """scene.rs:766-1088 -> (the glTF JSON, its binary buffer).  With
    ``data_uri`` the buffer is a base64 data URI in the JSON (.gltf), else
    the GLB's binary chunk."""
    if not clouds:
        raise SceneError("cannot export an empty KHR_gaussian_splatting scene")

    binary = bytearray()
    buffer_views = []
    accessors = []
    meshes = []
    nodes = []
    scene_nodes = []
    cameras_json = []

    def push_f32_accessor(values: np.ndarray, count: int, acc_type: str, minmax=False):
        data = np.ascontiguousarray(values, dtype="<f4").tobytes()
        offset = len(binary)
        binary.extend(data)
        buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        )
        acc = {
            "bufferView": len(buffer_views) - 1,
            "componentType": 5126,
            "count": count,
            "type": acc_type,
        }
        if minmax:
            acc["min"] = np.min(values.reshape(count, -1), axis=0).tolist()
            acc["max"] = np.max(values.reshape(count, -1), axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    total = 0
    for sc in clouds:
        if isinstance(sc, SceneCloud):
            name, cloud, transform, settings = sc.name, sc.cloud, sc.transform, sc.settings
        else:
            name, cloud, transform = sc
            settings = CloudSettings()

        a = cloud_to_numpy(cloud)
        pv, sh, rot, so = a["position_visibility"], a["spherical_harmonic"], a["rotation"], a["scale_opacity"]

        # drop invalid (zero-length) rotations like the reference (scene.rs:800-860)
        norms = np.linalg.norm(rot, axis=1)
        keep = norms > 1e-12
        pv, sh, rot, so, norms = pv[keep], sh[keep], rot[keep], so[keep], norms[keep]
        count = len(pv)
        if count == 0:
            continue
        total += count

        positions = pv[:, :3].astype(np.float32)
        rotations = (rot / norms[:, None]).astype(np.float32)
        scales = np.log(np.maximum(so[:, :3], 1e-6)).astype(np.float32)
        opacities = np.clip(so[:, 3], 0.0, 1.0).astype(np.float32)

        attributes = {
            ATTR_POSITION: push_f32_accessor(positions, count, "VEC3", minmax=True),
            ATTR_ROTATION: push_f32_accessor(rotations, count, "VEC4"),
            ATTR_SCALE: push_f32_accessor(scales, count, "VEC3"),
            ATTR_OPACITY: push_f32_accessor(opacities, count, "SCALAR"),
        }
        for ci in range(num_sh_coefficients(sh_degree_from_width(sh.shape[1]))):
            base = ci * 3
            vals = sh[:, base : base + 3].astype(np.float32)
            degree, coefficient = _sh_index_to_degree_coefficient(ci)
            attributes[f"{ATTR_SH_PREFIX}{degree}_COEF_{coefficient}"] = push_f32_accessor(
                vals, count, "VEC3"
            )

        meshes.append(
            {
                "name": name,
                "primitives": [
                    {
                        "attributes": attributes,
                        "mode": 0,
                        "extensions": {KHR_EXTENSION: _extension_object(settings)},
                    }
                ],
            }
        )
        node_index = len(nodes)
        scene_nodes.append(node_index)
        nodes.append(
            {
                "name": name,
                "mesh": len(meshes) - 1,
                # glTF matrices are column-major
                "matrix": np.asarray(transform, np.float32).T.reshape(-1).tolist(),
            }
        )

    if not scene_nodes or total == 0:
        raise SceneError("cannot export a KHR_gaussian_splatting scene with zero gaussians")

    if camera is not None:
        persp = {"yfov": camera.yfov_radians or 0.7853981633974483, "znear": camera.znear or 0.1}
        if camera.zfar is not None:
            persp["zfar"] = camera.zfar
        cameras_json.append({"name": camera.name, "type": "perspective", "perspective": persp})
        node_index = len(nodes)
        scene_nodes.append(node_index)
        nodes.append(
            {
                "name": camera.name,
                "camera": len(cameras_json) - 1,
                "matrix": np.asarray(camera.transform, np.float32).T.reshape(-1).tolist(),
            }
        )

    while len(binary) % 4:
        binary.append(0)

    buffer = {"byteLength": len(binary)}
    if data_uri:
        buffer["uri"] = "data:application/octet-stream;base64," + base64.b64encode(bytes(binary)).decode("ascii")
    root = {
        "asset": {"version": "2.0"},
        "extensionsUsed": [KHR_EXTENSION],
        "buffers": [buffer],
        "bufferViews": buffer_views,
        "accessors": accessors,
        "meshes": meshes,
        "nodes": nodes,
        "scene": 0,
        "scenes": [{"nodes": scene_nodes}],
    }
    if cameras_json:
        root["cameras"] = cameras_json
    return json.dumps(root).encode("utf-8"), bytes(binary)


def encode_khr_gaussian_scene_gltf_bytes(
    clouds,  # list of SceneCloud (or (name, cloud, transform) tuples)
    camera: Optional[SceneCamera] = None,
) -> bytes:
    """A .gltf with its buffer as a base64 data URI (scene.rs:766-1088)."""
    return _encode_scene(clouds, camera, data_uri=True)[0]


def encode_khr_gaussian_scene_glb_bytes(clouds, camera: Optional[SceneCamera] = None) -> bytes:
    """GLB container: JSON chunk references chunk-0 binary instead of a data
    URI (scene.rs:1041-1088)."""
    json_bytes, binary = _encode_scene(clouds, camera, data_uri=False)
    json_bytes += b" " * ((4 - len(json_bytes) % 4) % 4)
    bin_bytes = binary + b"\x00" * ((4 - len(binary) % 4) % 4)

    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    out = bytearray()
    out.extend(struct.pack("<III", 0x46546C67, 2, total))
    out.extend(struct.pack("<II", len(json_bytes), 0x4E4F534A))
    out.extend(json_bytes)
    out.extend(struct.pack("<II", len(bin_bytes), 0x004E4942))
    out.extend(bin_bytes)
    return bytes(out)


def write_khr_gaussian_scene_glb(clouds, path: str, camera=None) -> int:
    data = encode_khr_gaussian_scene_glb_bytes(clouds, camera)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def write_khr_gaussian_scene_gltf(clouds, path: str, camera=None) -> int:
    data = encode_khr_gaussian_scene_gltf_bytes(clouds, camera)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
