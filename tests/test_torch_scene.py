"""The port's KHR_gaussian_splatting scene IO (``io/scene.py``) and scene
rendering (``render/scene.py``) against the JAX package's.

Every case of ``tests/test_scene.py``'s ``TestRoundTrip`` and
``TestValidation`` runs against the port; the bytes the port writes are the
JAX package's for the same clouds and camera; both packages decode the same
bytes array-equal, normalised i8 / i16 / u8 / u16 accessors, byteStride,
side files and the COLOR_0 fallback included.  ``render_scene`` (two clouds
with model transforms, far to near) is held within 2e-5 of JAX's on the
CPU, the scene camera's matrices and the orbit within 1e-6.
"""

import base64
import dataclasses
import json

import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
import torch_port_cases as cases
from bevy_gaussian_splatting_tpu.io import scene as jscene
from bevy_gaussian_splatting_tpu.render import scene as jrender_scene
from bevy_gaussian_splatting_tpu_torch.io.loader import load_any
from bevy_gaussian_splatting_tpu_torch.io.scene import (
    GaussianScene,
    SceneCamera,
    SceneCloud,
    SceneError,
    encode_khr_gaussian_scene_glb_bytes,
    encode_khr_gaussian_scene_gltf_bytes,
    load_khr_gaussian_scene,
    write_khr_gaussian_scene_glb,
)
from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, cloud_to_numpy, random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianColorSpace
from bevy_gaussian_splatting_tpu_torch.render.scene import (
    camera_from_scene,
    corrected_scene_camera_transform,
    orbit_from_scene_camera,
    render_scene,
)

IMAGE_BAR = 2e-5
CAMERA_BAR = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scene_clouds(n=16, seed=0, name="cloud", transform=None, arrays=None):
    """One cloud as a SceneCloud in each package: (jax, port)."""
    a = arrays if arrays is not None else random_arrays_3d_seeded(n, seed=seed)
    t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(transform, np.float32)
    return (
        jscene.SceneCloud(name=name, cloud=cases.jax_cloud(a), transform=t, settings=bgs.CloudSettings(),
                          extension={}),
        SceneCloud(name=name, cloud=cloud_from_numpy(a, "cpu"), transform=t, settings=CloudSettings(),
                   extension={}),
    )


def cameras_of(transform, name="c", yfov=0.8):
    t = np.asarray(transform, np.float32)
    return (jscene.SceneCamera(name=name, transform=t, yfov_radians=yfov, znear=0.1, zfar=100.0),
            SceneCamera(name=name, transform=t, yfov_radians=yfov, znear=0.1, zfar=100.0))


def assert_scenes_equal(jax_scene, port_scene):
    """The same clouds (arrays equal), transforms, settings and cameras."""
    assert len(port_scene.clouds) == len(jax_scene.clouds)
    assert len(port_scene.cameras) == len(jax_scene.cameras)
    for j, t in zip(jax_scene.clouds, port_scene.clouds):
        assert t.name == j.name and t.extension == j.extension
        assert t.settings.color_space.name == j.settings.color_space.name
        np.testing.assert_array_equal(t.transform, j.transform)
        got = cloud_to_numpy(t.cloud)
        for f in dataclasses.fields(j.cloud):
            np.testing.assert_array_equal(got[f.name], np.asarray(getattr(j.cloud, f.name)), err_msg=f.name)
    for j, t in zip(jax_scene.cameras, port_scene.cameras):
        assert (t.name, t.yfov_radians, t.znear, t.zfar) == (j.name, j.yfov_radians, j.znear, j.zfar)
        np.testing.assert_array_equal(t.transform, j.transform)


class TestRoundTrip:
    """``tests/test_scene.py`` ``TestRoundTrip`` on the port, each file also
    byte-equal to the JAX package's and decoded by it array-equal."""

    def _assert_cloud_roundtrip(self, a, b, atol=1e-5):
        a, b = cloud_to_numpy(a), cloud_to_numpy(b)
        np.testing.assert_allclose(b["position_visibility"][:, :3], a["position_visibility"][:, :3], atol=atol)
        qa = a["rotation"] / np.linalg.norm(a["rotation"], axis=1, keepdims=True)
        np.testing.assert_allclose(b["rotation"], qa, atol=atol)
        np.testing.assert_allclose(b["scale_opacity"][:, :3], a["scale_opacity"][:, :3], rtol=1e-4)
        np.testing.assert_allclose(b["scale_opacity"][:, 3], a["scale_opacity"][:, 3], atol=atol)
        np.testing.assert_allclose(b["spherical_harmonic"], a["spherical_harmonic"], atol=atol)

    def _both(self, data: bytes):
        port = load_khr_gaussian_scene(data, device="cpu")
        assert_scenes_equal(jscene.load_khr_gaussian_scene(data), port)
        return port

    def test_gltf_roundtrip(self):
        jsc, sc = scene_clouds()
        data = encode_khr_gaussian_scene_gltf_bytes([sc])
        assert data == jscene.encode_khr_gaussian_scene_gltf_bytes([jsc])
        scene = self._both(data)
        assert len(scene) == 1
        self._assert_cloud_roundtrip(sc.cloud, scene.clouds[0].cloud)

    def test_glb_roundtrip_with_camera_and_transform(self):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [1.0, 2.0, 3.0]
        jsc, sc = scene_clouds(transform=t)
        jcam, cam = cameras_of(t, name="export_camera")
        data = encode_khr_gaussian_scene_glb_bytes([sc], cam)
        assert data[:4] == b"glTF"
        assert data == jscene.encode_khr_gaussian_scene_glb_bytes([jsc], jcam)
        scene = self._both(data)
        assert len(scene) == 1
        self._assert_cloud_roundtrip(sc.cloud, scene.clouds[0].cloud)
        np.testing.assert_allclose(scene.clouds[0].transform, t, atol=1e-6)
        assert len(scene.cameras) == 1 and scene.cameras[0].name == "export_camera"
        assert abs(scene.cameras[0].yfov_radians - 0.8) < 1e-6
        np.testing.assert_allclose(scene.cameras[0].transform, t, atol=1e-6)

    def test_multi_cloud_scene(self):
        pairs = [scene_clouds(8, seed=i, name=f"c{i}") for i in range(3)]
        data = encode_khr_gaussian_scene_glb_bytes([p[1] for p in pairs])
        assert data == jscene.encode_khr_gaussian_scene_glb_bytes([p[0] for p in pairs])
        assert len(self._both(data)) == 3

    def test_export_empty_raises(self):
        with pytest.raises(SceneError):
            encode_khr_gaussian_scene_gltf_bytes([])

    def test_zero_rotation_gaussians_dropped_on_export(self):
        a = random_arrays_3d_seeded(4, seed=0)
        a["rotation"][1] = 0.0  # invalid rotation dropped at export (scene.rs:800-860)
        jsc, sc = scene_clouds(arrays=a)
        data = encode_khr_gaussian_scene_gltf_bytes([sc])
        assert data == jscene.encode_khr_gaussian_scene_gltf_bytes([jsc])
        assert len(self._both(data).clouds[0].cloud) == 3

    def test_loader_dispatch_glb(self, tmp_path):
        _, sc = scene_clouds()
        p = str(tmp_path / "scene.glb")
        assert write_khr_gaussian_scene_glb([sc], p) > 0
        scene = load_any(p, device="cpu")
        assert len(scene) == 1 and scene.clouds[0].cloud.device == torch.device("cpu")


class TestValidation:
    """``tests/test_scene.py`` ``TestValidation`` on the port: the same
    ``SceneError`` as the JAX package."""

    def _root(self):
        return json.loads(encode_khr_gaussian_scene_gltf_bytes([scene_clouds()[1]]))

    def _raises(self, root, match):
        data = json.dumps(root).encode()
        with pytest.raises(SceneError, match=match):
            load_khr_gaussian_scene(data, device="cpu")
        with pytest.raises(jscene.SceneError, match=match):
            jscene.load_khr_gaussian_scene(data)

    def test_mode_must_be_points(self):
        root = self._root()
        root["meshes"][0]["primitives"][0]["mode"] = 4
        self._raises(root, "mode must be POINTS")

    def test_extension_must_be_listed(self):
        root = self._root()
        root["extensionsUsed"] = []
        self._raises(root, "extensionsUsed")

    def test_missing_required_attribute(self):
        root = self._root()
        del root["meshes"][0]["primitives"][0]["attributes"]["KHR_gaussian_splatting:OPACITY"]
        self._raises(root, "OPACITY")

    def test_partial_sh_degree_rejected(self):
        root = self._root()
        del root["meshes"][0]["primitives"][0]["attributes"]["KHR_gaussian_splatting:SH_DEGREE_1_COEF_1"]
        self._raises(root, "degree 1")


# ---------------------------------------------------------------------------
# Accessor decoding: normalised integers, byteStride, side files, COLOR_0
# ---------------------------------------------------------------------------

_CT = {np.int8: 5120, np.uint8: 5121, np.int16: 5122, np.uint16: 5123, np.float32: 5126}
_TYPE = {1: "SCALAR", 3: "VEC3", 4: "VEC4"}


def hand_gltf(rot_dtype, scale_dtype, scale_normalized, opacity_dtype, color_dtype, stride_pad=0, n=24,
              side_file=None, sh=False):
    """A one-primitive glTF whose accessors hold the given component types
    (``np.float32`` or normalised integers), the rotation accessor with
    ``stride_pad`` bytes between its items (byteStride), the buffer as a data
    URI or in ``side_file``."""
    rng = np.random.default_rng(5)
    binary, views, accessors, attributes = bytearray(), [], [], {}

    def push(name, values, dtype, normalized=False, pad=0):
        values = np.asarray(values).astype(dtype).reshape(n, -1)
        comps = values.shape[1]
        item = np.dtype(dtype).itemsize * comps
        while len(binary) % 4:
            binary.append(0)
        view = {"buffer": 0, "byteOffset": len(binary), "byteLength": (item + pad) * n}
        for row in values:
            binary.extend(row.tobytes() + b"\0" * pad)
        if pad:
            view["byteStride"] = item + pad
        views.append(view)
        acc = {"bufferView": len(views) - 1, "componentType": _CT[dtype], "count": n, "type": _TYPE[comps]}
        if normalized:
            acc["normalized"] = True
        accessors.append(acc)
        attributes[name] = len(accessors) - 1

    def ints(dtype, shape, lo=None):
        info = np.iinfo(dtype)
        return rng.integers(info.min if lo is None else lo, info.max, shape, endpoint=True)

    push("POSITION", rng.normal(size=(n, 3)), np.float32)
    rot = rng.normal(size=(n, 4)) if rot_dtype == np.float32 else ints(rot_dtype, (n, 4))
    rot[3] = 0  # a zero quaternion decodes to the identity
    push("KHR_gaussian_splatting:ROTATION", rot, rot_dtype, rot_dtype != np.float32, stride_pad)
    scale = rng.normal(size=(n, 3)) if scale_dtype == np.float32 else \
        (ints(scale_dtype, (n, 3)) if scale_normalized else rng.integers(-3, 3, (n, 3)))
    push("KHR_gaussian_splatting:SCALE", scale, scale_dtype, scale_normalized)
    opacity = rng.uniform(0, 1, n) if opacity_dtype == np.float32 else ints(opacity_dtype, n, lo=0)
    push("KHR_gaussian_splatting:OPACITY", opacity, opacity_dtype, opacity_dtype != np.float32)
    if sh:
        for c in range(4):
            d = int(np.floor(np.sqrt(c)))
            push(f"KHR_gaussian_splatting:SH_DEGREE_{d}_COEF_{c - d * d}", rng.normal(size=(n, 3)), np.float32)
    else:
        color = rng.uniform(0, 1, (n, 4)) if color_dtype == np.float32 else ints(color_dtype, (n, 4), lo=0)
        push("COLOR_0", color, color_dtype, color_dtype != np.float32)
    while len(binary) % 4:
        binary.append(0)
    buffer = {"byteLength": len(binary)}
    if side_file is None:
        buffer["uri"] = "data:application/octet-stream;base64," + base64.b64encode(bytes(binary)).decode()
    else:
        side_file.write_bytes(bytes(binary))
        buffer["uri"] = side_file.name
    root = {
        "asset": {"version": "2.0"}, "extensionsUsed": ["KHR_gaussian_splatting"], "buffers": [buffer],
        "bufferViews": views, "accessors": accessors,
        "meshes": [{"primitives": [{"attributes": attributes, "mode": 0, "extensions": {
            "KHR_gaussian_splatting": {"colorSpace": "lin_rec709_display"}}}]}],
        "nodes": [{"name": "root", "children": [1], "translation": [1.0, 0.0, 0.0]},
                  {"name": "n", "mesh": 0, "rotation": [0.0, 0.38268343, 0.0, 0.92387953], "scale": [2, 2, 2]}],
        "scenes": [{"nodes": [0]}],
    }
    return json.dumps(root).encode()


ACCESSOR_CASES = {
    "i8-i8n-u8": (np.int8, np.int8, True, np.uint8, np.uint8, 0),
    "i16-i16raw-u16": (np.int16, np.int16, False, np.uint16, np.uint16, 0),
    "i8-i8raw-f32-stride": (np.int8, np.int8, False, np.float32, np.float32, 4),
    "i16-i16n-u8-stride": (np.int16, np.int16, True, np.uint8, np.uint16, 2),
    "f32-f32-u16": (np.float32, np.float32, False, np.uint16, np.uint8, 0),
}


@pytest.mark.parametrize("case", list(ACCESSOR_CASES))
def test_normalized_accessors_decode_as_jax(case):
    data = hand_gltf(*ACCESSOR_CASES[case])
    port = load_khr_gaussian_scene(data, device="cpu")
    assert_scenes_equal(jscene.load_khr_gaussian_scene(data), port)
    sc = port.clouds[0]
    assert sc.settings.color_space == GaussianColorSpace.LIN_REC709_DISPLAY
    np.testing.assert_array_equal(cloud_to_numpy(sc.cloud)["rotation"][3], [1.0, 0.0, 0.0, 0.0])
    assert np.abs(cloud_to_numpy(sc.cloud)["spherical_harmonic"][:, 3:]).max() == 0  # COLOR_0: degree 0


@pytest.mark.parametrize("sh_degree", [3, None, 0])
def test_side_file_and_sh_degree_as_jax(tmp_path, sh_degree):
    """A .gltf whose buffer is a side file, read from its path; the SH
    storage degree given, or the file's own (``None``, capped at 3)."""
    data = hand_gltf(np.float32, np.float32, False, np.float32, np.float32, side_file=tmp_path / "s.bin", sh=True)
    path = tmp_path / "s.gltf"
    path.write_bytes(data)
    port = load_khr_gaussian_scene(str(path), sh_degree=sh_degree, device="cpu")
    assert_scenes_equal(jscene.load_khr_gaussian_scene(str(path), sh_degree=sh_degree), port)
    width = {3: 48, None: 12, 0: 4}[sh_degree]
    assert port.clouds[0].cloud.spherical_harmonic.shape == (24, width)
    with pytest.raises(SceneError, match="external file"):
        load_khr_gaussian_scene(data, device="cpu")


# ---------------------------------------------------------------------------
# render/scene.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_cloud_scene():
    """A GLB of two bench-style clouds, the second moved towards the camera,
    and a camera at (0, 0, 60), loaded by both packages."""
    near = np.eye(4, dtype=np.float32)
    near[:3, 3] = [3.0, -2.0, 10.0]
    pairs = [
        scene_clouds(arrays=cases.cloud_arrays("bench", 256, seed=21), name="far"),
        scene_clouds(arrays=cases.cloud_arrays("bench", 256, seed=22), name="near", transform=near),
    ]
    cam_t = np.eye(4, dtype=np.float32)
    cam_t[:3, 3] = [0.0, 0.0, 60.0]
    jcam, cam = cameras_of(cam_t, yfov=float(np.pi / 4))
    data = encode_khr_gaussian_scene_glb_bytes([p[1] for p in pairs], cam)
    return jscene.load_khr_gaussian_scene(data), load_khr_gaussian_scene(data, device="cpu")


def _jax_serving_render(cloud, camera, settings, model_transform=None, background=None, impl="auto"):
    """The JAX package's serving frame run eagerly, as ``tests/test_torch_render.py``
    holds the port to it: ``render_tiled(compositor="pallas",
    differentiable=False)`` at ``render()``'s budget.  JAX's ``render()``
    jits the same frame, and XLA's fused multiply-adds move the OBB edges that
    rounding decides (up to 2.6e-2 at a pixel on such a scene at 64x48)."""
    from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt

    bucket = jrt.pairs_budget(len(cloud), int(jrt.pair_count(cloud, camera, settings, model_transform)))
    return jrt.render_tiled(cloud, camera, settings, model_transform, background, differentiable=False,
                            compositor="pallas", pairs_max=bucket)


def test_render_scene_matches_jax(two_cloud_scene, monkeypatch):
    """Two clouds far to near, each with its model transform, over a solid
    background: within 2e-5 of JAX's ``render_scene`` with each frame the
    eager serving path; the port's image is its two ``render()`` calls
    chained by hand, bitwise."""
    import jax.numpy as jnp

    from bevy_gaussian_splatting_tpu_torch.render.api import render

    monkeypatch.setattr(jrender_scene, "render", _jax_serving_render)
    jax_scene, port_scene = two_cloud_scene
    width, height = 48, 32
    jcam = jrender_scene.camera_from_scene(jax_scene, width, height)
    cam = camera_from_scene(port_scene, width, height, device="cpu")
    bg = np.array([0.05, 0.1, 0.2, 1.0], np.float32)
    want = np.asarray(jrender_scene.render_scene(jax_scene, jcam, background=jnp.asarray(bg)))
    got = render_scene(port_scene, cam, background=torch.from_numpy(bg), device="cpu")
    assert got.shape == (height, width, 4)
    err = float(np.abs(_np(got) - want).max())
    assert err <= IMAGE_BAR, err
    far, near = port_scene.clouds
    by_hand = render(near.cloud, cam, near.settings, torch.from_numpy(near.transform),
                     render(far.cloud, cam, far.settings, torch.from_numpy(far.transform), torch.from_numpy(bg),
                            device="cpu"), device="cpu")
    assert torch.equal(got, by_hand)
    lit = int((np.abs(want[..., :3] - bg[:3]).max(axis=-1) > 1e-3).sum())
    assert lit > width * height // 10


def test_render_scene_without_clouds_is_the_background(two_cloud_scene):
    _, port_scene = two_cloud_scene
    cam = camera_from_scene(port_scene, 32, 16, device="cpu")
    empty = GaussianScene(clouds=[], cameras=[])
    np.testing.assert_array_equal(_np(render_scene(empty, cam, device="cpu")), np.zeros((16, 32, 4), np.float32))
    bg = torch.rand(16, 32, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(render_scene(empty, cam, background=bg, device="cpu"), bg)
    assert camera_from_scene(empty) is None and orbit_from_scene_camera(empty, 6.0) is None


def _rot_x(angle):
    c, s = np.cos(angle), np.sin(angle)
    r = np.eye(4)
    r[1, 1], r[1, 2], r[2, 1], r[2, 2] = c, -s, s, c
    return r


POSES = {
    "upright": np.array([[1, 0, 0, 0], [0, 1, 0, 1], [0, 0, 1, 5], [0, 0, 0, 1]], np.float64),
    "upside-down": np.array([[-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 5], [0, 0, 0, 1]], np.float64),
    "tilted": _rot_x(0.4) + np.array([[0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 0, 8], [0, 0, 0, 0]]),
    "tilted-down": _rot_x(-0.3) + np.array([[0, 0, 0, 0.5], [0, 0, 0, 1.5], [0, 0, 0, 7], [0, 0, 0, 0]]),
}


@pytest.mark.parametrize("pose", list(POSES))
def test_scene_camera_adoption_matches_jax(pose):
    """``corrected_scene_camera_transform``, ``camera_from_scene``'s matrices
    and ``orbit_from_scene_camera`` within 1e-6 of JAX's; the upside-down
    camera is flipped upright with the same look direction
    (``tests/test_scene.py:223``)."""
    jsc, sc = scene_clouds()
    jcam, cam = cameras_of(POSES[pose])
    data = encode_khr_gaussian_scene_glb_bytes([sc], cam)
    jax_scene, port_scene = jscene.load_khr_gaussian_scene(data), load_khr_gaussian_scene(data, device="cpu")

    got = corrected_scene_camera_transform(port_scene.cameras[0])
    np.testing.assert_allclose(got, jrender_scene.corrected_scene_camera_transform(jax_scene.cameras[0]),
                               atol=CAMERA_BAR)
    rot = got[:3, :3]
    assert rot[:, 1] @ [0.0, 1.0, 0.0] > 0.0
    np.testing.assert_allclose(-rot[:, 2], -POSES[pose][:3, 2], atol=1e-6)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-6)

    tc = camera_from_scene(port_scene, 96, 64, device="cpu")
    jc = jrender_scene.camera_from_scene(jax_scene, 96, 64)
    for name in ("view_from_world", "clip_from_view", "prev_clip_from_world", "viewport", "world_position"):
        np.testing.assert_allclose(_np(getattr(tc, name)), np.asarray(getattr(jc, name)), rtol=CAMERA_BAR,
                                   atol=CAMERA_BAR, err_msg=name)
    assert (tc.width, tc.height) == (96, 64)

    got_orbit = orbit_from_scene_camera(port_scene, 6.0)
    want_orbit = jrender_scene.orbit_from_scene_camera(jax_scene, 6.0)
    np.testing.assert_allclose(got_orbit[:3], want_orbit[:3], atol=CAMERA_BAR)
    np.testing.assert_allclose(got_orbit[3], want_orbit[3], atol=CAMERA_BAR)
