"""The port's cloud IO (bevy_gaussian_splatting_tpu_torch/io/) against the JAX
package's: PLY, ``.gcloud`` / ``.gc4d`` in FlexBuffers (the port's own codec,
``io/flexbuffers.py``) and bincode2, ``.npz`` and the loader.  Every file is
written here, by one package or the other, from clouds drawn from a seed;
each side decodes the other's bytes.  The bar is array equality: the
codecs are lossless, and each PLY decoder is held to its counterpart (the
port's native decoder to the JAX package's C++ one, built from the same
source with the same flags; numpy to numpy).  ``tests/test_torch_native.py``
holds the native module itself.
"""

import threading
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import torch_port_cases as cases
from bevy_gaussian_splatting_tpu.io import bincode2 as jbin
from bevy_gaussian_splatting_tpu.io import gcloud as jgc
from bevy_gaussian_splatting_tpu.io import loader as jloader
from bevy_gaussian_splatting_tpu.io import ply as jply
from bevy_gaussian_splatting_tpu.models.cloud import precompute_covariance_3d as jax_precompute
from bevy_gaussian_splatting_tpu_torch.io import bincode2 as tbin
from bevy_gaussian_splatting_tpu_torch.io import flexbuffers
from bevy_gaussian_splatting_tpu_torch.io import gcloud as tgc
from bevy_gaussian_splatting_tpu_torch.io import loader as tloader
from bevy_gaussian_splatting_tpu_torch.io import ply as tply
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    cloud_from_numpy,
    cloud_to_numpy,
    random_arrays_3d_seeded,
    random_arrays_4d_seeded,
)
from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer, render

def jax_arrays(cloud) -> dict:
    import dataclasses

    return {f.name: np.asarray(getattr(cloud, f.name)) for f in dataclasses.fields(cloud)}


def assert_same(jax_cloud, port_cloud):
    """Array-equal field by field, the same cloud class."""
    assert type(port_cloud).__name__ == type(jax_cloud).__name__
    want, got = jax_arrays(jax_cloud), cloud_to_numpy(port_cloud)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def cov_arrays(arrays: dict) -> dict:
    """A precomputed-covariance cloud's arrays, computed by the JAX package."""
    return jax_arrays(jax_precompute(cases.jax_cloud(arrays)))


@pytest.fixture(scope="module")
def clouds():
    """The same clouds in both packages: 3D (degree 3, and degree 1), 4D and
    precomputed covariance (built from the 3D cloud by the JAX package)."""
    a3 = random_arrays_3d_seeded(300, seed=11)
    a3["position_visibility"][::7, 3] = 0.25  # visibility that is not 1
    a1 = random_arrays_3d_seeded(64, seed=12, sh_degree=1)
    a4 = random_arrays_4d_seeded(200, seed=13)
    ac = cov_arrays(a3)
    return {k: (cases.jax_cloud(a), cloud_from_numpy(a, "cpu")) for k, a in
            (("3d", a3), ("3d-sh1", a1), ("4d", a4), ("cov3d", ac))}


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------


def ply_bytes(n=6, seed=0, fmt="binary", type_name="float", n_rest=45):
    """An INRIA-style 3DGS PLY with raw (pre-activation) values."""
    rng = np.random.default_rng(seed)
    cols = {k: rng.normal(size=n).astype(np.float32) for k in ("x", "y", "z")}
    for i in range(3):
        cols[f"f_dc_{i}"] = rng.normal(size=n).astype(np.float32)
    for i in range(n_rest):
        cols[f"f_rest_{i}"] = rng.normal(size=n).astype(np.float32)
    for i in range(3):
        cols[f"scale_{i}"] = rng.normal(size=n).astype(np.float32)
    cols["opacity"] = rng.normal(size=n).astype(np.float32)
    for i in range(4):
        cols[f"rot_{i}"] = rng.normal(size=n).astype(np.float32)
    names = list(cols)
    header = (
        f"ply\nformat {'binary_little_endian' if fmt == 'binary' else 'ascii'} 1.0\n"
        f"element vertex {n}\n" + "".join(f"property {type_name} {p}\n" for p in names) + "end_header\n"
    ).encode()
    rows = np.stack([cols[p] for p in names], axis=1)
    if fmt == "binary":
        body = rows.astype("<f4").tobytes()
    else:
        body = "\n".join(" ".join(f"{v:.9g}" for v in r) for r in rows).encode() + b"\n"
    return header + body, cols


# (id, ply_bytes kwargs, parse kwargs)
PLY_CASES = [
    ("binary", {}, {}),
    ("binary-loose", {}, {"strict_reference": False}),
    ("ascii", {"fmt": "ascii"}, {}),
    ("float32-spelling", {"type_name": "float32"}, {}),
    ("pad-32", {"n": 32}, {}),
    ("sh-truncate-1", {}, {"sh_degree": 1}),
    ("sh-extend-4", {}, {"sh_degree": 4}),
    ("sh-infer-degree-1", {"n_rest": 9}, {}),
    ("sh-degree-0", {"n_rest": 0}, {}),
]


@pytest.mark.parametrize("make,kw", [c[1:] for c in PLY_CASES], ids=[c[0] for c in PLY_CASES])
def test_ply_3d_matches_jax(make, kw):
    """Each package's default (the native decoder; numpy for ASCII, which
    the native reader refuses) array-equal to the other's, and the numpy
    decoders array-equal to each other."""
    data, _ = ply_bytes(**make)
    before = dict(tply.parse_ply_3d.paths)
    port = tply.parse_ply_3d(data, device="cpu", **kw)
    path = "native" if make.get("fmt", "binary") == "binary" else "numpy"
    assert tply.parse_ply_3d.paths[path] == before[path] + 1
    assert_same(jply.parse_ply_3d(data, use_native=True, **kw), port)
    assert len(port) == make.get("n", 6) + 32 - make.get("n", 6) % 32
    assert_same(jply.parse_ply_3d(data, use_native=False, **kw),
                tply.parse_ply_3d(data, use_native=False, device="cpu", **kw))


def test_ply_reference_collision_and_missing_property():
    """The reference's channel = i / 16 quirk: f_rest_0 and f_rest_15 both
    land on slot 3 and the later wins; the correct mapping keeps f_rest_0.
    A missing required property raises in both packages."""
    data, cols = ply_bytes(n=3)
    strict = cloud_to_numpy(tply.parse_ply_3d(data, device="cpu"))["spherical_harmonic"]
    loose = cloud_to_numpy(tply.parse_ply_3d(data, strict_reference=False, device="cpu"))["spherical_harmonic"]
    np.testing.assert_array_equal(strict[:3, 3], cols["f_rest_15"])
    np.testing.assert_array_equal(loose[:3, 3], cols["f_rest_0"])
    bad = data.replace(b"property float rot_3\n", b"property float qq_3\n")
    for use_native in (True, False):
        with pytest.raises(ValueError, match="missing required"):
            tply.parse_ply_3d(bad, use_native=use_native, device="cpu")
        with pytest.raises(ValueError, match="missing required"):
            jply.parse_ply_3d(bad, use_native=use_native)


def ply_4d_bytes(n=5, seed=1):
    rng = np.random.default_rng(seed)
    names = ["x", "y", "z", "t", "st", "sx", "sy", "sz", "opacity",
             "rot_x", "rot_y", "rot_z", "rot_w", "rot_r_x", "rot_r_y", "rot_r_z", "rot_r_w"]
    names += [f"feat_{ch}_{i}" for ch in "rgb" for i in range(48)]
    rows = rng.normal(size=(n, len(names))).astype("<f4")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "".join(f"property float {p}\n" for p in names) + "end_header\n"
    ).encode()
    return header + rows.tobytes()


def test_ply_4d_and_writers_match_jax(clouds):
    """parse_ply_4d array-equal to JAX's; write_ply_3d byte-equal to JAX's;
    write_ply_4d (the port's own) read by JAX's parse_ply_4d as the port
    reads it, and the round trips."""
    data4 = ply_4d_bytes()
    assert_same(jply.parse_ply_4d(data4), tply.parse_ply_4d(data4, device="cpu"))

    for key in ("3d", "3d-sh1"):
        jc, tc = clouds[key]
        written = tply.write_ply_3d(tc)
        assert written == jply.write_ply_3d(jc)
        back = cloud_to_numpy(tply.parse_ply_3d(written, strict_reference=False, device="cpu"))
        np.testing.assert_allclose(back["position_visibility"][:len(tc)], cloud_to_numpy(tc)["position_visibility"])

    jc4, tc4 = clouds["4d"]
    written4 = tply.write_ply_4d(tc4)
    port4 = tply.parse_ply_4d(written4, device="cpu")
    assert_same(jply.parse_ply_4d(written4), port4)
    got, src = cloud_to_numpy(port4), cloud_to_numpy(tc4)
    n = len(tc4)
    assert len(port4) == n + 32 - n % 32
    for k in ("position_visibility", "spherindrical_harmonic", "scale_opacity", "timestamp_timescale"):
        np.testing.assert_array_equal(got[k][:n], src[k], err_msg=k)
    np.testing.assert_allclose(got["isotropic_rotations"][:n], src["isotropic_rotations"], atol=1e-6)


# ---------------------------------------------------------------------------
# .gcloud / .gc4d: FlexBuffers
# ---------------------------------------------------------------------------

PORT_ENCODE = {"3d": tgc.encode_gcloud_3d, "3d-sh1": tgc.encode_gcloud_3d, "4d": tgc.encode_gcloud_4d,
               "cov3d": lambda c, use_native: tgc.encode_gcloud_cov3d(c)}
PORT_DECODE = {"3d": tgc.decode_gcloud_3d, "3d-sh1": tgc.decode_gcloud_3d, "4d": tgc.decode_gcloud_4d,
               "cov3d": lambda d, device, use_native: tgc.decode_gcloud_cov3d(d, device)}
JAX_ENCODE = {"3d": jgc.encode_gcloud_3d, "3d-sh1": jgc.encode_gcloud_3d, "4d": jgc.encode_gcloud_4d,
              "cov3d": lambda c, use_native: jgc.encode_gcloud_cov3d(c)}
JAX_DECODE = {"3d": jgc.decode_gcloud_3d, "3d-sh1": jgc.decode_gcloud_3d, "4d": jgc.decode_gcloud_4d,
              "cov3d": lambda d, use_native: jgc.decode_gcloud_cov3d(d)}
KINDS = ("3d", "3d-sh1", "4d", "cov3d")


@pytest.mark.parametrize("kind", KINDS)
def test_gcloud_port_bytes_decode_in_jax(clouds, kind):
    """The bytes of both of the port's encoders (native, the default, and its
    own FlexBuffers writer) through JAX's Python decoder and, for 3D and 4D,
    its C++ one.  The native bytes are the C++ encoder's byte for byte in 3D
    and 4D; the port's writer's 3D bytes too (its 4D bytes differ in the
    order of the key strings only, which the C++ encoder does not sort)."""
    jc, tc = clouds[kind]
    for port_native in (True, False):
        data = PORT_ENCODE[kind](tc, use_native=port_native)
        for use_native in [False] + ([True] if kind != "cov3d" else []):
            got = JAX_DECODE[kind](data, use_native=use_native)
            want = cloud_to_numpy(tc)
            if kind == "cov3d":  # the file holds the covariance in f16 pairs
                want = cloud_to_numpy(tgc.decode_gcloud_cov3d(data, device="cpu"))
            for k, v in jax_arrays(got).items():
                np.testing.assert_array_equal(v, want[k], err_msg=f"{k} port native={port_native} native={use_native}")
        if kind.startswith("3d") or (kind == "4d" and port_native):
            assert data == JAX_ENCODE[kind](jc, use_native=True), port_native


@pytest.mark.parametrize("kind", KINDS)
def test_gcloud_jax_bytes_decode_in_port(clouds, kind):
    """Both of JAX's encoders (C++ and the flatbuffers Builder) read by the
    port's FlexBuffers reader array-equal to JAX's own decode: the C++ layout
    by the vectorised path, the Builder's (widths per vector) by the general
    one; and by the port's native decoder (the default; cov3d has no native
    path), counted in ``decode_paths``."""
    jc, _ = clouds[kind]
    for use_native in [False] + ([True] if kind != "cov3d" else []):
        data = JAX_ENCODE[kind](jc, use_native=use_native)
        want = JAX_DECODE[kind](data, use_native=False)
        before = dict(flexbuffers.read_columns.paths)
        assert_same(want, PORT_DECODE[kind](data, device="cpu", use_native=False))
        path = "vectorised" if use_native else "general"
        assert flexbuffers.read_columns.paths[path] == before[path] + 1, (use_native, flexbuffers.read_columns.paths)
        if kind != "cov3d":
            before = dict(tgc.decode_paths)
            assert_same(want, PORT_DECODE[kind](data, device="cpu", use_native=True))
            assert tgc.decode_paths["native"] == before["native"] + 1, tgc.decode_paths


@pytest.mark.parametrize("kind", KINDS)
def test_gcloud_vectorised_and_general_paths_agree(clouds, kind):
    _, tc = clouds[kind]
    data = PORT_ENCODE[kind](tc, use_native=False)  # the port's own writer
    spec = [(name, tgc._COLUMNS[name]) for name in flexbuffers.root_keys(data)]
    fast = flexbuffers.read_columns_vectorised(data, spec)
    slow = flexbuffers.read_columns_general(data, spec)
    assert fast.keys() == slow.keys()
    for name in fast:
        assert fast[name].dtype == slow[name].dtype
        np.testing.assert_array_equal(fast[name], slow[name], err_msg=name)
    assert tgc.gcloud_is_cov3d(data) == (kind == "cov3d")


def test_flexbuffers_rejects_malformed_data(clouds):
    """Truncated and foreign buffers raise ``ValueError`` through both
    decoders: the native reader checks every offset against the buffer and
    leaves what its probe refuses to the FlexBuffers reader."""
    _, tc = clouds["3d"]
    data = tgc.encode_gcloud_3d(tc)
    for bad in (data[:-100], data[: len(data) // 2] + b"\0\0", b"\x01\x02"):
        for use_native in (True, False):
            with pytest.raises(ValueError):
                tgc.decode_gcloud_3d(bad, device="cpu", use_native=use_native)
    assert not tgc.gcloud_is_cov3d(b"not a flexbuffer")


# ---------------------------------------------------------------------------
# bincode2 and npz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("3d", "3d-sh1", "4d"))
def test_bincode2_matches_jax(clouds, kind):
    """The raw payload byte-equal; compressed bytes decode array-equal both
    ways (gzip writes the time into its header, so those bytes are not held
    equal)."""
    jc, tc = clouds[kind]
    enc_t, dec_t = (tbin.encode_bincode_4d, tbin.decode_bincode_4d) if kind == "4d" else \
        (tbin.encode_bincode_3d, tbin.decode_bincode_3d)
    enc_j, dec_j = (jbin.encode_bincode_4d, jbin.decode_bincode_4d) if kind == "4d" else \
        (jbin.encode_bincode_3d, jbin.decode_bincode_3d)
    assert enc_t(tc, compress=False) == enc_j(jc, compress=False)
    assert_same(jc, dec_t(enc_j(jc), device="cpu"))
    assert_same(dec_j(enc_t(tc)), tc)
    assert_same(jc, dec_t(enc_j(jc, compress=False), device="cpu"))


@pytest.mark.parametrize("kind", ("3d", "4d", "cov3d"))
def test_npz_cross_read(clouds, kind):
    jc, tc = clouds[kind]
    assert_same(jc, tgc.decode_npz(jgc.encode_npz(jc), device="cpu"))
    assert_same(jgc.decode_npz(tgc.encode_npz(tc)), tc)


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

# (file name, cloud kind, save_cloud codec)
LOADER_CASES = [
    ("c.gcloud", "3d", "flexbuffers"),
    ("c.gcloud", "3d", "bincode2"),
    ("c.gcloud", "cov3d", "flexbuffers"),
    ("c.gc4d", "4d", "flexbuffers"),
    ("c.gc4d", "4d", "bincode2"),
    ("c.ply", "3d", "flexbuffers"),
    ("c.ply4d", "4d", "flexbuffers"),
    ("c.npz", "cov3d", "flexbuffers"),
]


def test_loader_dispatch_matches_jax(clouds, tmp_path):
    """``save_cloud`` then ``load_any`` by extension and codec sniff: the port
    loads each file as JAX's loader does, both at their defaults (the native
    decoders for ``.ply``, ``.gcloud`` and ``.gc4d``; the port's ``.ply4d``
    writer has no JAX counterpart; JAX reads its files)."""
    for name, kind, codec in LOADER_CASES:
        _, tc = clouds[kind]
        path = str(tmp_path / f"{kind}-{codec}-{name}")
        assert tloader.save_cloud(tc, path, codec=codec) > 0
        assert_same(jloader.load_cloud(path), tloader.load_any(path, device="cpu"))
    with pytest.raises(ValueError, match="unsupported cloud extension"):
        tloader.save_cloud(clouds["3d"][1], str(tmp_path / "c.xyz"))
    (tmp_path / "c.xyz").write_bytes(b"xyz")
    with pytest.raises(ValueError, match="unsupported cloud extension"):
        tloader.load_cloud(str(tmp_path / "c.xyz"), device="cpu")
    with pytest.raises(ValueError, match="flexbuffers codec"):
        tloader.save_cloud(clouds["cov3d"][1], str(tmp_path / "x.gcloud"), codec="bincode2")


@pytest.mark.parametrize("ext", [".ply", ".gcloud"])
def test_load_any_defaults_match_jax(tmp_path, ext):
    """A file the JAX package wrote at its defaults, 5,000 rows (the native
    PLY decoder runs threaded from 4,096), read by both packages' ``load_any``
    at their defaults: array-equal, and the port's read went through its
    native decoder."""
    a = random_arrays_3d_seeded(5000, seed=21)
    jc = cases.jax_cloud(a)
    path = str(tmp_path / f"c{ext}")
    with open(path, "wb") as f:
        f.write(jply.write_ply_3d(jc) if ext == ".ply" else jgc.encode_gcloud_3d(jc))
    counter = tply.parse_ply_3d.paths if ext == ".ply" else tgc.decode_paths
    before = counter["native"]
    port = tloader.load_any(path, device="cpu")
    assert counter["native"] == before + 1
    assert_same(jloader.load_any(path), port)


@pytest.mark.parametrize("text", [
    "https%3A%2F%2Fmitchell.mosure.me%2Ftrellis.glb", "trellis.glb", "aHR0cHM6Ly9leGFtcGxlLmNvbS9zY2VuZS5nY2xvdWQ=",
    "a%2", "%zz.ply", "/tmp/x%20y.ply", "abcd",
])
def test_resolve_input_matches_jax(text):
    """Percent and url-safe base64 forms (viewer/viewer.rs:84-137) and the
    strings both leave alone; ``is_url``."""
    assert tloader.resolve_input(text) == jloader.resolve_input(text)
    assert tloader.is_url(tloader.resolve_input(text)) == jloader.is_url(jloader.resolve_input(text))


@pytest.fixture
def http_dir(tmp_path):
    """A local HTTP server on 127.0.0.1 over ``tmp_path / "www"``."""
    root = tmp_path / "www"
    root.mkdir()
    server = ThreadingHTTPServer(("127.0.0.1", 0), partial(SimpleHTTPRequestHandler, directory=str(root)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield root, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_load_from_http_with_cache(clouds, http_dir, tmp_path, monkeypatch):
    """``load_any`` of a URL and of its base64 form, a cloud and a GLB scene;
    with ``BGS_ASSET_CACHE`` the second load reads the cache (the file is
    gone from the server by then)."""
    import base64

    from bevy_gaussian_splatting_tpu_torch.io.scene import SceneCloud, write_khr_gaussian_scene_glb
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings

    root, base = http_dir
    jc, tc = clouds["3d"]
    tloader.save_cloud(tc, str(root / "c.gcloud"))
    write_khr_gaussian_scene_glb([SceneCloud("c", tc, np.eye(4, dtype=np.float32), CloudSettings(), {})],
                                 str(root / "s.glb"))
    monkeypatch.setenv("BGS_ASSET_CACHE", str(tmp_path / "cache"))
    url = f"{base}/c.gcloud"
    assert_same(jc, tloader.load_any(url, device="cpu"))
    scene = tloader.load_any(base64.urlsafe_b64encode(f"{base}/s.glb".encode()).decode(), device="cpu")
    assert len(scene) == 1 and len(scene.clouds[0].cloud) == len(tc)
    (root / "c.gcloud").unlink()
    (root / "s.glb").unlink()
    assert_same(jc, tloader.load_any(url, device="cpu"))
    assert len(tloader.load_scene(f"{base}/s.glb", device="cpu")) == 1
    assert len(list((tmp_path / "cache").iterdir())) == 2


def test_interactive_renderer_takes_a_cloud_loaded_on_its_device(clouds, tmp_path):
    """A cloud loaded with ``device=renderer.device`` is served as it is, and
    ``render()`` takes it without a move (the same tensors); a cloud on
    another device is refused."""
    _, tc = clouds["3d"]
    path = str(tmp_path / "c.gcloud")
    tloader.save_cloud(tc, path)
    r = InteractiveRenderer(device="cpu")
    cloud = tloader.load_any(path, device=r.device)
    assert cloud.device == r.device
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=64, height=64, device="cpu")
    img = r.render(cloud, cam)
    assert img.shape == (64, 64, 4) and bool(torch.isfinite(img).all())
    torch.testing.assert_close(img, render(tc, cam, device="cpu"), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="lies on meta"):
        r.render(cloud.to("meta"), cam)
