"""PyTorch port, the browser viewer (``viewer/serve.py``) on the CPU.

In process, the port's ``ViewerState`` against the JAX package's on the same
scene, both built by ``build_state_from_args`` from the same CLI arguments
and both pinned to ``period_floor_ms=1e9`` (one bin, then replays): the PNG
frames along an orbit within tests/test_torch_serve.py's orbit bars (mean
< 1e-3, 99.5% of pixels within 1e-2, on the decoded u8 images), the
renderers' ``stats`` equal, and the selection routes' counts and files
equal.  Over HTTP, a server on port 0 in a thread serves every route,
including a streaming scene and the gallery that the port's ``build_www``
builds, where ``/example/<id>`` switches the live scene."""

import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from bevy_gaussian_splatting_tpu.render import api as japi
from bevy_gaussian_splatting_tpu.viewer import headless as jheadless
from bevy_gaussian_splatting_tpu.viewer import serve as jserve
from bevy_gaussian_splatting_tpu_torch.io.loader import load_any, load_cloud
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.render import api as tapi
from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer
from bevy_gaussian_splatting_tpu_torch.stream import slice_cloud
from bevy_gaussian_splatting_tpu_torch.stream.scene import save_streaming_scene
from bevy_gaussian_splatting_tpu_torch.tools import build_www
from bevy_gaussian_splatting_tpu_torch.utils.image import decode_png
from bevy_gaussian_splatting_tpu_torch.viewer import headless, serve
from torch_port_cases import torch_cloud

SCENE_ARGS = ["--gaussian-count", "1024", "--seed", "0", "--eye", "0", "0", "60", "--width", "64", "--height", "64"]
POSES = [(0.0, 0.3, 60.0), (0.15, 0.3, 60.0), (0.4, 0.25, 55.0), (-0.3, 0.35, 62.0)]
# (az, el, r, x0, y0, x1, y1), corners in either order
RECTS = [(0.0, 0.3, 60.0, 10, 12, 40, 50), (0.2, 0.1, 58.0, 60, 50, 5, 3), (0.0, 0.3, 60.0, 0, 0, 64, 64)]


def _u8(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGBA")).astype(np.float64) / 255.0


def _assert_orbit_bars(got: bytes, want: bytes) -> None:
    diff = np.abs(_u8(got) - _u8(want))
    assert float(diff.mean()) < 1e-3, float(diff.mean())
    assert float((diff < 1e-2).mean()) > 0.995


@pytest.fixture
def states():
    japi._BUDGET_STATE.clear()
    tapi._BUDGET_STATE.clear()
    port = serve.build_state_from_args(headless.build_parser().parse_args(SCENE_ARGS + ["--device", "cpu"]))
    jax = jserve.build_state_from_args(jheadless.build_parser().parse_args(SCENE_ARGS))
    port.interactive = InteractiveRenderer(port.settings, period_floor_ms=1e9, device="cpu")
    jax.interactive = japi.InteractiveRenderer(jax.settings, period_floor_ms=1e9)
    return port, jax


def test_render_png_matches_jax_along_an_orbit(states):
    port, jax = states
    assert port.init_orbit == jax.init_orbit and port.radius == jax.radius
    for az, el, r in POSES:
        got, want = port.render_png(az, el, r, None), jax.render_png(az, el, r, None)
        assert decode_png(got).shape == (64, 64, 4)
        _assert_orbit_bars(got, want)
    assert port.interactive.stats == jax.interactive.stats == {"bins": 1, "replays": 3, "oneshots": 0}
    assert port.diag.frames == jax.diag.frames == len(POSES)


def test_selection_matches_jax(states, tmp_path, monkeypatch):
    port, jax = states
    for rect in RECTS:
        n = port.select_rect(*rect)
        assert n == jax.select_rect(*rect), rect
        assert 0 < n
        np.testing.assert_array_equal(port.cloud.visibility.numpy(), np.asarray(jax.cloud.visibility))
    assert port.settings.draw_mode.value == jax.settings.draw_mode.value == "highlight_selected"
    port.select_rect(*RECTS[0])
    jax.select_rect(*RECTS[0])
    # the highlighted frame, after a new cloud object (a fresh bin)
    _assert_orbit_bars(port.render_png(0.0, 0.3, 60.0, None), jax.render_png(0.0, 0.3, 60.0, None))
    assert port.interactive.stats == jax.interactive.stats
    assert port.select_invert() == jax.select_invert()
    for name, state in (("port", port), ("jax", jax)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        count, nbytes = state.select_save()
        assert nbytes == os.path.getsize("live_output.gcloud")
    assert port.select_save(str(tmp_path / "again.gcloud"))[0] == count
    saved = [load_cloud(str(tmp_path / name / "live_output.gcloud"), device="cpu") for name in ("port", "jax")]
    assert len(saved[0]) == len(saved[1]) == count
    for field in ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity"):
        assert torch.equal(getattr(saved[0], field), getattr(saved[1], field))
    port.select_clear()
    jax.select_clear()
    assert bool((port.cloud.visibility == 1.0).all()) and port.settings.draw_mode.value == "all"
    assert port.select_save() == jax.select_save() == (1024, port.select_save()[1])


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture
def server():
    running = []

    def start(state, **kw):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state, **kw))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        running.append((srv, thread))
        return f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for srv, thread in running:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_every_route_over_http(server, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    manifest = {"schema_version": 1, "examples": [
        {"id": "test-model", "title": "test model", "description": "deterministic corner cloud", "tags": ["test"],
         "thumbnail": "thumbnails/test-model.png", "args": ["--test-model", "--eye", "1.2", "1.5", "3"]},
        {"id": "seeded", "title": "seeded", "description": "seeded random cloud", "tags": ["3d"],
         "thumbnail": "thumbnails/seeded.png",
         "args": ["--gaussian-count", "500", "--seed", "7", "--eye", "0", "0", "60"]},
    ]}
    (tmp_path / "examples.json").write_text(json.dumps(manifest))
    www = tmp_path / "www"
    assert build_www.main(["--manifest", str(tmp_path / "examples.json"), "--out", str(www), "--size", "32",
                           "--device", "cpu"]) == 0
    args = headless.build_parser().parse_args(SCENE_ARGS + ["--device", "cpu"])
    state = serve.build_state_from_args(args)
    base = server(state, gallery_dir=str(www), base_args=args)

    code, ctype, page = _get(base, "/")
    assert code == 200 and ctype == "text/html" and b"1024 gaussians" in page and b'width="64"' in page
    code, ctype, png = _get(base, "/frame?az=0.1&el=0.3&r=60")
    assert code == 200 and ctype == "image/png" and decode_png(png).shape == (64, 64, 4)
    assert _get(base, "/screenshot?az=0.1&el=0.3&r=60")[2] == b"saved viewer_screenshot_0.png"
    assert (tmp_path / "viewer_screenshot_0.png").read_bytes() == png  # the same pose replays the same bits
    code, _, body = _get(base, "/export")
    assert code == 200 and body.startswith(b"wrote viewer_export.glb")
    exported = load_any(str(tmp_path / "viewer_export.glb"), device="cpu")
    assert len(exported.clouds) == 1 and len(exported.clouds[0].cloud) == 1024
    n = state.select_rect(*RECTS[0])  # the count the route must report
    state.select_clear()
    assert _get(base, "/select?x0=10&y0=12&x1=40&y1=50&az=0&el=0.3&r=60")[2] == f"selected {n} gaussians".encode()
    assert _get(base, "/select/invert")[2] == f"selected {1024 - n} gaussians".encode()
    body = _get(base, "/select/save")[2].decode()
    assert body.startswith(f"saved {1024 - n} gaussians to live_output.gcloud")
    assert len(load_cloud(str(tmp_path / "live_output.gcloud"), device="cpu")) == 1024 - n
    info = json.loads(_get(base, "/info")[2])
    assert info["gaussians"] == 1024 and info["selected"] == 1024 - n and info["frames"] == 2
    assert info["mode"] == "gaussian_3d" and info["width"] == info["height"] == 64
    assert _get(base, "/select/clear")[2] == b"selection cleared"
    assert json.loads(_get(base, "/info")[2])["selected"] == 1024
    assert _get(base, "/nowhere")[0] == 404

    # the gallery the port's build_www built
    code, _, index = _get(base, "/gallery")
    assert code == 200 and b"/example/test-model" in index and b"seeded random cloud" in index
    assert b"python -m bevy_gaussian_splatting_tpu_torch.viewer.serve" in index
    code, ctype, thumb = _get(base, "/thumbnails/seeded.png")
    assert code == 200 and ctype == "image/png" and decode_png(thumb).shape == (32, 32, 4)
    assert _get(base, "/thumbnails/missing.png")[0] == 404
    assert json.loads(_get(base, "/examples/examples.json")[2]) == manifest
    code, _, page = _get(base, "/example/seeded")  # 302 to / on the new scene
    assert code == 200 and b"500 gaussians" in page
    assert json.loads(_get(base, "/info")[2])["gaussians"] == 500
    assert decode_png(_get(base, "/frame")[2]).shape == (64, 64, 4)
    code, _, body = _get(base, "/example/nothing")
    assert code == 500 and body.startswith(b"KeyError")


def test_streaming_scene_over_http(server, tmp_path):
    """The viewer refreshes chunk residency around each frame's eye (loads
    on the scene's thread) and serves the resident set."""
    cloud = torch_cloud(random_arrays_3d_seeded(600, seed=2))
    save_streaming_scene(slice_cloud(cloud, grid=(3, 1, 1)), str(tmp_path))
    args = headless.build_parser().parse_args(
        ["--input-stream", str(tmp_path), "--stream-radius", "1e9", "--eye", "0", "0", "60", "--width", "64",
         "--height", "64", "--device", "cpu"])
    state = serve.build_state_from_args(args)
    try:
        assert state.stream._worker is not None
        base = server(state)
        code, ctype, png = _get(base, "/frame?az=0&el=0.2&r=60")
        assert code == 200 and decode_png(png)[..., :3].max() > 0
        assert state.stream.resident_ids() == [0, 1, 2]
        assert json.loads(_get(base, "/info")[2])["gaussians"] == 1024  # 600 padded to a power of two
    finally:
        state.stream.close()
