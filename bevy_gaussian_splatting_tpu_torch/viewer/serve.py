"""Interactive browser viewer, the framework's windowed-viewer equivalent
(``viewer/serve.py`` of the JAX package).

The reference ships a winit/bevy viewer binary with a pan-orbit camera,
screenshot hotkey, and GLB export (src/bin/viewer.rs + pan-orbit plugin).  A
server without a display serves the same interactions over HTTP: a
single-page app with mouse orbit and zoom, a 4D time slider, a screenshot
button, a GLB export button and rectangle selection, rendered on the card
through ``render.api.InteractiveRenderer`` (frame-coherent serving: orbit
frames replay the last binning until the sort throttle bins again).

    python -m bevy_gaussian_splatting_tpu_torch.viewer.serve --test-model --port 8720
    python -m bevy_gaussian_splatting_tpu_torch.viewer.serve --input-cloud s.gcloud
    python -m bevy_gaussian_splatting_tpu_torch.viewer.serve --device cpu --gallery www_out

Then open http://localhost:8720/.  Requests arrive on threads of their own
and render one at a time under the state's lock, on the state's device.
Frames are PNGs of the port's encoder (``utils/image.py``); screenshots,
``viewer_export.glb`` and ``live_output.gcloud`` go to the working
directory, as in the JAX package.  An exception in a request answers 500
with its text.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>bevy_gaussian_splatting_tpu_torch viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#0008; padding:6px 10px;
        border-radius:4px; user-select:none; }
 #view { display:block; margin:auto; cursor:grab; image-rendering:pixelated; }
 button { font:inherit; margin-right:6px; }
</style></head><body>
<div id="hud">
  <div id="stats">loading…</div>
  <div style="margin-top:4px">
    <button id="shot">screenshot</button>
    <button id="glb">export .glb</button>
    <span id="tctl" style="display:none">t <input id="time" type="range"
      min="0" max="1" step="0.01" value="0" style="width:120px"></span>
  </div>
  <div style="margin-top:4px">
    <button id="selinv">invert selection</button>
    <button id="selsave">save subset</button>
    <button id="selclear">clear</button>
  </div>
  <div style="margin-top:4px;opacity:.6">drag: orbit &nbsp; wheel: dolly &nbsp;
    shift+drag: select</div>
</div>
<div style="position:relative;width:fit-content;margin:auto">
<img id="view" width="%W%" height="%H%">
<div id="selbox" style="position:absolute;border:1px dashed #6f6;
  background:#6f61;display:none;pointer-events:none"></div>
</div>
<script>
let az = %AZ%, el = %EL%, r = %R%, t = 0, busy = false, dirty = true;
const img = document.getElementById('view');
function url() {
  return `/frame?az=${az.toFixed(4)}&el=${el.toFixed(4)}&r=${r.toFixed(4)}&t=${t}`;
}
async function refresh() {
  if (busy) { dirty = true; return; }
  busy = true; dirty = false;
  const t0 = performance.now();
  const resp = await fetch(url());
  const blob = await resp.blob();
  img.src = URL.createObjectURL(blob);
  const ms = (performance.now() - t0).toFixed(0);
  document.getElementById('stats').textContent =
    `%N% gaussians  ${ms} ms/frame  az ${az.toFixed(2)} el ${el.toFixed(2)} r ${r.toFixed(1)}`;
  busy = false;
  if (dirty) refresh();
}
let drag = null, sel = null;
const selbox = document.getElementById('selbox');
function imgXY(e) {
  const b = img.getBoundingClientRect();
  return [e.clientX - b.left, e.clientY - b.top];
}
img.addEventListener('mousedown', e => {
  if (e.shiftKey) { sel = imgXY(e); e.preventDefault(); }
  else drag = [e.clientX, e.clientY];
});
window.addEventListener('mouseup', async e => {
  drag = null;
  if (sel) {
    const [x1, y1] = imgXY(e);
    selbox.style.display = 'none';
    const q = `x0=${sel[0]}&y0=${sel[1]}&x1=${x1}&y1=${y1}&` + url().slice(7);
    sel = null;
    const resp = await fetch('/select?' + q);
    document.getElementById('stats').textContent = await resp.text();
    refresh();
  }
});
window.addEventListener('mousemove', e => {
  if (sel) {
    const [x, y] = imgXY(e);
    selbox.style.left = Math.min(sel[0], x) + 'px';
    selbox.style.top = Math.min(sel[1], y) + 'px';
    selbox.style.width = Math.abs(x - sel[0]) + 'px';
    selbox.style.height = Math.abs(y - sel[1]) + 'px';
    selbox.style.display = 'block';
    return;
  }
  if (!drag) return;
  az += (e.clientX - drag[0]) * 0.01;
  el = Math.max(-1.5, Math.min(1.5, el + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  refresh();
});
for (const [id, route] of [['selinv', '/select/invert'],
                           ['selsave', '/select/save'],
                           ['selclear', '/select/clear']]) {
  document.getElementById(id).onclick = async () => {
    const resp = await fetch(route);
    document.getElementById('stats').textContent = await resp.text();
    refresh();
  };
}
img.addEventListener('wheel', e => {
  e.preventDefault();
  r *= Math.exp(e.deltaY * 0.001);
  refresh();
});
document.getElementById('shot').onclick = async () => {
  const resp = await fetch(`/screenshot?` + url().slice(7));
  document.getElementById('stats').textContent = await resp.text();
};
document.getElementById('glb').onclick = async () => {
  const resp = await fetch('/export');
  document.getElementById('stats').textContent = await resp.text();
};
const tslider = document.getElementById('time');
if (%IS4D%) document.getElementById('tctl').style.display = 'inline';
tslider.oninput = () => { t = parseFloat(tslider.value); refresh(); };
refresh();
</script></body></html>
"""



class ViewerState:
    """The scene and the render plumbing shared across requests (the card
    renders one frame at a time; a lock serialises renders)."""

    def __init__(self, cloud, settings, width, height, background, target, radius, impl="auto", scene=None,
                 stream=None, device: DeviceLike = None):
        from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer
        from bevy_gaussian_splatting_tpu_torch.utils.trace import FrameDiagnostics

        self.device = resolve_device(device)
        self.cloud = cloud
        self.scene = scene
        self.stream = stream  # StreamingCloudScene: radius-driven residency
        self.settings = settings
        self.width = width
        self.height = height
        self.background = background
        self.target = target
        self.radius = radius
        self.impl = impl
        # initial orbit pose (az, el, radius), overridden by scene-camera
        # adoption (reference viewer.rs:294-362) in build_state_from_args
        self.init_orbit = (0.0, 0.3, radius)
        self.lock = threading.Lock()
        self.shots = 0
        self.diag = FrameDiagnostics()
        # frame-coherent serving: reuse binning across orbit frames with the
        # reference's sort throttle
        self.interactive = InteractiveRenderer(settings, impl=impl, device=self.device)

    def on_device(self):
        """The state's card as the calling thread's current device (a request
        thread starts on device 0)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def camera(self, az: float, el: float, radius: float):
        from bevy_gaussian_splatting_tpu_torch.models.camera import Camera

        tx, ty, tz = self.target
        eye = (
            tx + radius * math.cos(el) * math.sin(az),
            ty + radius * math.sin(el),
            tz + radius * math.cos(el) * math.cos(az),
        )
        return Camera.create(
            eye=eye, target=tuple(self.target), width=self.width, height=self.height, device=self.device
        )

    def render_u8(self, az, el, radius, t) -> np.ndarray:
        """One frame at an orbit pose -> [H, W, 4] uint8 sRGB."""
        from bevy_gaussian_splatting_tpu_torch.render.scene import render_scene
        from bevy_gaussian_splatting_tpu_torch.utils.image import to_srgb_u8

        settings = self.settings
        if t is not None:
            settings = dataclasses.replace(settings, time=float(t))
        with self.lock, self.on_device():
            cam = self.camera(az, el, radius)
            if self.stream is not None:
                # refresh chunk residency around the current eye; loads land
                # asynchronously and pop into view on later frames
                self.stream.update(cam.world_position.cpu().numpy())
                resident = self.stream.resident_cloud()
                if resident is not None:
                    self.cloud = resident
            if self.scene is not None:
                img = render_scene(self.scene, cam, background=self.background, impl=self.impl, device=self.device)
            else:
                # the (possibly UI-modified) settings in; the renderer's
                # budget key holds settings.static_key(), so changed settings
                # bin again.  The orbit camera is built on the card from one
                # packed upload; bins are reused across orbit frames per the
                # reference's sort throttle
                self.interactive.settings = settings
                img = self.interactive.render_orbit(
                    self.cloud, az, el, radius, target=tuple(self.target),
                    width=self.width, height=self.height,
                    background=self.background, time=float(settings.time),
                )
            u8 = to_srgb_u8(img)
            self.diag.tick()
        return u8

    def budget_info(self) -> dict:
        """The serving counters beside the frame clock: the share of the
        renderer's frames that replayed a stale binning, the pair-budget
        recounts of this process and the counted pairs over the budgets
        they sized (``utils/trace.py`` :func:`counters`), in %."""
        from bevy_gaussian_splatting_tpu_torch.utils.trace import counters

        stats = self.interactive.stats
        frames = sum(stats.values())
        c = counters()
        sized = c.get("budget.sized", 0)
        return {
            "replay_pct": 100.0 * stats["replays"] / frames if frames else None,
            "recounts": c.get("budget.recounts", 0),
            "pair_fill_pct": 100.0 * c["budget.pairs_counted"] / sized if sized else None,
        }

    def render_png(self, az, el, radius, t) -> bytes:
        from bevy_gaussian_splatting_tpu_torch.utils.image import encode_png

        return encode_png(self.render_u8(az, el, radius, t))

    # -- selection (reference viewer hotkeys I/O + SaveSelectionEvent,
    #    viewer/viewer.rs:611-677, src/query/select.rs:118-176) --------------
    def select_rect(self, az, el, r, x0, y0, x1, y1) -> int:
        """Select gaussians whose projected centres fall inside a screen-space
        rectangle; the selection is written into the visibility channel and
        the render switches to HIGHLIGHT_SELECTED.  Projected on the host in
        float32 numpy, as the JAX package does, so the selected set is its."""
        from bevy_gaussian_splatting_tpu_torch.models.settings import DrawMode
        from bevy_gaussian_splatting_tpu_torch.query.select import Select, apply_selection

        with self.lock, self.on_device():
            cam = self.camera(az, el, r)
            pos = self.cloud.position.cpu().numpy()
            clip = cam.clip_from_view.cpu().numpy() @ cam.view_from_world.cpu().numpy()
            h = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], 1) @ clip.T
            w = h[:, 3]
            valid = w > 1e-8
            ndc = h[:, :2] / np.maximum(w[:, None], 1e-8)
            px = (ndc[:, 0] + 1.0) * 0.5 * self.width
            py = (1.0 - ndc[:, 1]) * 0.5 * self.height
            inside = (
                valid
                & (px >= min(x0, x1)) & (px <= max(x0, x1))
                & (py >= min(y0, y1)) & (py <= max(y0, y1))
            )
            idx = np.nonzero(inside)[0]
            self.cloud = apply_selection(self.cloud, Select(idx))
            self.settings = dataclasses.replace(self.settings, draw_mode=DrawMode.HIGHLIGHT_SELECTED)
            return len(idx)

    def select_invert(self) -> int:
        from bevy_gaussian_splatting_tpu_torch.query.select import apply_selection, selection_from_visibility

        with self.lock, self.on_device():
            sel = selection_from_visibility(self.cloud).invert(len(self.cloud))
            self.cloud = apply_selection(self.cloud, sel)
            return len(sel)

    def select_clear(self) -> None:
        from bevy_gaussian_splatting_tpu_torch.models.settings import DrawMode

        with self.lock, self.on_device():
            self.cloud = self.cloud.with_visibility(
                torch.ones(len(self.cloud), dtype=torch.float32, device=self.cloud.device)
            )
            self.settings = dataclasses.replace(self.settings, draw_mode=DrawMode.ALL)

    def select_save(self, path: str = "live_output.gcloud") -> tuple[int, int]:
        """Save the selected subset: the reference writes live_output.gcloud
        (select.rs:155-176)."""
        from bevy_gaussian_splatting_tpu_torch.query.select import save_selection, selection_from_visibility

        with self.lock, self.on_device():
            sel = selection_from_visibility(self.cloud)
            if len(sel) == 0:
                return 0, 0
            nbytes = save_selection(self.cloud, sel, path)
            return len(sel), nbytes

    def export_glb(self, path: str) -> int:
        from bevy_gaussian_splatting_tpu_torch.io.scene import write_khr_gaussian_scene_glb

        if self.scene is not None:
            clouds = self.scene.clouds  # already SceneCloud entries
        else:
            clouds = [("cloud", self.cloud, np.eye(4, dtype=np.float32))]
        with self.lock, self.on_device():
            return write_khr_gaussian_scene_glb(clouds, path)


def make_handler(state: ViewerState, gallery_dir=None, base_args=None):
    box = {"state": state}
    manifest = None
    if gallery_dir:
        manifest_path = os.path.join(gallery_dir, "examples", "examples.json")
        if not os.path.exists(manifest_path):
            manifest_path = os.path.join(
                os.path.dirname(gallery_dir.rstrip("/")) or ".", "examples", "examples.json",
            )
        if os.path.exists(manifest_path):
            with open(manifest_path) as fh:
                manifest = json.load(fh)

    def switch_example(example_id: str) -> ViewerState:
        """Rebuild the live state from a gallery manifest entry's CLI args:
        the reference gallery's per-example viewer links
        (www/examples/examples.json base_viewer + args)."""
        from bevy_gaussian_splatting_tpu_torch.viewer.headless import build_parser

        entry = next((e for e in (manifest or {}).get("examples", []) if e["id"] == example_id), None)
        if entry is None:
            raise KeyError(f"unknown example id {example_id!r}")
        ex_args = build_parser().parse_args(entry["args"])
        ex_args.width = base_args.width if base_args is not None else 512
        ex_args.height = base_args.height if base_args is not None else 512
        ex_args.impl = getattr(base_args, "impl", "auto")
        ex_args.device = str(box["state"].device)
        new_state = build_state_from_args(ex_args)
        box["state"] = new_state
        return new_state

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _params(self):
            q = parse_qs(urlparse(self.path).query)

            def f(name, default):
                return float(q.get(name, [default])[0])

            az0, el0, r0 = box["state"].init_orbit
            return f("az", az0), f("el", el0), f("r", r0), f("t", 0.0)

        def do_GET(self):
            route = urlparse(self.path).path
            state = box["state"]
            is4d = type(state.cloud).__name__ == "Gaussian4dCloud"
            try:
                if gallery_dir and route in ("/gallery", "/gallery/"):
                    with open(os.path.join(gallery_dir, "index.html"), "rb") as fh:
                        self._send(200, "text/html", fh.read())
                    return
                if gallery_dir and route.startswith("/thumbnails/"):
                    path = os.path.join(gallery_dir, "thumbnails", os.path.basename(route))
                    if not os.path.exists(path):
                        self._send(404, "text/plain", b"no thumbnail")
                        return
                    with open(path, "rb") as fh:
                        self._send(200, "image/png", fh.read())
                    return
                if gallery_dir and route == "/examples/examples.json":
                    self._send(200, "application/json", json.dumps(manifest).encode())
                    return
                if gallery_dir and route.startswith("/example/"):
                    switch_example(route.split("/example/", 1)[1])
                    self.send_response(302)
                    self.send_header("Location", "/")
                    self.end_headers()
                    return
                if route == "/":
                    page = (
                        _PAGE.replace("%W%", str(state.width))
                        .replace("%H%", str(state.height))
                        .replace("%N%", str(len(state.cloud)))
                        .replace("%AZ%", f"{state.init_orbit[0]:.6f}")
                        .replace("%EL%", f"{state.init_orbit[1]:.6f}")
                        .replace("%R%", str(state.init_orbit[2]))
                        .replace("%IS4D%", "true" if is4d else "false")
                    )
                    self._send(200, "text/html", page.encode())
                elif route == "/frame":
                    az, el, r, t = self._params()
                    self._send(200, "image/png", state.render_png(az, el, r, t))
                elif route == "/screenshot":
                    az, el, r, t = self._params()
                    png = state.render_png(az, el, r, t)
                    path = f"viewer_screenshot_{state.shots}.png"
                    state.shots += 1
                    with open(path, "wb") as fh:
                        fh.write(png)
                    self._send(200, "text/plain", f"saved {path}".encode())
                elif route == "/export":
                    path = "viewer_export.glb"
                    n = state.export_glb(path)
                    self._send(200, "text/plain", f"wrote {path} ({n} bytes)".encode())
                elif route == "/select":
                    q = parse_qs(urlparse(self.path).query)

                    def g(name):
                        return float(q.get(name, ["0"])[0])

                    az, el, r, _ = self._params()
                    n = state.select_rect(az, el, r, g("x0"), g("y0"), g("x1"), g("y1"))
                    self._send(200, "text/plain", f"selected {n} gaussians".encode())
                elif route == "/select/invert":
                    n = state.select_invert()
                    self._send(200, "text/plain", f"selected {n} gaussians".encode())
                elif route == "/select/clear":
                    state.select_clear()
                    self._send(200, "text/plain", b"selection cleared")
                elif route == "/select/save":
                    count, nbytes = state.select_save()
                    msg = (
                        f"saved {count} gaussians to live_output.gcloud ({nbytes} bytes)"
                        if count else "nothing selected"
                    )
                    self._send(200, "text/plain", msg.encode())
                elif route == "/info":
                    info = {
                        "gaussians": len(state.cloud),
                        "selected": int((state.cloud.visibility >= 0.5).sum()),
                        "width": state.width,
                        "height": state.height,
                        "mode": state.settings.gaussian_mode.value,
                        "ema_ms": state.diag.ema_ms,
                        "fps": state.diag.fps,
                        "frames": state.diag.frames,
                        **state.budget_info(),
                    }
                    self._send(200, "application/json", json.dumps(info).encode())
                else:
                    self._send(404, "text/plain", b"not found")
            except BrokenPipeError:
                pass
            except Exception as e:  # surface render errors to the browser
                self._send(500, "text/plain", f"{type(e).__name__}: {e}".encode())

    return Handler


def build_state_from_args(args) -> ViewerState:
    """A ViewerState from parsed headless-CLI args: shared by ``main`` and
    the gallery's live ``/example/<id>`` scene switching."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded
    from bevy_gaussian_splatting_tpu_torch.render.scene import orbit_from_scene_camera
    from bevy_gaussian_splatting_tpu_torch.viewer.headless import load_source, settings_from_args

    dev = resolve_device(getattr(args, "device", None))
    cloud, scene, stream = load_source(args, dev, streaming_background=True)
    if cloud is None:
        cloud = random_gaussians_3d_seeded(1, 0, device=dev)  # until chunks land
    settings = settings_from_args(args)
    eye = args.eye
    target = args.target
    radius = getattr(args, "orbit_radius", None) or math.dist(eye, target) or 5.0
    init_orbit = None
    if scene is not None:
        # adopt the scene camera for the initial orbit pose (upside-down
        # corrected; reference viewer/viewer.rs:294-362)
        adopted = orbit_from_scene_camera(scene, radius)
        if adopted is not None:
            az0, el0, r0, target = adopted
            radius = r0
            init_orbit = (az0, el0, r0)
    state = ViewerState(
        cloud, settings, args.width, args.height,
        torch.tensor(args.background, dtype=torch.float32, device=dev), target, radius, args.impl,
        scene=scene, stream=stream, device=dev,
    )
    if init_orbit is not None:
        state.init_orbit = init_orbit
    return state


def main(argv=None) -> int:
    from bevy_gaussian_splatting_tpu_torch.viewer.headless import build_parser

    p = build_parser()
    p.add_argument("--port", type=int, default=8720)
    p.add_argument("--orbit-radius", type=float, default=None,
                   help="initial camera distance (default: |eye - target|)")
    p.add_argument("--gallery", default=None, metavar="DIR",
                   help="serve the demo gallery built by the port's tools/build_www.py "
                        "(index at /gallery; /example/<id> switches the live scene)")
    args = p.parse_args(argv)

    state = build_state_from_args(args)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state, gallery_dir=args.gallery, base_args=args))
    print(f"viewer: {len(state.cloud)} gaussians on {state.device} at http://localhost:{args.port}/ "
          f"({args.width}x{args.height})", flush=True)
    t0 = time.perf_counter()
    state.render_png(0.0, 0.3, state.radius, None)  # build the kernels before the first request
    print(f"first frame in {time.perf_counter() - t0:.2f}s", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if state.stream is not None:
            state.stream.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
