"""The functional render API, ``render(cloud, camera, settings) -> image``,
and frame-coherent serving, :class:`InteractiveRenderer`.

The counterpart of the JAX package's ``render/api.py``.  ``render()`` keeps
its adaptive pair budget: an exact N-sized pair count sizes the pair
buffers to the scene, is re-measured every ``_RECOUNT_PERIOD`` frames per
pipeline key, grows at once and shrinks never.  PyTorch runs eagerly, so
there is no compiled pipeline to cache; the key still separates budgets.

Implementations (``impl``):
  - "auto", "tiled", "tiled-pallas": the tiled renderer
              (ops/rasterize_tile.py): the CUDA kernels for tensors on the
              card, their plain versions on the CPU.  The JAX package's
              split between its XLA and Pallas compositors is one of
              devices, and the port has one tile compositor per device.
  - "oracle": the exact painter (ops/rasterize_ref.py), O(N * H * W)

:class:`InteractiveRenderer` serves with the reference's sort throttle
(src/sort/mod.rs:76-86, 153-194): it bins again only when the camera moved
and the throttle period passed, and renders the frames in between from the
stale binning with a fresh projection (:func:`make_replay_pipeline`).
"""

from __future__ import annotations

import math
import time as _time
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera, orbit_camera_device
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, RasterizeMode, check_supported
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import (
    composite_epilogue,
    composite_tiles_raw,
    preferred_chunk,
)
from bevy_gaussian_splatting_tpu_torch.ops.project import as_float32
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle
from bevy_gaussian_splatting_tpu_torch.utils import trace

_BUDGET_STATE: dict = {}
_RECOUNT_PERIOD = 16  # frames between pair-count refreshes per pipeline key
TILED_IMPLS = ("auto", "tiled", "tiled-pallas")
IMPLS = TILED_IMPLS + ("oracle",)


def _current_bucket(key, settings, cloud, camera, model_transform) -> int:
    """Adaptive pair-budget bucket (render/api.py:43-73 of the JAX package),
    counted at the frame's ``settings.time``.  ``camera`` may be a function
    that builds the camera, called only on a frame that counts.  A count
    bumps the counters ``budget.recounts``, ``budget.pairs_counted`` (the
    pairs) and ``budget.sized`` (the bucket chosen)."""
    with trace.span("gs.budget"):
        state = _BUDGET_STATE.get(key)
        if state is not None:
            bucket, frame = state
            if (frame + 1) % _RECOUNT_PERIOD:
                _BUDGET_STATE[key] = (bucket, frame + 1)
                return bucket
        with trace.span("gs.recount"):
            if callable(camera):
                camera = camera()
            total = int(rt.pair_count(cloud, camera, settings, model_transform))
        bucket = rt.pairs_budget(len(cloud), total)
        if state is not None and bucket < state[0]:
            bucket = state[0]  # shrink lazily
        _BUDGET_STATE[key] = (bucket, (state[1] + 1) if state else 0)
        trace.count("budget.recounts")
        trace.count("budget.pairs_counted", total)
        trace.count("budget.sized", bucket)
        return bucket


def budget_key(impl: str, settings: CloudSettings, width: int, height: int, cloud, device) -> tuple:
    """The adaptive budget's key: what the JAX package keys its pipelines by
    (render/api.py:675-678), with the device in place of the compositor."""
    return (impl, settings.static_key(), width, height, len(cloud), type(cloud).__name__, str(device))


def render(
    cloud,
    camera: Camera,
    settings: Optional[CloudSettings] = None,
    model_transform: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    impl: str = "auto",
    adaptive_budget: bool = True,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Render one cloud -> [H, W, 4] linear premultiplied RGBA, a 4DGS cloud
    at ``settings.time`` (as the JAX package's ``render()`` passes
    ``jnp.float32(settings.time)``, render/api.py:699), over ``background``
    (None, a solid [4] RGBA or a full image [H, W, 4]).

    ``device`` defaults to ``cuda`` and raises when there is no card; pass
    ``device="cpu"`` for the plain PyTorch versions.  Cloud, camera and
    background are moved there if they lie elsewhere."""
    dev = resolve_device(device)
    if settings is None:
        settings = CloudSettings()
    check_supported(settings)
    if cloud.device != dev:
        cloud = cloud.to(dev)
    if camera.device != dev:
        camera = camera.to(dev)
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=dev)
    if background is None:
        background = torch.zeros((4,), dtype=torch.float32, device=dev)
    elif background.device != dev:
        background = background.to(dev)
    width, height = camera.width, camera.height

    if impl == "oracle":
        return render_oracle(cloud, camera, settings, model_transform, background, time=settings.time)
    if impl not in TILED_IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {', '.join(map(repr, IMPLS))})")

    bucket = None
    if adaptive_budget:
        # the cloud's class too (render/api.py:675-678): a 3D and a 4D cloud
        # of one size never share a bucket
        key = budget_key(impl, settings, width, height, cloud, dev)
        bucket = _current_bucket(key, settings, cloud, camera, model_transform)
    # a serving call, as the JAX package's render() builds its pipeline
    # (make_tiled_pipeline's differentiable=False): the overlay runs the kernel
    return rt.render_tiled(
        cloud, camera, settings, model_transform, background, pairs_max=bucket, differentiable=False,
        time=settings.time,
    )


def make_replay_pipeline(
    settings: CloudSettings,
    width: int,
    height: int,
    pairs_max: int,
):
    """The tiled pipeline split at the sort and bin boundary, for
    frame-coherent serving (render/api.py:76-255 of the JAX package): the
    reference sorts again only on a throttled camera move, and the frames in
    between render with the stale order and fresh per-frame splats.

    Returns ``(bin_fn, replay_fn, bin_orbit_fn, replay_orbit_fn)``:
      - ``bin_fn(cloud, camera, model_transform=None, time=None)`` -> the
        binning artifacts ``(g_s, valid_s, start, end, count)``, in the JAX
        package's order;
      - ``replay_fn(cloud, camera, model_transform, background, time,
        *bins)`` -> [H, W, 4]: a fresh projection and pack, then the
        forward compositor; no sort and no expansion;
      - the orbit forms take a packed float32 [6] orbit in place of the
        camera (:func:`orbit_camera_device`) and the identity transform:
        ``bin_orbit_fn(cloud, orbit, time)``, ``replay_orbit_fn(cloud,
        orbit, background, time, *bins)``.

    A replay gathers the N rows' packed parameters by ``g_s``; the JAX
    package's other form, which projects the cloud rows gathered into pair
    order, is not ported (``ROADMAP.md`` Queue 3).  The compositor follows
    the device: the kernel on the card, its plain version on the CPU.
    ``width`` and ``height`` must be multiples of the tile."""
    if width % rt.TILE or height % rt.TILE:
        raise ValueError(f"the replay pipeline takes multiples of {rt.TILE}, not {width}x{height}")
    tx_count = width // rt.TILE
    num_tiles = tx_count * (height // rt.TILE)
    mode = rt.kernel_mode(settings)
    chunk = preferred_chunk(pairs_max, num_tiles)

    def depth_minmax(cloud, camera, model_transform):
        if settings.rasterize_mode != RasterizeMode.DEPTH:
            return None
        return rt.depth_range(cloud, camera, settings, model_transform)

    def bin_fn(cloud, camera, model_transform=None, time=None):
        cloud = as_float32(cloud)
        dm = depth_minmax(cloud, camera, model_transform)
        splats = rt.project_for_binning(cloud, camera, settings, model_transform, dm, time)
        with trace.span("gs.bin"):
            g_s, tile_s, valid_s = rt.bin_gaussians(splats, width, height, pairs_max)[:3]
            start, end = rt.tile_ranges(tile_s, num_tiles)
            count = torch.clamp(end - start, max=rt.tile_budget(len(cloud)))
        return g_s, valid_s, start, end, count

    def replay_fn(cloud, camera, model_transform, background, time, g_s, valid_s, start, end, count):
        cloud = as_float32(cloud)
        dm = depth_minmax(cloud, camera, model_transform)
        splats = rt.project_for_binning(cloud, camera, settings, model_transform, dm, time, (width, height))
        with trace.span("gs.pack"):
            params_sorted = splats["params"][g_s]
        raw = composite_tiles_raw(
            params_sorted.contiguous(), start, count, tx_count, width, height, chunk=chunk, mode=mode,
            bbox=settings.visualize_bounding_box,
        )
        return composite_epilogue(raw, background, width, height)

    def bin_orbit_fn(cloud, orbit, time=None):
        return bin_fn(cloud, orbit_camera_device(orbit, width, height), None, time)

    def replay_orbit_fn(cloud, orbit, background, time, *bins):
        return replay_fn(cloud, orbit_camera_device(orbit, width, height), None, background, time, *bins)

    return bin_fn, replay_fn, bin_orbit_fn, replay_orbit_fn


def orbit_eye(az: float, el: float, radius: float, target=(0.0, 0.0, 0.0)) -> tuple:
    """The viewer's orbit eye ``target + r (cos(el) sin(az), sin(el),
    cos(el) cos(az))`` in double precision, as a host camera takes it."""
    return (
        target[0] + radius * math.cos(el) * math.sin(az),
        target[1] + radius * math.sin(el),
        target[2] + radius * math.cos(el) * math.cos(az),
    )


class InteractiveRenderer:
    """Frame-coherent serving with the reference's sort throttle
    (render/api.py:258-625 of the JAX package; ``ops/sort.py`` ``sort_due``,
    ``throttle_period_ms``): bin again only when the camera moved and
    ``period_ms`` passed since the last bin; after each bin ``period_ms =
    max(period_floor_ms, 4 x the bin's duration)``, measured across a device
    synchronise.  The
    first bin of a pipeline key resets the period to the floor, since the
    kernels build at first use.  Frames in between replay the stale bins
    with a fresh projection.

    A frame whose time differs from the last one's (a 4DGS sweep) renders
    in one pass, ``render_tiled`` at the same budget, and counts in
    ``stats["oneshots"]``; a settled time bins once and then replays.  A
    new cloud object (``is``, on a held reference) bins again.  Viewports
    that are not a multiple of 16 and ``impl="oracle"`` render through
    :func:`render`, one-pass frames too.  Each served frame is a
    ``gs.frame`` span (``utils/trace.py``).

    The renderer serves on ``device`` (default ``cuda``) and takes clouds
    that lie there: it raises on any other, since moving one every frame
    would make a new object, and so a new binning, each time."""

    def __init__(
        self,
        settings: Optional[CloudSettings] = None,
        impl: str = "auto",
        period_floor_ms: float = 1000.0,
        move_atol: float = 1e-6,
        device: DeviceLike = None,
    ):
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r} (expected one of {', '.join(map(repr, IMPLS))})")
        self.settings = settings if settings is not None else CloudSettings()
        check_supported(self.settings)
        self.impl = impl
        self.device = resolve_device(device)
        self.period_floor_ms = float(period_floor_ms)
        self.move_atol = float(move_atol)
        self.period_ms = float(period_floor_ms)
        self.stats = {"bins": 0, "replays": 0, "oneshots": 0}
        self._pipes: dict = {}
        self._bins = None
        self._bin_key = None  # (pipeline key, cloud object, time)
        self._last_pose = None
        self._last_bin_ms = -1e30
        self._built: set = set()
        self._eye4 = torch.eye(4, dtype=torch.float32, device=self.device)
        self._bg0 = torch.zeros((4,), dtype=torch.float32, device=self.device)

    def _check_cloud(self, cloud) -> None:
        if cloud.device != self.device:
            raise ValueError(
                f"the cloud lies on {cloud.device} and the renderer serves on {self.device}: move it "
                "there once (cloud.to(device)) and pass that object every frame"
            )

    def _one_pass(self, cloud, camera, model_transform, background, time):
        """A frame through :func:`render`: non-tiled impls and viewports off
        the tile grid.  It counts in ``stats["oneshots"]``."""
        self.stats["oneshots"] += 1
        settings = self.settings.replace(time=float(time))
        return render(cloud, camera, settings, model_transform, background, impl=self.impl, device=self.device)

    def _rebin_reason(self, pipe_key, cloud, time, pose, now_ms: float):
        """None: replay; "bin": bin again, then replay; "time": a
        time-driven frame, rendered in one pass."""
        if self._bin_key is None:
            return "bin"
        key, bound_cloud, t_prev = self._bin_key
        # identity on a held reference, not id(): a new cloud could reuse
        # the freed previous cloud's id and keep its stale pairs
        if key != pipe_key or bound_cloud is not cloud:
            return "bin"
        if t_prev != float(time):
            return "time"
        if self._bins is None:
            return "bin"  # the time settled after one-pass frames
        moved = not _allclose(pose, self._last_pose, self.move_atol)
        if sort_ops.sort_due(moved, now_ms, self._last_bin_ms, self.period_ms):
            return "bin"
        return None

    def _serve(self, cloud, width, height, time, pose, count_camera, model_transform, bin_call, replay_call,
               one_pass_call):
        """The throttle around one tiled frame: the budget, then a replay, a
        bin and replay, or a one-pass frame."""
        key = budget_key("interactive", self.settings, width, height, cloud, self.device)
        bucket = _current_bucket(
            key, self.settings.replace(time=float(time)), cloud, count_camera, model_transform
        )
        pipe_key = key + (bucket,)
        pipes = self._pipes.get(pipe_key)
        if pipes is None:
            pipes = make_replay_pipeline(self.settings, width, height, bucket)
            self._pipes[pipe_key] = pipes
        now_ms = _time.perf_counter() * 1e3
        reason = self._rebin_reason(pipe_key, cloud, time, pose, now_ms)
        if reason == "time":
            self.stats["oneshots"] += 1
            self._bins = None
            self._bin_key = (pipe_key, cloud, float(time))
            return one_pass_call(bucket)
        if reason is not None:
            t0 = _time.perf_counter()
            self._bins = bin_call(pipes)
            if self.device.type == "cuda":
                with trace.span("gs.bin"):
                    torch.cuda.synchronize(self.device)
            dur_ms = (_time.perf_counter() - t0) * 1e3
            if pipe_key in self._built:
                self.period_ms = sort_ops.throttle_period_ms(self.period_floor_ms, dur_ms)
            else:
                self._built.add(pipe_key)  # the first bin built the kernels
                self.period_ms = self.period_floor_ms
            self._bin_key = (pipe_key, cloud, float(time))
            self._last_pose = pose
            self._last_bin_ms = now_ms
            self.stats["bins"] += 1
        else:
            self.stats["replays"] += 1
        return replay_call(pipes, self._bins)

    @trace.spanned("gs.frame")
    def render(
        self,
        cloud,
        camera: Camera,
        model_transform: Optional[torch.Tensor] = None,
        background: Optional[torch.Tensor] = None,
        time: float = 0.0,
        pose_key=None,
    ) -> torch.Tensor:
        """One served frame -> [H, W, 4].  ``pose_key``: any host value that
        identifies the camera pose (e.g. the viewer's ``(az, el, radius)``);
        without it the pose is read back from the view matrix and the model
        transform, which waits for the card."""
        self._check_cloud(cloud)
        if camera.device != self.device:
            camera = camera.to(self.device)
        mt = self._eye4 if model_transform is None else model_transform
        bg = self._bg0 if background is None else background
        width, height = camera.width, camera.height
        if self.impl not in TILED_IMPLS or width % rt.TILE or height % rt.TILE:
            return self._one_pass(cloud, camera, mt, bg, time)
        if pose_key is not None:
            pose = np.asarray(pose_key, np.float64).ravel()
        else:
            pose = np.concatenate([
                camera.view_from_world.cpu().numpy().ravel(), mt.cpu().numpy().ravel(),
            ]).astype(np.float64)
        return self._serve(
            cloud, width, height, time, pose, camera, mt,
            lambda pipes: pipes[0](cloud, camera, mt, time),
            lambda pipes, bins: pipes[1](cloud, camera, mt, bg, time, *bins),
            lambda bucket: rt.render_tiled(
                cloud, camera, self.settings, mt, bg, pairs_max=bucket, differentiable=False, time=float(time)
            ),
        )

    @trace.spanned("gs.frame")
    def render_orbit(
        self,
        cloud,
        az: float,
        el: float,
        radius: float,
        target=(0.0, 0.0, 0.0),
        width: int = 512,
        height: int = 512,
        background: Optional[torch.Tensor] = None,
        time: float = 0.0,
    ) -> torch.Tensor:
        """One served frame at an orbit pose -> [H, W, 4]: the camera is
        built on the device from one float32 [6] upload (az, el, radius,
        target), and the pose is checked on the host.  The throttle is
        :meth:`render`'s; non-tiled impls and viewports off the tile grid
        render through :func:`render`, with the same camera."""
        self._check_cloud(cloud)
        bg = self._bg0 if background is None else background
        target = tuple(float(t) for t in target)
        orbit_np = np.asarray([az, el, radius, *target], np.float32)
        orbit = torch.from_numpy(orbit_np)
        if self.device.type == "cuda":
            # from pinned memory the copy queues behind the frames in flight;
            # from pageable memory it would wait for them
            with trace.span("gs.camera"):
                orbit = orbit.pin_memory().to(self.device, non_blocking=True)
        if self.impl not in TILED_IMPLS or width % rt.TILE or height % rt.TILE:
            return self._one_pass(cloud, orbit_camera_device(orbit, width, height), self._eye4, bg, time)

        def count_camera():
            # the budget's count (one frame in _RECOUNT_PERIOD) on a host
            # camera at the same float32 eye
            eye = orbit_np[3:6] + np.float32(radius) * np.array(
                [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)], np.float32
            )
            return Camera.create(eye=tuple(eye), target=target, width=width, height=height, device=self.device)

        pose = np.asarray([az, el, radius, *target, time], np.float64)
        return self._serve(
            cloud, width, height, time, pose, count_camera, self._eye4,
            lambda pipes: pipes[2](cloud, orbit, time),
            lambda pipes, bins: pipes[3](cloud, orbit, bg, time, *bins),
            lambda bucket: rt.render_tiled(
                cloud, orbit_camera_device(orbit, width, height), self.settings, self._eye4, bg,
                pairs_max=bucket, differentiable=False, time=float(time),
            ),
        )


def _allclose(a, b, atol: float) -> bool:
    """Pose keys from the two entry points (a view matrix and a model
    transform, or packed orbit parameters) differ in shape: a change of
    shape counts as a move."""
    if b is None or np.shape(a) != np.shape(b):
        return False
    return bool(np.allclose(a, b, atol=atol))
