"""Camera model mirroring the Bevy view uniforms the reference shaders consume.

Bevy's 3D camera is right-handed, looks down -Z in view space, and uses an
infinite-reverse-Z projection (src/render/helpers.wgsl:8-55,
src/render/transform.wgsl:5-14).  The matrices are built in numpy with the
same float32 code as the JAX package's ``models/camera.py``, so both packages
start from the same bits, and are then held as float32 tensors.

Matrices are row-major ``[row, col]`` with the column-vector convention:
``clip = M @ [x, y, z, 1]^T``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.utils.trace import spanned


def _look_at_rh_np(eye, target, up) -> np.ndarray:
    """Right-handed view matrix (world -> view), glam ``Mat4::look_at_rh``."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)

    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)

    return np.stack(
        [
            np.concatenate([s, np.array([-np.dot(s, eye)], np.float32)]),
            np.concatenate([u, np.array([-np.dot(u, eye)], np.float32)]),
            np.concatenate([-f, np.array([np.dot(f, eye)], np.float32)]),
            np.array([0.0, 0.0, 0.0, 1.0], np.float32),
        ]
    ).astype(np.float32)


def _perspective_infinite_reverse_rh_np(
    fov_y_radians: float, aspect: float, z_near: float
) -> np.ndarray:
    """Bevy/glam ``Mat4::perspective_infinite_reverse_rh``: reverse-Z, NDC z in
    (0, 1] with z=1 at the near plane."""
    f = np.float32(1.0) / np.tan(np.float32(fov_y_radians) / np.float32(2.0))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / np.float32(aspect)
    m[1, 1] = f
    m[2, 3] = z_near
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass(frozen=True)
class Camera:
    """View + projection + viewport state for one render.

    ``viewport`` = (x, y, width, height) in physical pixels (Bevy
    ``view.viewport``).  ``width`` and ``height`` are kept as Python ints
    too, so a frame needs no device-to-host read to learn its image size.
    ``world_position`` (-R^T t of the view matrix) is computed once on the
    host, so the card and the CPU start the depth keys from the same bits."""

    view_from_world: torch.Tensor  # [4, 4]
    clip_from_view: torch.Tensor  # [4, 4]
    viewport: torch.Tensor  # [4] (x, y, w, h)
    prev_clip_from_world: torch.Tensor  # [4, 4]
    world_position: torch.Tensor  # [3]
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.view_from_world.device

    @property
    def clip_from_world(self) -> torch.Tensor:
        return self.clip_from_view @ self.view_from_world

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            view_from_world=self.view_from_world.to(device),
            clip_from_view=self.clip_from_view.to(device),
            viewport=self.viewport.to(device),
            prev_clip_from_world=self.prev_clip_from_world.to(device),
            world_position=self.world_position.to(device),
        )

    @staticmethod
    @spanned("gs.camera")
    def create(
        eye=(0.0, 1.5, 5.0),
        target=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        width: int = 512,
        height: int = 512,
        fov_y_radians: float = float(np.pi / 4.0),
        z_near: float = 0.1,
        prev_clip_from_world=None,
        device: DeviceLike = None,
    ) -> "Camera":
        """Build a camera the way the reference viewer does (pan-orbit camera
        + Bevy's default ``PerspectiveProjection``: fov pi/4, near 0.1)."""
        return Camera.from_matrices(
            _look_at_rh_np(eye, target, up),
            _perspective_infinite_reverse_rh_np(fov_y_radians, width / height, z_near),
            width, height, prev_clip_from_world, device,
        )

    @staticmethod
    def from_matrices(
        view_from_world,
        clip_from_view,
        width: int,
        height: int,
        prev_clip_from_world=None,
        device: DeviceLike = None,
    ) -> "Camera":
        """A camera from any float32 [4, 4] view and projection matrices
        (numpy arrays or tensors), e.g. a scene camera's inverse pose
        (``render/scene.py``).  ``prev_clip_from_world`` defaults to
        ``clip_from_view @ view_from_world``; the camera position is
        computed on the host, as :meth:`create` does."""
        dev = resolve_device(device)
        view = np.asarray(_host(view_from_world), np.float32)
        proj = np.asarray(_host(clip_from_view), np.float32)
        prev = proj @ view if prev_clip_from_world is None else np.asarray(_host(prev_clip_from_world), np.float32)
        view_t = torch.from_numpy(view)
        return Camera(
            view_from_world=view_t.to(dev),
            clip_from_view=torch.from_numpy(proj).to(dev),
            viewport=torch.tensor(
                [0.0, 0.0, float(width), float(height)], dtype=torch.float32,
                device=dev,
            ),
            prev_clip_from_world=torch.from_numpy(prev).to(dev),
            world_position=(-view_t[:3, :3].T @ view_t[:3, 3]).to(dev),
            width=int(width),
            height=int(height),
        )


def _host(m):
    return m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else m


def look_at_rh(eye, target, up, device: DeviceLike = None) -> torch.Tensor:
    """Right-handed view matrix (world -> view) as a float32 tensor, glam
    ``Mat4::look_at_rh`` (``models/camera.py:31`` of the JAX package),
    computed on the host."""
    return torch.from_numpy(_look_at_rh_np(eye, target, up)).to(resolve_device(device))


def perspective_infinite_reverse_rh(
    fov_y_radians: float, aspect: float, z_near: float, device: DeviceLike = None
) -> torch.Tensor:
    """Bevy/glam ``Mat4::perspective_infinite_reverse_rh`` as a float32
    tensor (``models/camera.py:136`` of the JAX package)."""
    return torch.from_numpy(_perspective_infinite_reverse_rh_np(fov_y_radians, aspect, z_near)).to(
        resolve_device(device)
    )


def _filled(shape: tuple, entries: dict, device) -> torch.Tensor:
    """A float32 tensor of zeros with ``entries`` (index -> value) set, made
    on ``device`` by fills: a copy from pageable host memory would wait for
    the card's queue to drain."""
    t = torch.zeros(shape, dtype=torch.float32, device=device)
    for index, value in entries.items():
        t[index] = value
    return t


@spanned("gs.camera")
def orbit_camera_device(
    orbit: torch.Tensor,
    width: int,
    height: int,
    fov_y_radians: float = float(np.pi / 4.0),
    z_near: float = 0.1,
) -> Camera:
    """The viewer's orbit camera built on ``orbit``'s device from one packed
    float32 [6] (az, el, radius, target x, y, z), in the JAX package's op
    order (models/camera.py:67-112): ``eye = target + r (cos(el) sin(az),
    sin(el), cos(el) cos(az))``, looking at the target with +y up.

    A serving loop uploads the six numbers instead of a host-built camera.
    Unlike :meth:`Camera.create`, the camera position is computed on the
    device too, so a depth key on the card may differ from the CPU's by
    the rounding of a few operations (``chip_smoke.py`` counts them)."""
    orbit = orbit.to(torch.float32)
    dev = orbit.device
    az, el, r = orbit[0], orbit[1], orbit[2]
    target = orbit[3:6]
    eye = target + r * torch.stack([torch.cos(el) * torch.sin(az), torch.sin(el), torch.cos(el) * torch.cos(az)])
    up = _filled((3,), {(1,): 1.0}, dev)
    f = target - eye
    f = f / torch.linalg.vector_norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    view = torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        _filled((4,), {(3,): 1.0}, dev),
    ])
    m = _perspective_infinite_reverse_rh_np(fov_y_radians, width / height, z_near)
    proj = _filled((4, 4), {ij: float(m[ij]) for ij in zip(*np.nonzero(m))}, dev)
    return Camera(
        view_from_world=view,
        clip_from_view=proj,
        viewport=_filled((4,), {(2,): float(width), (3,): float(height)}, dev),
        prev_clip_from_world=proj @ view,
        world_position=-view[:3, :3].T @ view[:3, 3],
        width=int(width),
        height=int(height),
    )
