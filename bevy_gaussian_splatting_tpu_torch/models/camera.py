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
        dev = resolve_device(device)
        view = _look_at_rh_np(eye, target, up)
        proj = _perspective_infinite_reverse_rh_np(
            fov_y_radians, width / height, z_near
        )
        if prev_clip_from_world is None:
            prev_clip_from_world = proj @ view
        view_t = torch.from_numpy(view)
        return Camera(
            view_from_world=view_t.to(dev),
            clip_from_view=torch.from_numpy(proj).to(dev),
            viewport=torch.tensor(
                [0.0, 0.0, float(width), float(height)], dtype=torch.float32,
                device=dev,
            ),
            prev_clip_from_world=torch.from_numpy(
                np.asarray(prev_clip_from_world, np.float32)
            ).to(dev),
            world_position=(-view_t[:3, :3].T @ view_t[:3, 3]).to(dev),
            width=int(width),
            height=int(height),
        )
