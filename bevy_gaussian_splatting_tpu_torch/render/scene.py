"""Multi-cloud scene rendering (the JAX package's ``render/scene.py``).

The reference draws each cloud entity as its own Transparent3d phase item,
sorted by the entity's view distance, into one target
(src/render/mod.rs:344-452 queue_gaussians).  Here the clouds render far to
near, each image the next render's full-image background, each cloud with its
node's world transform as the model transform.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.io.scene import GaussianScene
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera, perspective_infinite_reverse_rh
from bevy_gaussian_splatting_tpu_torch.render.api import render


def render_scene(
    scene: GaussianScene,
    camera: Camera,
    background: Optional[torch.Tensor] = None,
    impl: str = "auto",
    settings_override=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Composite every scene cloud -> [H, W, 4] linear premultiplied RGBA on
    ``device`` (the card unless ``device="cpu"``).  Without clouds, the
    background (solid [4] or [H, W, 4]) over the whole image."""
    dev = resolve_device(device)
    if background is None:
        background = torch.zeros((4,), dtype=torch.float32, device=dev)
    cam_pos = camera.world_position.cpu().numpy()

    def entity_distance(sc):
        return float(np.linalg.norm(np.asarray(sc.transform)[:3, 3] - cam_pos))

    image = None
    for sc in sorted(scene.clouds, key=entity_distance, reverse=True):  # far first
        image = render(
            sc.cloud,
            camera,
            settings_override if settings_override is not None else sc.settings,
            model_transform=torch.as_tensor(np.asarray(sc.transform, np.float32), device=dev),
            background=background if image is None else image,
            impl=impl,
            device=dev,
        )
    if image is None:
        image = background.to(dev).expand(camera.height, camera.width, 4).clone()
    return image


def corrected_scene_camera_transform(sc) -> np.ndarray:
    """Scene-camera pose with the reference's upside-down correction
    (viewer/viewer.rs:319-331): an imported camera whose up vector opposes
    world up (roll ~= PI) is turned upright by a PI rotation about its own
    forward axis: the same look direction, orbit input no longer inverted."""
    t = np.asarray(sc.transform, np.float64).copy()
    rot = t[:3, :3]
    up = rot[:, 1]
    fwd = -rot[:, 2]  # Bevy cameras look down -Z
    if float(up @ np.array([0.0, 1.0, 0.0])) < 0.0:
        f = fwd / max(np.linalg.norm(fwd), 1e-12)
        flip = 2.0 * np.outer(f, f) - np.eye(3)  # rotation by PI about f
        t[:3, :3] = flip @ rot
    return t


def camera_from_scene(
    scene: GaussianScene, width: int = 512, height: int = 512, device: DeviceLike = None
) -> Optional[Camera]:
    """The first scene camera (viewer scene-camera adoption,
    viewer/viewer.rs:294-362): the node's world transform, upside-down
    corrected, is the camera pose and its inverse the view matrix.  None
    when the scene has no camera."""
    if not scene.cameras:
        return None
    sc = scene.cameras[0]
    view = np.linalg.inv(corrected_scene_camera_transform(sc)).astype(np.float32)
    proj = perspective_infinite_reverse_rh(
        sc.yfov_radians or float(np.pi / 4), width / height, sc.znear or 0.1, device="cpu"
    )
    return Camera.from_matrices(view, proj, width, height, device=device)


def orbit_from_scene_camera(scene: GaussianScene, orbit_radius: float):
    """(az, el, radius, target) of an orbit viewer that adopts the scene
    camera (the reference's orbit_from_translation_and_focus,
    viewer/viewer.rs:333-358): the focus sits ``orbit_radius`` along the
    corrected camera's forward axis, azimuth and elevation put the eye at the
    camera's translation.  None when the scene has no camera."""
    if not scene.cameras:
        return None
    t = corrected_scene_camera_transform(scene.cameras[0])
    eye = t[:3, 3]
    fwd = -t[:3, :3][:, 2]
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    target = eye + fwd * orbit_radius
    v = eye - target  # = -fwd * orbit_radius
    r = float(np.linalg.norm(v))
    el = float(np.arcsin(np.clip(v[1] / max(r, 1e-12), -1.0, 1.0)))
    az = float(np.arctan2(v[0], v[2]))
    return az, el, r, tuple(float(x) for x in target)
