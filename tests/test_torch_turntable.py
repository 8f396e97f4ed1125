"""PyTorch port, ``tools/orbit_turntable.py`` on the CPU against the JAX
package's tool on the same arguments (its own file: the JAX tool's
multi-camera pipeline takes most of the time to compile).

The contact sheet is within one u8 level of the JAX tool's.  The GIF (the
port's own encoder, ``utils/image.py`` ``save_gif``; the JAX tool writes
one with PIL) decodes with PIL to the right frame count, size, delay and
loop, each frame within the palette's error of ``to_srgb_u8`` of the
sheet's view."""

import importlib.util
import os

import numpy as np
from PIL import Image

from bevy_gaussian_splatting_tpu_torch.models import cloud as tcloud
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.render.multi_camera import render_multi_camera
from bevy_gaussian_splatting_tpu_torch.tools import orbit_turntable
from bevy_gaussian_splatting_tpu_torch.utils.image import GIF_MAX_ERROR, to_srgb_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U8_BAR = 1


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGBA")).astype(np.int32)


def test_orbit_turntable_and_gif_match_jax(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_orbit_turntable", os.path.join(ROOT, "tools", "orbit_turntable.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    argv = ["--test-model", "--frames", "4", "--size", "64", "--gif"]
    assert jtool.main([*argv, "-o", str(tmp_path / "jax.png")]) == 0
    assert orbit_turntable.main([*argv, "-o", str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    sheet, want = _png(tmp_path / "port.png"), _png(tmp_path / "jax.png")
    assert sheet.shape == want.shape == (64, 256, 4)
    assert int(np.abs(sheet - want).max()) <= U8_BAR
    assert not np.array_equal(sheet[:, :64], sheet[:, 128:192])  # the orbit's views differ

    gif = Image.open(tmp_path / "port.gif")
    assert gif.n_frames == 4 and gif.size == (64, 64)
    assert gif.info["loop"] == 0 and gif.info["duration"] == 120
    cloud = tcloud.test_model_3d(device="cpu")
    mn, mx = (t.numpy() for t in cloud.compute_aabb())
    center = (mn + mx) / 2.0
    radius = max(3.0 * float(np.abs(mx - mn).max()), 1.0)
    cams = [Camera.create(eye=tuple(center + radius * np.array([np.cos(t), 0.3, np.sin(t)])), target=tuple(center),
                          width=64, height=64, device="cpu") for t in 2.0 * np.pi * np.arange(4) / 4]
    frames = render_multi_camera(cloud, cams, device="cpu")
    for k in range(4):
        gif.seek(k)
        got = np.asarray(gif.convert("RGB")).astype(np.float64)
        view = to_srgb_u8(frames[k])
        np.testing.assert_array_equal(view, sheet[:, 64 * k:64 * (k + 1)])
        assert float(np.abs(got - view[..., :3]).max()) <= GIF_MAX_ERROR
    jgif = Image.open(tmp_path / "jax.gif")
    assert jgif.n_frames == gif.n_frames and jgif.size == gif.size
