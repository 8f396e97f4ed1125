"""PyTorch port, the headless CLI (``viewer/headless.py``) on the CPU against
the JAX package's CLI, both called in-process through ``main(argv)``.

The JAX CLI renders through ``render()``, which jits its frame, and XLA's
fused multiply-adds move the OBB edges that rounding decides: on the test
model at 512x512 the jitted frame is 9 u8 levels off the eager one in 14
pixels (CPU).  The port is held to the JAX CLI with its frame run eagerly
(``render_tiled(compositor="pallas", differentiable=False)`` at
``render()``'s budget, as tests/test_torch_scene.py does): within one u8
level at every pixel, and the same non-black count, 19,195, which
``VERDICT.md:5`` records for the JAX CLI (its jitted frame gives the same
count)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.render import api as japi
from bevy_gaussian_splatting_tpu.viewer import headless as jheadless
from bevy_gaussian_splatting_tpu_torch.io.loader import save_cloud
from bevy_gaussian_splatting_tpu_torch.io.scene import write_khr_gaussian_scene_glb
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.stream import slice_cloud
from bevy_gaussian_splatting_tpu_torch.stream.scene import save_streaming_scene
from bevy_gaussian_splatting_tpu_torch.viewer import headless
from torch_port_cases import torch_cloud

TEST_MODEL_NON_BLACK = 19_195  # VERDICT.md:5, the JAX CLI at 512x512
U8_BAR = 1


def _jax_eager_render(cloud, camera, settings, model_transform=None, background=None, impl="auto"):
    """The JAX serving frame, run eagerly at ``render()``'s budget."""
    bucket = jrt.pairs_budget(len(cloud), int(jrt.pair_count(cloud, camera, settings, model_transform)))
    return jrt.render_tiled(cloud, camera, settings, model_transform, background, differentiable=False,
                            compositor="pallas", pairs_max=bucket)


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGBA")).astype(np.int32)


def _non_black(out: str) -> int:
    return int(re.search(r"(\d+) non-black pixels", out).group(1))


def _run_both(argv, tmp_path, capsys, monkeypatch):
    """The port's and the JAX CLI's PNG for ``argv`` and their non-black
    counts."""
    monkeypatch.setattr(japi, "render", _jax_eager_render)
    port_png, jax_png = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert headless.main([*argv, "--device", "cpu", "-o", port_png]) == 0
    port_out = capsys.readouterr().out
    assert jheadless.main([*argv, "-o", jax_png]) == 0
    jax_out = capsys.readouterr().out
    return _png(port_png), _png(jax_png), _non_black(port_out), _non_black(jax_out), port_out


def test_test_model_png_matches_jax_cli(tmp_path, capsys, monkeypatch):
    got, want, n_port, n_jax, _ = _run_both(["--test-model", "--width", "512", "--height", "512"], tmp_path,
                                            capsys, monkeypatch)
    assert got.shape == want.shape == (512, 512, 4)
    assert int(np.abs(got - want).max()) <= U8_BAR
    assert n_port == n_jax == TEST_MODEL_NON_BLACK


def test_streaming_source(tmp_path, capsys):
    """``--input-stream``: the chunks within the radius of the eye (the
    resident set is held to JAX's in tests/test_torch_stream.py), padded,
    rendered bit for bit as ``render()`` renders that set."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.render.api import render
    from bevy_gaussian_splatting_tpu_torch.stream import StreamingCloudScene
    from bevy_gaussian_splatting_tpu_torch.utils.image import to_srgb_u8

    cloud = torch_cloud(random_arrays_3d_seeded(600, seed=2))
    save_streaming_scene(slice_cloud(cloud, grid=(3, 1, 1)), str(tmp_path / "scene"))
    eye, target = (-14.0, 0.0, 30.0), (-14.0, 0.0, 0.0)
    argv = ["--input-stream", str(tmp_path / "scene"), "--stream-radius", "13", "--eye", *map(str, eye),
            "--target", *map(str, target), "--width", "64", "--height", "48", "--device", "cpu",
            "-o", str(tmp_path / "s.png")]
    assert headless.main(argv) == 0
    out = capsys.readouterr().out
    assert "streaming: 2/3 chunks resident (512 gaussians padded)" in out
    scene = StreamingCloudScene(str(tmp_path / "scene"), radius=13.0, background=False, device="cpu")
    scene.update(eye)
    want = render(scene.resident_cloud(), Camera.create(eye=eye, target=target, width=64, height=48, device="cpu"),
                  device="cpu")
    np.testing.assert_array_equal(_png(tmp_path / "s.png"), to_srgb_u8(want))
    assert _non_black(out) > 0


def test_other_sources_and_benchmark(tmp_path, capsys):
    """A cloud file, a GLB scene, a random 4DGS cloud and 2DGS surfels each
    write a lit PNG; ``--benchmark`` reports its steady-state frame."""
    cloud = torch_cloud(random_arrays_3d_seeded(300, seed=4))
    save_cloud(cloud, str(tmp_path / "c.gcloud"))
    write_khr_gaussian_scene_glb([("c", cloud, np.eye(4, dtype=np.float32))], str(tmp_path / "s.glb"))
    cases = [
        ["--input-cloud", str(tmp_path / "c.gcloud"), "--eye", "0", "0", "60", "--benchmark", "2"],
        ["--input-scene", str(tmp_path / "s.glb"), "--eye", "0", "0", "60", "--aabb"],
        ["--gaussian-count", "300", "--seed", "3", "--eye", "0", "0", "60", "--gaussian-mode", "gaussian_4d",
         "--time", "0.5"],
        ["--test-model", "--eye", "1.2", "1.5", "3", "--gaussian-mode", "gaussian_2d"],
        ["--test-model", "--eye", "1.2", "1.5", "3", "--rasterize-mode", "depth", "--impl", "oracle"],
    ]
    for k, argv in enumerate(cases):
        out_png = str(tmp_path / "out" / f"{k}.png")
        assert headless.main([*argv, "--width", "64", "--height", "64", "--device", "cpu", "-o", out_png]) == 0
        out = capsys.readouterr().out
        assert _non_black(out) > 0, argv
        assert _png(out_png).shape == (64, 64, 4)
        if "--benchmark" in argv:
            assert re.search(r"steady state: [0-9.]+ ms/frame", out)


def test_empty_stream_and_missing_card(tmp_path, capsys):
    cloud = torch_cloud(random_arrays_3d_seeded(100, seed=1))
    save_streaming_scene(slice_cloud(cloud, grid=(1, 1, 1)), str(tmp_path))
    argv = ["--input-stream", str(tmp_path), "--stream-radius", "1", "--eye", "0", "0", "500", "--device", "cpu",
            "-o", str(tmp_path / "x.png")]
    assert headless.main(argv) == 1
    assert "no chunks within --stream-radius" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card is the default; nothing falls back
            headless.main(["--test-model", "-o", str(tmp_path / "y.png")])


def test_runs_as_a_module(tmp_path):
    """``python -m`` on the CLI, in a process of its own (the file's one
    subprocess)."""
    out_png = str(tmp_path / "m.png")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "bevy_gaussian_splatting_tpu_torch.viewer.headless", "--device", "cpu",
         "--test-model", "--width", "64", "--height", "64", "-o", out_png],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert _non_black(r.stdout) > 0 and os.path.exists(out_png)
