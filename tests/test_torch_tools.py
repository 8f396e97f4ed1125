"""PyTorch port, the tool CLIs (``tools/``) and the streaming example on the
CPU, each called in-process through ``main(argv)`` beside the JAX package's
tool on the same arguments.

``ply_to_gcloud --filter-sparse`` keeps the same rows (the JAX loader
normalises PLY quaternions in C++, one ulp apart from numpy: rotations
within 1e-6, every other field array-equal).  ``compare_aabb_obb`` and
``surfel_plane`` PNGs are within one u8 level of the JAX tools' (the
turntable is tests/test_torch_turntable.py).  ``render_thumbnails`` reports
a failing example and renders the rest, ``build_www`` writes JAX's page for
the port's viewer, and ``streaming_lod`` runs and picks JAX's levels."""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from bevy_gaussian_splatting_tpu.io.loader import load_cloud as jload_cloud
from bevy_gaussian_splatting_tpu.stream import build_lod_chain as jbuild_lod_chain
from bevy_gaussian_splatting_tpu.stream import select_lod as jselect_lod
from bevy_gaussian_splatting_tpu.stream import slice_cloud as jslice_cloud
from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud, save_cloud
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.tools import (
    build_www,
    compare_aabb_obb,
    ply_to_gcloud,
    render_thumbnails,
    surfel_plane,
)
from torch_port_cases import jax_cloud, torch_cloud

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U8_BAR = 1


def _jax_tool(name: str):
    """A script of the JAX package's ``tools/`` or ``examples/`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{os.path.basename(name)}", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGBA")).astype(np.int32)


def _assert_png_close(got, want) -> None:
    a, b = _png(got), _png(want)
    assert a.shape == b.shape
    assert int(np.abs(a - b).max()) <= U8_BAR
    assert int(a[..., :3].max()) > 0


def test_ply_to_gcloud_filter_sparse_matches_jax(tmp_path):
    a = random_arrays_3d_seeded(3000, seed=9)
    rng = np.random.default_rng(9)
    # dense clusters (kept) and scattered points (filtered)
    centers = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    pos = centers[rng.integers(0, 40, 3000)] + rng.normal(0, 0.02, (3000, 3)).astype(np.float32)
    pos[::7] = rng.uniform(-3, 3, (len(pos[::7]), 3))
    a["position_visibility"][:, :3] = pos
    ply = str(tmp_path / "in.ply")
    save_cloud(torch_cloud(a), ply)
    jtool = _jax_tool("tools/ply_to_gcloud")
    argv = ["--filter-sparse", "--radius", "0.06", "--neighbor-threshold", "3"]
    assert jtool.main([ply, str(tmp_path / "jax.gcloud"), *argv]) == 0
    assert ply_to_gcloud.main([ply, str(tmp_path / "port.gcloud"), *argv, "--device", "cpu"]) == 0
    got = load_cloud(str(tmp_path / "port.gcloud"), device="cpu")
    want = jload_cloud(str(tmp_path / "jax.gcloud"))
    assert 1000 < len(got) == len(want) < 3000
    for name in ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity"):
        # both loaders decode the PLY natively, from the same source and flags
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # default output names, without the filter
    assert ply_to_gcloud.main([ply, "--npz", "--device", "cpu"]) == 0
    assert len(load_cloud(str(tmp_path / "in.npz"), device="cpu")) == len(jload_cloud(ply))


@pytest.mark.parametrize("tool", ["compare_aabb_obb", "surfel_plane"])
def test_side_by_side_tools_match_jax(tool, tmp_path):
    port_tool = {"compare_aabb_obb": compare_aabb_obb, "surfel_plane": surfel_plane}[tool]
    argv = ["--size", "96"]
    assert _jax_tool(f"tools/{tool}").main([*argv, "-o", str(tmp_path / "jax.png")]) == 0
    assert port_tool.main([*argv, "-o", str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    _assert_png_close(tmp_path / "port.png", tmp_path / "jax.png")
    assert _png(tmp_path / "port.png").shape == (96, 192, 4)


def test_render_thumbnails_reports_failures(tmp_path, capsys):
    manifest = tmp_path / "m.json"
    manifest.write_text('{"examples": ['
                        '{"id": "ok", "args": ["--test-model", "--eye", "1.2", "1.5", "3"]},'
                        '{"id": "broken", "args": ["--input-cloud", "missing.gcloud"]},'
                        '{"id": "dark", "args": ["--test-model", "--eye", "1.2", "1.5", "3", "--global-opacity", "0"]}'
                        ']}')
    out = tmp_path / "thumbs"
    assert render_thumbnails.main(["--manifest", str(manifest), "--out-dir", str(out), "--size", "32",
                                   "--device", "cpu"]) == 1
    text = capsys.readouterr().out
    assert re.search(r"\[ok\] ok: \d+ non-black pixels", text)
    assert "[FAIL] broken" in text and "[FAIL] dark" in text and "2 example(s) failed" in text
    assert os.path.exists(out / "ok.png")
    # the repository's manifest, one example; no default output into the repository
    assert render_thumbnails.main(["--out-dir", str(out), "--size", "32", "--only", "aabb-bounds",
                                   "--device", "cpu"]) == 0
    assert _png(out / "aabb-bounds.png").shape == (32, 32, 4)
    for tool in (render_thumbnails, build_www):
        with pytest.raises(SystemExit):
            tool.main(["--device", "cpu"])


def test_build_www_page_only(tmp_path):
    manifest = os.path.join(ROOT, "examples", "examples.json")
    assert build_www.main(["--out", str(tmp_path), "--no-render"]) == 0
    page = (tmp_path / "index.html").read_text()
    jpage = _jax_tool("tools/build_www").build_page(__import__("json").load(open(manifest)))
    assert page == jpage.replace("bevy_gaussian_splatting_tpu.viewer", "bevy_gaussian_splatting_tpu_torch.viewer") \
        .replace("bevy_gaussian_splatting_tpu —", "bevy_gaussian_splatting_tpu_torch —") \
        .replace("server-rendered on TPU", "server-rendered on the card").replace("--gallery www", "--gallery DIR")
    assert (tmp_path / "examples" / "examples.json").read_text() == open(manifest).read()


def test_streaming_lod_example_matches_jax(tmp_path, monkeypatch, capsys):
    """The flyby's level picks and resident counts per frame are JAX's
    (its chunks, chains and ``select_lod`` on the same cloud); each frame
    writes a lit PNG."""
    from bevy_gaussian_splatting_tpu_torch.examples import streaming_lod

    n, frames = 3000, 6
    monkeypatch.setenv("FLY_N", str(n))
    monkeypatch.setenv("FLY_FRAMES", str(frames))
    monkeypatch.setenv("FLY_SIZE", "48")
    monkeypatch.setenv("FLY_OUT", str(tmp_path))
    assert streaming_lod.main(["--device", "cpu"]) == 0
    got = re.findall(r"levels=\[([0-9, ]+)\] gaussians=(\d+)", capsys.readouterr().out)
    chunks = jslice_cloud(jax_cloud(random_arrays_3d_seeded(n, seed=0)), grid=(2, 2, 2))
    chains = [jbuild_lod_chain(c.cloud, levels=3, ratio=0.3) for c in chunks]
    want = []
    for f in range(frames):
        eye = (0.0, 0.0, 120.0 - 18.0 * f)
        picks = [jselect_lod(c.aabb_min, c.aabb_max, eye, 3, base_distance=40.0) for c in chunks]
        want.append((", ".join(map(str, picks)), str(sum(len(chains[i][lv]) for i, lv in enumerate(picks)))))
    assert got == want
    assert len({p for p, _ in got}) >= 2  # the flyby changes levels
    for f in range(frames):
        a = _png(tmp_path / f"flyby_{f:02d}.png")
        assert a.shape == (48, 48, 4) and int(a[..., :3].max()) > 0


def test_tool_runs_as_a_module(tmp_path):
    """``python -m`` on a tool, in a process of its own (the file's one
    subprocess)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out_png = str(tmp_path / "s.png")
    r = subprocess.run([sys.executable, "-m", "bevy_gaussian_splatting_tpu_torch.tools.surfel_plane", "--device",
                        "cpu", "--size", "32", "-o", out_png], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert _png(out_png).shape == (32, 64, 4)
