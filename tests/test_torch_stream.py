"""PyTorch port, streaming and LOD (``stream/``) on the CPU against the JAX
package's ``stream/``: each case feeds both packages the same numpy cloud.

Slicing, LOD chains and streaming residency are host decisions, so the port
is held array-equal or bit-equal: chunk cells, AABBs and rows, importance
scores, the rows each LOD level keeps (ties at the ``k`` boundary included)
and its compensated opacity, ``select_lod`` over a grid of distances, the
manifest JSON, the chunks read across packages, and the resident ids after
each update of a camera path, with the loader thread and without.  Renders
hold the bars of tests/test_stream.py (concatenated chunks within 3e-5 of
the whole cloud) and of the port's other parity tests (a LOD level's
``render_tiled`` within 2e-5 of JAX's eager Pallas serving frame)."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu import stream as jstream
from bevy_gaussian_splatting_tpu.io.loader import load_cloud as jload_cloud
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.stream import lod as jlod
from bevy_gaussian_splatting_tpu.stream import scene as jscene
from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded, random_arrays_4d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
from bevy_gaussian_splatting_tpu_torch.stream import (
    StreamingCloudScene,
    build_lod_chain,
    concat_clouds,
    select_lod,
    slice_cloud,
)
from bevy_gaussian_splatting_tpu_torch.stream.lod import importance_scores
from bevy_gaussian_splatting_tpu_torch.stream.scene import MANIFEST, save_streaming_scene
from torch_port_cases import cameras, jax_cloud, torch_cloud

CONCAT_BAR = 3e-5  # tests/test_stream.py:46-60
IMAGE_BAR = 2e-5  # the port against JAX's eager serving frame


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(cloud) -> dict:
    return {f.name: _np(getattr(cloud, f.name)) for f in dataclasses.fields(cloud)}


def _assert_clouds_equal(port, jax) -> None:
    assert type(port).__name__ == type(jax).__name__
    want = _fields(jax)
    got = _fields(port)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@functools.lru_cache(maxsize=None)
def _arrays(kind: str) -> dict:
    """"random": the JAX tests' cloud (500 gaussians, seed 3); "boundary":
    positions on a lattice from -4.5 to 4.5 in steps of 0.75, so that cell
    boundaries fall on lattice points (with a grid of 6, x = 3.0 is in cell
    4 by the float64 product and in cell 5 by a float32 one); "ties": scores
    quantised so that many tie at every level's ``k`` boundary; "4d": a
    temporal cloud."""
    if kind == "4d":
        return random_arrays_4d_seeded(300, seed=4)
    a = random_arrays_3d_seeded(500, seed=3)
    if kind == "boundary":
        rng = np.random.default_rng(11)
        a["position_visibility"][:, :3] = rng.integers(0, 13, (500, 3)).astype(np.float32) * np.float32(0.75) - 4.5
    elif kind == "ties":
        a["scale_opacity"][:, :3] = np.float32(0.25)
        a["scale_opacity"][:, 3] = np.round(a["scale_opacity"][:, 3] * 4) / np.float32(4)
    return a


def _both(kind: str):
    a = _arrays(kind)
    return jax_cloud(a), torch_cloud(a)


@pytest.mark.parametrize("kind,grid", [
    ("random", (2, 2, 2)), ("random", (3, 1, 2)), ("boundary", (4, 4, 1)), ("boundary", (6, 5, 6)),
    ("4d", (2, 3, 1)),
])
def test_slice_matches_jax(kind, grid):
    jc, tc = _both(kind)
    want = jstream.slice_cloud(jc, grid=grid)
    got = slice_cloud(tc, grid=grid)
    assert [c.cell for c in got] == [c.cell for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.aabb_min, w.aabb_min)
        np.testing.assert_array_equal(g.aabb_max, w.aabb_max)
        assert g.aabb_min.dtype == w.aabb_min.dtype
        _assert_clouds_equal(g.cloud, w.cloud)
    assert sum(len(c) for c in got) == len(tc)
    merged = concat_clouds([c.cloud for c in got])
    _assert_clouds_equal(merged, jstream.concat_clouds([c.cloud for c in want]))
    kept = slice_cloud(tc, grid=grid, drop_empty=False)
    assert len(kept) == int(np.prod(grid))
    assert [len(c) for c in kept] == [len(c) for c in jstream.slice_cloud(jc, grid=grid, drop_empty=False)]


def test_concat_clouds_needs_a_cloud():
    with pytest.raises(ValueError):
        concat_clouds([])


@pytest.mark.parametrize("kind", ["random", "ties", "4d"])
def test_lod_chain_matches_jax(kind):
    jc, tc = _both(kind)
    scores = importance_scores(tc)
    want_scores = jlod.importance_scores(jc)
    assert scores.dtype == want_scores.dtype
    np.testing.assert_array_equal(scores.view(np.int32), want_scores.view(np.int32))
    for levels, ratio, compensate in ((3, 0.25, True), (4, 0.3, True), (2, 0.1, False), (3, 0.5, True)):
        got = build_lod_chain(tc, levels=levels, ratio=ratio, compensate=compensate)
        want = jstream.build_lod_chain(jc, levels=levels, ratio=ratio, compensate=compensate)
        assert [len(c) for c in got] == [len(c) for c in want]
        for g, w in zip(got, want):
            _assert_clouds_equal(g, w)  # rows and compensated opacity, bit for bit
    with pytest.raises(ValueError):
        build_lod_chain(tc, levels=0)


def test_select_lod_matches_jax_on_a_distance_grid():
    boxes = [(np.zeros(3), np.ones(3)), (np.array([-3.0, 2.0, -1.0]), np.array([5.0, 4.0, 7.5]))]
    steps = np.concatenate([[0.0, 0.5, 1.0, 1.9999999, 2.0, 2.0000001], np.geomspace(0.01, 1e7, 61)])
    for lo, hi in boxes:
        for axis in range(3):
            for d in steps:
                eye = (lo + hi) / 2
                eye[axis] = hi[axis] + d
                for levels in (1, 2, 4, 7):
                    for base in (0.5, 2.0, 40.0):
                        assert select_lod(lo, hi, eye, levels, base) == jstream.select_lod(lo, hi, eye, levels, base)
    # tests/test_stream.py's cases
    assert [select_lod(np.zeros(3), np.ones(3), p, 4, base_distance=2.0)
            for p in ((0.5, 0.5, 0.5), (0.0, 0.0, 2.5), (0.0, 0.0, 4.0), (0.0, 0.0, 9.0), (0.0, 0.0, 1e6))] \
        == [0, 0, 1, 3, 3]


@pytest.mark.parametrize("kind,grid", [("random", (3, 1, 1)), ("4d", (2, 2, 1))])
def test_streaming_scene_files_cross_packages(kind, grid, tmp_path):
    """The manifest JSON equal; each package opens the other's scene and
    reads its chunks bit for bit."""
    jc, tc = _both(kind)
    jchunks, tchunks = jstream.slice_cloud(jc, grid=grid), slice_cloud(tc, grid=grid)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jscene.save_streaming_scene(jchunks, str(jdir))
    path = save_streaming_scene(tchunks, str(tdir))
    assert path == os.path.join(str(tdir), MANIFEST)
    assert (tdir / MANIFEST).read_text() == (jdir / MANIFEST).read_text()
    for k, (tch, jch) in enumerate(zip(tchunks, jchunks)):
        name = f"chunk_{k:05d}.{'gc4d' if kind == '4d' else 'gcloud'}"
        _assert_clouds_equal(load_cloud(str(jdir / name), device="cpu"), jch.cloud)
        _assert_clouds_equal(tch.cloud, jload_cloud(str(tdir / name)))
    # the whole scene through each package's streaming scene, in the other's files
    port_on_jax = StreamingCloudScene(str(jdir), radius=1e9, background=False, device="cpu")
    jax_on_port = jscene.StreamingCloudScene(str(tdir), radius=1e9, background=False)
    for s in (port_on_jax, jax_on_port):
        s.update((0.0, 0.0, 0.0))
        s.wait_idle()
    _assert_clouds_equal(port_on_jax.resident_cloud(), jax_on_port.resident_cloud())
    _assert_clouds_equal(port_on_jax.resident_cloud(bucket=False), jstream.concat_clouds([c.cloud for c in jchunks]))


# a camera flown across tests/test_stream.py's three-chunk scene and back
PATH = [(-16.0, 0.0, 0.0), (-9.0, 1.0, 0.0), (-2.0, 0.0, 3.0), (4.0, 0.0, 0.0), (16.0, 0.0, 0.0), (30.0, 0.0, 0.0),
        (0.0, 0.0, 0.0), (-40.0, 0.0, 0.0), (-16.0, 0.0, 0.0)]


@pytest.mark.parametrize("background", [False, True])
def test_residency_along_a_camera_path_matches_jax(background, tmp_path):
    jc, tc = _both("random")
    save_streaming_scene(slice_cloud(tc, grid=(3, 1, 1)), str(tmp_path))
    port = StreamingCloudScene(str(tmp_path), radius=2.0, evict_factor=1.5, background=background, device="cpu")
    jax = jscene.StreamingCloudScene(str(tmp_path), radius=2.0, evict_factor=1.5, background=background)
    try:
        history = []
        for eye in PATH:
            for s in (port, jax):
                s.update(eye)
                s.wait_idle()
            assert port.resident_ids() == jax.resident_ids(), eye
            history.append(tuple(port.resident_ids()))
            got, want = port.resident_cloud(), jax.resident_cloud()
            assert (got is None) == (want is None)
            if got is not None:
                _assert_clouds_equal(got, want)
                n = len(got)
                assert n >= 256 and n & (n - 1) == 0
        assert len(set(history)) >= 3  # the path loads and evicts
    finally:
        worker = port._worker
        port.close()
        jax.close()
    if background:
        worker.join(timeout=10)
        assert not worker.is_alive()


def test_concurrent_updates_never_double_load(tmp_path):
    """Many threads moving the camera at once, with a tiny switch interval:
    a chunk is never loaded while it is resident or already loading (the
    membership check and the inflight mark share one critical section), and
    every resident chunk holds its file's rows."""
    import random
    import sys
    import threading

    _, tc = _both("random")
    save_streaming_scene(slice_cloud(tc, grid=(3, 3, 1)), str(tmp_path))
    scene = StreamingCloudScene(str(tmp_path), radius=6.0, evict_factor=1.2, background=True, device="cpu")
    guard, loading, faults = threading.Lock(), set(), []
    original = scene._load

    def checked_load(i):
        with guard:
            if i in loading or i in scene._resident:
                faults.append(i)
            loading.add(i)
        try:
            original(i)
        finally:
            with guard:
                loading.discard(i)

    scene._load = checked_load

    def fly(seed):
        rng = random.Random(seed)
        for _ in range(40):
            scene.update((rng.uniform(-25, 25), rng.uniform(-25, 25), 0.0))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fly, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        scene.wait_idle()
    finally:
        sys.setswitchinterval(interval)
        worker = scene._worker
        scene.close()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert faults == []
    for i in scene.resident_ids():
        want = load_cloud(str(tmp_path / scene.entries[i]["file"]), device="cpu")
        _assert_clouds_equal(scene._resident[i], want)


def test_loader_retries_a_failed_chunk(tmp_path):
    """A chunk whose file fails to load leaves no inflight mark: the
    synchronous path raises and the next update retries it."""
    _, tc = _both("random")
    save_streaming_scene(slice_cloud(tc, grid=(2, 1, 1)), str(tmp_path))
    os.rename(tmp_path / "chunk_00001.gcloud", tmp_path / "held.gcloud")
    s = StreamingCloudScene(str(tmp_path), radius=1e9, background=False, device="cpu")
    with pytest.raises(FileNotFoundError):
        s.update((0.0, 0.0, 0.0))
    os.rename(tmp_path / "held.gcloud", tmp_path / "chunk_00001.gcloud")
    s.update((0.0, 0.0, 0.0))
    s.wait_idle()
    assert s.resident_ids() == [0, 1]


def test_concatenated_chunks_render_as_the_whole_cloud():
    _, tc = _both("random")
    _, cam = cameras(64, 64)
    merged = concat_clouds([c.cloud for c in slice_cloud(tc, grid=(2, 2, 1))])
    s = CloudSettings()
    a = render_tiled(tc, cam, s, width=64, height=64)
    b = render_tiled(merged, cam, s, width=64, height=64)
    err = float((a - b).abs().max())
    assert err <= CONCAT_BAR, err
    assert float(a[..., 3].max()) > 0.1


def test_lod_level_render_matches_jax():
    jc, tc = _both("random")
    jcam, cam = cameras(64, 64, eye=(0.0, 0.0, 220.0))
    jlevel = jstream.build_lod_chain(jc, levels=2, ratio=0.3)[1]
    level = build_lod_chain(tc, levels=2, ratio=0.3)[1]
    settings = bgs.CloudSettings()
    bucket = jrt.pairs_budget(len(jlevel), int(jrt.pair_count(jlevel, jcam, settings)))
    want = np.asarray(jrt.render_tiled(jlevel, jcam, settings, differentiable=False, compositor="pallas",
                                       pairs_max=bucket))
    got = render_tiled(level, cam, CloudSettings(), pairs_max=bucket, differentiable=False)
    err = float(np.abs(_np(got) - want).max())
    assert err <= IMAGE_BAR, err
    assert float(want[..., 3].max()) > 0.05
    # the decimated level stays close to the full cloud from afar (tests/test_stream.py:189-202)
    full = render_tiled(tc, cam, CloudSettings(), differentiable=False)
    assert float((full - got).abs().mean()) < 0.02
    assert want.shape == tuple(got.shape)
