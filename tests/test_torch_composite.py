"""PyTorch port, tile compositor (plain version of csrc/tile_fwd.cu) and its
epilogue against the JAX package's Pallas forward kernel in interpret mode,
on the same pair-sorted parameters and tile ranges.  Bar: 2e-5 (the blend
associates differently: a sequential product against the kernel's lane
scan)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.pallas.tile_fwd import pallas_composite_tiles
from bevy_gaussian_splatting_tpu.ops.pallas import tile_fwd as jfwd
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tfwd
from torch_port_cases import cameras, cloud_arrays, jax_cloud, jax_splats

ATOL = 2e-5
BG = np.array([0.2, 0.1, 0.4, 1.0], np.float32)


@functools.lru_cache(maxsize=None)
def _pair_inputs(kind, n, seed, width, height):
    """Pair-sorted [P, 10] params and clipped tile ranges from the JAX
    package's own serving binning, as numpy."""
    jc, _ = cameras(width, height)
    settings = bgs.CloudSettings()
    cloud = jax_cloud(cloud_arrays(kind, n, seed))
    js = jax_splats(cloud, jc, settings)
    p_max = jrt.pairs_budget(n, int(jrt.pair_count(cloud, jc, settings)))
    g_s, tile_s, _, _ = jrt.bin_gaussians(js, settings, width, height, p_max, expand="pallas", interpret=True)
    h_pad = jrt.pad_to_tile(height)
    start, end = jrt.tile_ranges(tile_s, (width // 16) * (h_pad // 16))
    count = jnp.minimum(end - start, jrt.tile_budget(n))
    params = jrt.pack_raster_params(js, settings, width, height)[g_s]
    return np.asarray(params), np.asarray(start), np.asarray(count)


def _port(params, start, count, width, height, bg=None, chunk=None, y0=0, walked=None):
    h_pad = -(-height // 16) * 16
    tx = width // 16
    if chunk is None:
        chunk = tfwd.preferred_chunk(params.shape[0], tx * (h_pad // 16))
    raw = tfwd.composite_tiles_raw_plain(
        torch.tensor(params), torch.tensor(start), torch.tensor(count),
        tx, width, height, y0=y0, chunk=chunk, walked=walked,
    )
    img = tfwd.composite_epilogue(raw, None if bg is None else torch.from_numpy(bg), width, h_pad)
    return img[:height].numpy()


def _jax(params, start, count, width, height, bg=None, chunk=None, y0=None, full_height=None):
    h_pad = -(-height // 16) * 16
    img = pallas_composite_tiles(
        jnp.asarray(params), jnp.asarray(start), jnp.asarray(count), bgs.CloudSettings(),
        width, h_pad, background=None if bg is None else jnp.asarray(bg), interpret=True,
        chunk_size=chunk, y0=y0, full_height=height if full_height is None else full_height,
    )
    return np.asarray(img)[:height]


@pytest.mark.parametrize("height", [128, 120])
@pytest.mark.parametrize("with_bg", [False, True])
def test_plain_compositor_matches_pallas(height, with_bg):
    bg = BG if with_bg else None
    inputs = _pair_inputs("bench", 2000, 3, 128, height)
    got = _port(*inputs, 128, height, bg)
    ref = _jax(*inputs, 128, height, bg)
    assert got.shape == (height, 128, 4)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert (ref[..., 3] > 0.01).sum() > 1000


@pytest.mark.parametrize("chunk", [None, 128])
def test_plain_compositor_early_exit_between_chunks(chunk):
    # heavy occlusion: whole tiles saturate, and with ranges longer than one
    # chunk the between-chunk exit stops them early
    params, start, count = _pair_inputs("occluded", 1000, 4, 128, 128)
    walked = torch.zeros(start.shape[0], dtype=torch.int64)
    got = _port(params, start, count, 128, 128, chunk=chunk, walked=walked)
    ref = _jax(params, start, count, 128, 128, chunk=chunk)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    used = tfwd.preferred_chunk(params.shape[0], 64) if chunk is None else chunk
    prefix = start % 128
    multi = (count + prefix) > used
    assert multi.any(), "no tile spans more than one chunk"
    stopped = walked.numpy() < count
    assert (stopped & multi).any(), "the early exit never bound"
    # without the exit those pairs would still add visible light
    assert walked.sum() < count.sum()


def test_plain_compositor_band_offset():
    # band geometry: the first four tile rows rendered as rows 16.. of a
    # taller frame (y0, full_height) -- kept for multi-device bands
    params, start, count = _pair_inputs("wide", 400, 1, 128, 128)
    s, c = start[:32].copy(), count[:32].copy()
    raw = tfwd.composite_tiles_raw_plain(
        torch.tensor(params), torch.from_numpy(s), torch.from_numpy(c), 8, 128, 128, y0=16, chunk=512
    )
    got = tfwd.composite_epilogue(raw, None, 128, 64).numpy()
    ref = np.asarray(pallas_composite_tiles(
        jnp.asarray(params), jnp.asarray(s), jnp.asarray(c), bgs.CloudSettings(), 128, 64,
        interpret=True, chunk_size=512, y0=jnp.array([16], jnp.int32), full_height=128,
    ))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("p_max,tiles", [(16384, 64), (2_457_600, 1024), (2_457_600, 8160), (30_000, 64)])
def test_preferred_chunk(p_max, tiles):
    assert tfwd.preferred_chunk(p_max, tiles) == jfwd.preferred_chunk(p_max, tiles)


@pytest.mark.parametrize("width,height,y0", [(128, 128, 0), (128, 120, 0), (1920, 1080, 32)])
def test_pixel_coords_match_compiled_kernel_expressions(width, height, y0):
    # compiled, the JAX kernel's coordinate math is contracted into a fused
    # multiply-add; the port computes that fused form exactly
    tx = width // 16
    coords = jax.jit(functools.partial(jfwd._tile_pixel_coords, tx_count=tx, width=width, full_height=height))
    tids = list(range(0, tx * (-(-height // 16)), 37))
    px, py = tfwd.tile_pixel_coords(torch.tensor(tids), tx, width, height, y0)
    for row, ti in enumerate(tids):
        a, b = coords(jnp.int32(ti), y0=jnp.int32(y0))
        np.testing.assert_array_equal(px[row].numpy(), np.asarray(a)[:, 0])
        np.testing.assert_array_equal(py[row].numpy(), np.asarray(b)[:, 0])


def test_epilogue_background():
    rng = np.random.default_rng(0)
    raw = rng.uniform(0, 1, (4 * 3, 8, 256)).astype(np.float32)
    for bg in (None, BG):
        ref = jfwd.composite_epilogue(
            jnp.asarray(raw.reshape(-1, 256)), None if bg is None else jnp.asarray(bg), 64, 48
        )
        got = tfwd.composite_epilogue(
            torch.from_numpy(raw[:, :4].copy()), None if bg is None else torch.from_numpy(bg), 64, 48
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7, rtol=0)
    full = rng.uniform(0, 1, (48, 64, 4)).astype(np.float32)
    ref = jfwd.composite_epilogue(jnp.asarray(raw.reshape(-1, 256)), jnp.asarray(full), 64, 48)
    got = tfwd.composite_epilogue(torch.from_numpy(raw[:, :4].copy()), torch.from_numpy(full), 64, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7, rtol=0)


def test_compositor_checks_inputs():
    p = torch.zeros(10, 10)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tfwd.composite_tiles_raw(torch.zeros(10, 9), s, s, 2, 32, 32)
    with pytest.raises(TypeError):
        tfwd.composite_tiles_raw(p.double(), s, s, 2, 32, 32)
    with pytest.raises(TypeError):
        tfwd.composite_tiles_raw(p, s.long(), s, 2, 32, 32)
    with pytest.raises(ValueError):
        tfwd.composite_tiles_raw(p, s, s, 2, 32, 32, chunk=1024)
    assert tfwd.composite_tiles_raw.launches == 0
