"""PyTorch port, frame-coherent serving (``render/api.py``
``InteractiveRenderer``, ``make_replay_pipeline``, ``render_orbit``) on the
CPU, mirroring tests/test_interactive.py: each case runs the JAX package's
``InteractiveRenderer`` and the port's on the same numpy scene.  The port is
held to the JAX test's own bars against itself, its ``stats`` must equal the
JAX renderer's, and its images must match the JAX renderer's within 2e-5,
or within JAX's own spread where they do not: the scene of the JAX tests
has splats whose OBB clip edge is decided by rounding (JAX's own image
moves 0.12 in about 100 pixels under a one-ulp change of every scale or
rotation), and such an edge may land on the other side of a pixel in the
port.  Such a frame may then be no further off, in no more pixels, than
JAX moves under one of those changes.

Also the sort throttle ``SortSchedule`` (tests/test_aux.py:43-60), the radix
digit bookkeeping (tests/test_ops.py:186-197) and ``sort_gaussians_radix``."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import sort as jsort
from bevy_gaussian_splatting_tpu.render import api as japi
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.models.camera import orbit_camera_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded, random_arrays_4d_seeded
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops import sort as tsort
from bevy_gaussian_splatting_tpu_torch.render import api as tapi
from torch_port_cases import cameras, jax_cloud, torch_cloud

CROSS_BAR = 2e-5  # the port against the JAX package, where JAX's own spread is smaller
EYE0 = (0.0, 0.0, 60.0)
SETTINGS_4D = (
    bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_4D),
    tsettings.CloudSettings(gaussian_mode=tsettings.GaussianMode.GAUSSIAN_4D),
)
# the JAX renderers share their compiled pipelines (every one here replays
# in the JAX package's default pair order), so that each case compiles once
_JAX_PIPES: dict = {}
_JAX_ONESHOTS: dict = {}


@pytest.fixture(autouse=True)
def _fresh_budgets():
    japi._BUDGET_STATE.clear()
    tapi._BUDGET_STATE.clear()


@functools.lru_cache(maxsize=None)
def _arrays(n=1024, seed=0, four_d=False) -> dict:
    return random_arrays_4d_seeded(n, seed) if four_d else random_arrays_3d_seeded(n, seed)


def _scene(n=1024, seed=0, four_d=False):
    """The JAX tests' scene (``random_gaussians_3d_seeded(n, seed)``) in both
    packages."""
    a = _arrays(n, seed, four_d)
    return jax_cloud(a), torch_cloud(a)


def _renderers(four_d=False, **kw):
    js, ts = SETTINGS_4D if four_d else (None, None)
    jr = japi.InteractiveRenderer(js, **kw)
    jr._pipes, jr._oneshots = _JAX_PIPES, _JAX_ONESHOTS
    return jr, tapi.InteractiveRenderer(ts, device="cpu", **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _perturbed(arrays: dict, field: str, k: int) -> dict:
    out = dict(arrays)
    x = arrays[field].copy()
    cols = slice(0, 3) if field == "scale_opacity" else slice(None)
    x[:, cols] = np.nextafter(x[:, cols], np.float32(np.inf if k > 0 else -np.inf))
    out[field] = x
    return out


@functools.lru_cache(maxsize=None)
def _jax_spread(n, seed, four_d, eye, time) -> tuple:
    """How far JAX's ``render(impl="tiled")`` image moves when every scale,
    or every rotation, moves one ulp up or down: the largest change of a
    pixel, and the most pixels that one such change moves past
    ``CROSS_BAR``."""
    a = _arrays(n, seed, four_d)
    jc, _ = cameras(64, 64, eye)
    js = SETTINGS_4D[0].replace(time=time) if four_d else bgs.CloudSettings()
    base = _np(japi.render(jax_cloud(a), jc, js, impl="tiled"))
    rot = "isotropic_rotations" if four_d else "rotation"
    largest, moved = 0.0, 0
    for field in ("scale_opacity", rot):
        for k in (1, -1):
            img = _np(japi.render(jax_cloud(_perturbed(a, field, k)), jc, js, impl="tiled"))
            err = np.abs(img - base).max(axis=-1)
            largest, moved = max(largest, float(err.max())), max(moved, int((err > CROSS_BAR).sum()))
    return largest, moved


def _assert_matches_jax(got, want, n=1024, seed=0, four_d=False, eye=EYE0, time=0.0):
    """Within ``CROSS_BAR``, or within JAX's own spread: no pixel further
    off than JAX moves one, and no more pixels past the bar than JAX moves."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max(axis=-1)
    if err.max() <= CROSS_BAR:
        return
    largest, moved = _jax_spread(n, seed, four_d, eye, time)
    assert err.max() <= largest, f"{err.max():.3e} past JAX's own spread {largest:.3e}"
    assert (err > CROSS_BAR).sum() <= moved, f"{(err > CROSS_BAR).sum()} pixels past {CROSS_BAR}, JAX moves {moved}"


class TestInteractiveRenderer:
    def test_fresh_bins_match_full_pipeline(self):
        jcloud, tcloud = _scene()
        jc, tc = cameras(64, 64)
        jr, tr = _renderers()
        want = jr.render(jcloud, jc)
        got = tr.render(tcloud, tc)
        np.testing.assert_allclose(_np(got), _np(tapi.render(tcloud, tc, impl="tiled", device="cpu")), atol=2e-6)
        assert tr.stats == jr.stats == {"bins": 1, "replays": 0, "oneshots": 0}
        _assert_matches_jax(got, want)
        # the budget is counted once, under the renderer's own key
        key = tapi.budget_key("interactive", tr.settings, 64, 64, tcloud, tr.device)
        pairs = int(trt.pair_count(tcloud, tc, tr.settings))
        assert tapi._BUDGET_STATE[key] == (trt.pairs_budget(len(tcloud), pairs), 0)

    def test_replay_same_camera_is_exact_and_cached(self):
        jcloud, tcloud = _scene()
        jc, tc = cameras(64, 64)
        jr, tr = _renderers()
        jr.render(jcloud, jc)
        want = jr.render(jcloud, jc)
        first = _np(tr.render(tcloud, tc))
        second = _np(tr.render(tcloud, tc))
        np.testing.assert_array_equal(first, second)
        assert tr.stats == jr.stats == {"bins": 1, "replays": 1, "oneshots": 0}
        _assert_matches_jax(second, want)

    def test_stale_bins_after_subthreshold_motion(self):
        """Within the throttle period a moved camera replays the stale bins
        with a fresh projection, close to a fresh render."""
        jcloud, tcloud = _scene()
        jc0, tc0 = cameras(64, 64)
        jc1, tc1 = cameras(64, 64, (1e-4, 0.0, 60.0))
        jr, tr = _renderers(period_floor_ms=1e9)  # never re-bin on motion
        jr.render(jcloud, jc0)
        tr.render(tcloud, tc0)
        want = jr.render(jcloud, jc1)
        stale = _np(tr.render(tcloud, tc1))
        assert tr.stats == jr.stats == {"bins": 1, "replays": 1, "oneshots": 0}
        fresh = _np(tapi.render(tcloud, tc1, impl="tiled", device="cpu"))
        assert np.isfinite(stale).all()
        np.testing.assert_allclose(stale, fresh, atol=2e-3)
        _assert_matches_jax(stale, want, eye=(1e-4, 0.0, 60.0))

    def test_elapsed_motion_rebins(self):
        jcloud, tcloud = _scene()
        jc0, tc0 = cameras(64, 64)
        eye = (5.0, 0.0, 60.0)
        jc1, tc1 = cameras(64, 64, eye)
        jr, tr = _renderers(period_floor_ms=0.0)
        jr.render(jcloud, jc0)
        tr.render(tcloud, tc0)
        jr.period_ms = tr.period_ms = 0.0  # the first bin resets the period to the floor; force the next
        want = jr.render(jcloud, jc1)
        img = _np(tr.render(tcloud, tc1))
        assert tr.stats == jr.stats and tr.stats["bins"] == 2
        np.testing.assert_allclose(img, _np(tapi.render(tcloud, tc1, impl="tiled", device="cpu")), atol=2e-6)
        _assert_matches_jax(img, want, eye=eye)

    def test_time_change_rebins(self):
        jcloud, tcloud = _scene(512, 1, four_d=True)
        jc, tc = cameras(64, 64)
        jr, tr = _renderers(four_d=True, period_floor_ms=1e9)
        jr.render(jcloud, jc, time=0.0)
        tr.render(tcloud, tc, time=0.0)
        # a time change renders in one pass, sorted again for the frame
        want = jr.render(jcloud, jc, time=0.25)
        img = _np(tr.render(tcloud, tc, time=0.25))
        assert tr.stats == jr.stats == {"bins": 1, "replays": 0, "oneshots": 1}
        ref = tapi.render(tcloud, tc, SETTINGS_4D[1].replace(time=0.25), impl="tiled", device="cpu")
        np.testing.assert_allclose(img, _np(ref), atol=2e-6)
        _assert_matches_jax(img, want, 512, 1, True, time=0.25)
        # a settled time bins once, bit for bit the one-pass frame, then replays
        jr.render(jcloud, jc, time=0.25)
        img2 = _np(tr.render(tcloud, tc, time=0.25))
        assert tr.stats == jr.stats == {"bins": 2, "replays": 0, "oneshots": 1}
        np.testing.assert_array_equal(img2, img)
        jr.render(jcloud, jc, time=0.25)
        img3 = _np(tr.render(tcloud, tc, time=0.25))
        assert tr.stats == jr.stats and tr.stats["replays"] == 1
        np.testing.assert_array_equal(img3, img2)

    def test_cloud_change_rebins(self):
        jc, tc = cameras(64, 64)
        jr, tr = _renderers(period_floor_ms=1e9)
        jr.render(_scene(seed=0)[0], jc)
        tr.render(_scene(seed=0)[1], tc)
        jcloud, tcloud = _scene(seed=3)
        want = jr.render(jcloud, jc)
        img = _np(tr.render(tcloud, tc))
        assert tr.stats == jr.stats and tr.stats["bins"] == 2
        np.testing.assert_allclose(img, _np(tapi.render(tcloud, tc, impl="tiled", device="cpu")), atol=2e-6)
        _assert_matches_jax(img, want, seed=3)


def _jax_replay(settings, jcloud, jc0, jc1, pair_order: bool, pairs_max: int = 8192):
    """The JAX package's replay at ``jc1`` from bins at ``jc0``, in either of
    its forms (the port has the gather form only)."""
    bin_fn, replay_fn = japi.make_replay_pipeline(settings, 64, 64, "xla", pairs_max, pair_order)[:2]
    eye4, t0 = jnp.eye(4), jnp.float32(0.0)
    bins = bin_fn(jcloud, jc0, eye4, t0)
    return _np(replay_fn(jcloud, jc1, eye4, jnp.zeros((4,), jnp.float32), t0, *bins))


class TestReplayPipeline:
    def test_replay_matches_jax_pair_order_and_gather_replays(self):
        """The port's one replay form (a gather of the packed rows by
        ``g_s``) against both of the JAX package's: its default pair order
        (project the pair-gathered cloud rows) and its gather replay."""
        jcloud, tcloud = _scene()
        jc0, tc0 = cameras(64, 64)
        jc1, tc1 = cameras(64, 64, (1e-4, 0.0, 60.0))  # a replay with stale bins
        bucket = trt.pairs_budget(len(tcloud), int(trt.pair_count(tcloud, tc0, tsettings.CloudSettings())))
        bin_fn, replay_fn = tapi.make_replay_pipeline(tsettings.CloudSettings(), 64, 64, bucket)[:2]
        got = _np(replay_fn(tcloud, tc1, None, None, 0.0, *bin_fn(tcloud, tc0)))
        tr = _renderers(period_floor_ms=1e9)[1]
        tr.render(tcloud, tc0)
        np.testing.assert_array_equal(_np(tr.render(tcloud, tc1)), got)
        for pair_order in (True, False):
            want = _jax_replay(bgs.CloudSettings(), jcloud, jc0, jc1, pair_order, bucket)
            _assert_matches_jax(got, want, eye=(1e-4, 0.0, 60.0))

    @pytest.mark.parametrize("mode", ["POSITION", "DEPTH"])
    def test_replay_ramps_match_jax_gather_replay(self, mode):
        """POSITION's box and DEPTH's range reduce over the cloud, also
        where the cloud's extreme gaussians lie outside the view and own no
        pair: the port's replay against the JAX package's gather replay
        (its pair-order replay takes POSITION's box from the pair rows, and
        there differs from its own gather replay in 3,746 of 4,096
        pixels)."""
        jcloud, tcloud = _scene(512)
        jsettings = bgs.CloudSettings(rasterize_mode=bgs.RasterizeMode[mode])
        settings = tsettings.CloudSettings(rasterize_mode=tsettings.RasterizeMode[mode])
        jc0, tc0 = cameras(64, 64, (0.0, 0.0, 8.0))
        jc1, tc1 = cameras(64, 64, (1e-4, 0.0, 8.0))
        bin_fn, replay_fn = tapi.make_replay_pipeline(settings, 64, 64, 8192)[:2]
        got = _np(replay_fn(tcloud, tc1, None, None, 0.0, *bin_fn(tcloud, tc0)))
        assert np.isfinite(got).all() and (got[..., 3] > 0).any()
        np.testing.assert_allclose(got, _jax_replay(jsettings, jcloud, jc0, jc1, False), atol=CROSS_BAR)

    def test_bins_match_jax(self):
        """``bin_fn`` gives the JAX package's five binning artifacts in its
        order, array-equal to its gather form's and to the first five of its
        pair-order form's (which adds the pair-gathered cloud rows)."""
        jcloud, tcloud = _scene(512)
        jc, tc = cameras(64, 64)
        tbins = tapi.make_replay_pipeline(tsettings.CloudSettings(), 64, 64, 8192)[0](tcloud, tc)
        assert len(tbins) == 5
        valid = _np(tbins[1])
        for pair_order, n_bins in ((False, 5), (True, 6)):
            jbins = japi.make_replay_pipeline(bgs.CloudSettings(), 64, 64, "xla", 8192, pair_order)[0](
                jcloud, jc, jnp.eye(4), jnp.float32(0.0)
            )
            assert len(jbins) == n_bins
            np.testing.assert_array_equal(valid, np.asarray(jbins[1]))
            # slots past the pair total: cloud index 0 here, any in-range index in JAX
            np.testing.assert_array_equal(_np(tbins[0])[valid], np.asarray(jbins[0])[valid])
            for j, t in zip(jbins[2:5], tbins[2:5]):
                np.testing.assert_array_equal(_np(t), np.asarray(j))


class TestRenderOrbit:
    def _eye(self, az, el, radius):
        return (
            radius * math.cos(el) * math.sin(az),
            radius * math.sin(el),
            radius * math.cos(el) * math.cos(az),
        )

    def test_orbit_matches_host_camera_render(self):
        """The orbit camera built on the device against a host-built camera,
        at the JAX test's bars (its op order differs in the last bits)."""
        jcloud, tcloud = _scene()
        az, el, radius = 0.35, 0.2, 60.0
        jr, tr = _renderers()
        want = _np(jr.render_orbit(jcloud, az, el, radius, width=64, height=64))
        got = _np(tr.render_orbit(tcloud, az, el, radius, width=64, height=64))
        _, tc = cameras(64, 64, self._eye(az, el, radius))
        host = _np(tapi.render(tcloud, tc, impl="tiled", device="cpu"))
        for ref in (host, want):
            diff = np.abs(got - ref)
            assert float(diff.mean()) < 1e-3
            assert float((diff < 1e-2).mean()) > 0.995
        assert tr.stats == jr.stats == {"bins": 1, "replays": 0, "oneshots": 0}

    def test_orbit_honors_non_tiled_impl(self):
        jcloud, tcloud = _scene(512)
        az, el, radius = 0.3, 0.2, 60.0
        jr, tr = _renderers(impl="oracle")
        want = _np(jr.render_orbit(jcloud, az, el, radius, width=64, height=64))
        got = _np(tr.render_orbit(tcloud, az, el, radius, width=64, height=64))
        # the renderer's camera: the orbit's, built on the device as every
        # render_orbit frame's is
        tc = orbit_camera_device(torch.tensor([az, el, radius, 0.0, 0.0, 0.0]), 64, 64)
        np.testing.assert_allclose(got, _np(tapi.render(tcloud, tc, impl="oracle", device="cpu")), atol=1e-6)
        # no replay pipeline: a one-pass frame, which the port counts and JAX does not
        assert jr.stats == {"bins": 0, "replays": 0, "oneshots": 0}
        assert tr.stats == {"bins": 0, "replays": 0, "oneshots": 1}
        np.testing.assert_allclose(got, want, atol=CROSS_BAR)

    def test_orbit_replay_reuses_bins(self):
        jcloud, tcloud = _scene()
        jr, tr = _renderers(period_floor_ms=1e9)
        for az in (0.0, 1e-4):
            want = _np(jr.render_orbit(jcloud, az, 0.3, 60.0, width=64, height=64))
            img = _np(tr.render_orbit(tcloud, az, 0.3, 60.0, width=64, height=64))
        assert tr.stats == jr.stats == {"bins": 1, "replays": 1, "oneshots": 0}
        assert np.isfinite(img).all()
        diff = np.abs(img - want)
        assert float(diff.mean()) < 1e-3 and float((diff < 1e-2).mean()) > 0.995


class TestServingDevice:
    def test_viewport_off_the_tile_grid_renders_through_render(self):
        _, tcloud = _scene(512)
        _, tc = cameras(64, 60)
        tr = tapi.InteractiveRenderer(device="cpu")
        img = _np(tr.render(tcloud, tc))
        np.testing.assert_array_equal(img, _np(tapi.render(tcloud, tc, device="cpu")))
        assert tr.stats == {"bins": 0, "replays": 0, "oneshots": 1}
        with pytest.raises(ValueError, match="multiples of 16"):
            tapi.make_replay_pipeline(tsettings.CloudSettings(), 64, 60, 8192)

    def test_cloud_elsewhere_raises(self):
        """A cloud moved per frame would be a new object, and so a new
        binning, every frame: the renderer takes only clouds on its device."""
        _, tcloud = _scene(64)
        _, tc = cameras(64, 64)
        tr = tapi.InteractiveRenderer(device="cpu")
        with pytest.raises(ValueError, match="move it"):
            tr.render(tcloud.to("meta"), tc)
        with pytest.raises(ValueError, match="move it"):
            tr.render_orbit(tcloud.to("meta"), 0.0, 0.2, 60.0, width=64, height=64)
        with pytest.raises(ValueError, match="impl"):
            tapi.InteractiveRenderer(impl="xla", device="cpu")
        if torch.cuda.is_available():
            assert tapi.InteractiveRenderer().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                tapi.InteractiveRenderer()


class TestSortSchedule:
    def test_throttle_policy(self):
        """tests/test_aux.py's protocol, with both packages' orders equal."""
        a = _arrays(100, 1)
        jcloud, tcloud = jax_cloud(a), torch_cloud(a)
        for sched, pos in ((jsort.SortSchedule(period_ms=1000.0), jcloud.position),
                           (tsort.SortSchedule(period_ms=1000.0), tcloud.position)):
            eye0 = np.array([0.0, 0.0, 50.0])
            mt = np.eye(4)
            o1 = sched.maybe_sort(pos, mt, eye0, now_ms=0.0)
            assert o1 is not None and len(o1) == 100
            assert sched.maybe_sort(pos, mt, eye0, now_ms=5000.0) is o1  # same camera: cached
            eye1 = np.array([10.0, 0.0, 50.0])
            assert sched.maybe_sort(pos, mt, eye1, now_ms=500.0) is o1  # moved, inside the period
            o4 = sched.maybe_sort(pos, mt, eye1, now_ms=1500.0)  # moved, past the period
            assert o4 is not o1
            assert sched.period_ms >= 1000.0
        # the rule InteractiveRenderer shares: moved and elapsed; max(floor, 4 x duration)
        assert tsort.sort_due(True, 1500.0, 0.0, 1000.0) and not tsort.sort_due(True, 500.0, 0.0, 1000.0)
        assert not tsort.sort_due(False, 1e9, 0.0, 1000.0)
        assert (tsort.throttle_period_ms(1000.0, 300.0), tsort.throttle_period_ms(1000.0, 100.0)) == (1200.0, 1000.0)
        np.testing.assert_array_equal(
            tsort.SortSchedule().maybe_sort(tcloud.position, np.eye(4), eye1, now_ms=0.0),
            jsort.SortSchedule().maybe_sort(jcloud.position, np.eye(4), eye1, now_ms=0.0),
        )


class TestRadixBookkeeping:
    def test_digit_bookkeeping(self):
        # tests/radix.rs:42-62 digit place / shift / parity selection
        for bits in (16, 24, 32):
            assert tsort.digit_places(bits) == jsort.digit_places(bits)
            assert tsort.key_shift(bits) == jsort.key_shift(bits)
            assert tsort.final_pass_parity(bits) == jsort.final_pass_parity(bits)
            depth = tsettings.RadixSortDepthBits(bits)
            assert (depth.digit_places, depth.key_shift) == (tsort.digit_places(bits), tsort.key_shift(bits))
        assert [tsort.digit_places(b) for b in (16, 24, 32)] == [2, 3, 4]
        assert [tsort.final_pass_parity(b) for b in (16, 24, 32)] == [0, 1, 0]
        key = np.uint32(0xAABBCCDD)
        assert tsort.digit_of(key, 0) == 0xDD and tsort.digit_of(key, 3) == 0xAA
        keys = np.arange(0, 2**32, 2**20 + 7, dtype=np.uint64).astype(np.uint32)
        for place in range(4):
            np.testing.assert_array_equal(tsort.digit_of(keys, place), jsort.digit_of(keys, place))

    def test_sort_gaussians_radix_matches_jax(self):
        a = _arrays(512, 2)
        jc, tc = cameras(64, 64, (3.0, 2.0, 40.0))
        jk, ji = jsort.sort_gaussians_radix(
            jnp.asarray(a["position_visibility"][:, :3]), jnp.eye(4), jc.clip_from_world, jc.world_position, 24
        )
        tk, ti = tsort.sort_gaussians_radix(
            torch.from_numpy(a["position_visibility"][:, :3]), torch.eye(4), tc.clip_from_world, tc.world_position, 24
        )
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji).astype(np.int64))
