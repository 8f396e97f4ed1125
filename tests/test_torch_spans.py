"""PyTorch port, the program's spans and counters (``utils/trace.py``) on the
CPU.

Under a CPU ``torch.profiler`` a bin, a replay, a time-driven one-pass and
an off-grid frame, and a 3DGS and a 4DGS training step, open exactly the
``gs.*`` spans of their layers, nested as the layers are; so do a 2DGS step
with the geometric terms (``gs.loss.geometry``) and a densification
(``gs.densify``).  Without a
profiler no span enters ``record_function``, and a frame and a step
dispatch the same ATen operations as with every span taken out; images and
losses are bitwise the same with the profiler on and off.  The counters:
one pair-budget recount in ``_RECOUNT_PERIOD`` frames of a key, its pairs
those of an independent ``pair_count``, every one-pass frame in
``stats["oneshots"]``, a step's pairs those of its camera, the geometric
steps and a densify's added and pruned gaussians; values kept on several
devices sum."""

import contextlib
import json
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera, orbit_camera_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded, random_gaussians_4d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.render import api
from bevy_gaussian_splatting_tpu_torch.train import densify
from bevy_gaussian_splatting_tpu_torch.train.losses import SurfaceLoss, gaussian_splatting_loss
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step
from bevy_gaussian_splatting_tpu_torch.utils import trace
from torch_port_cases import EYE  # also keeps one PyTorch thread per worker

N = 1500
W, H = 64, 48
SETTINGS_4D = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D)
CPU = torch.device("cpu")

PROJECT = {("gs.project.cov", "gs.project"), ("gs.project.sh", "gs.project")}
# 2DGS: the surfel homography's own child in place of the EWA covariance's
SURFEL_PROJECT = {("gs.project.surfel", "gs.project"), ("gs.project.sh", "gs.project")}
SETTINGS_2D = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
BIN = {(k, "gs.bin") for k in ("gs.bin.sort_depth", "gs.bin.expand", "gs.bin.sort_tile", "gs.bin.ranges")}
# a pair-budget recount: the count's camera (a host camera off the orbit
# grid) and projection
RECOUNT = {("gs.recount", "gs.budget"), ("gs.camera", "gs.recount"), ("gs.project", "gs.recount")}


def _under(parent: str, *children: str) -> set:
    return {(c, parent) for c in children}


# (span, parent) of every span a kind of unit opens
BIN_FRAME = _under("gs.frame", "gs.budget", "gs.camera", "gs.project", "gs.bin", "gs.pack", "gs.composite") \
    | RECOUNT | PROJECT | BIN
REPLAY_FRAME = _under("gs.frame", "gs.budget", "gs.camera", "gs.project", "gs.pack", "gs.composite") | PROJECT
ONE_PASS_4D = BIN_FRAME - RECOUNT | {("gs.project.time", "gs.project")}
STEP = _under("gs.step", "gs.adam", "gs.project", "gs.pack", "gs.bin", "gs.composite", "gs.loss", "gs.backward") \
    | _under("gs.backward", "gs.composite_bwd", "gs.unpermute", "gs.reduce") | PROJECT | BIN


def _cloud(four_d=False):
    return (random_gaussians_4d_seeded if four_d else random_gaussians_3d_seeded)(N, seed=3, device="cpu")


@pytest.fixture(autouse=True)
def fresh_budgets(monkeypatch):
    monkeypatch.setattr(api, "_BUDGET_STATE", {})


def _tree(prof) -> dict:
    """Every ``gs.*`` span of a CPU profile -> {(name, parent): count}, the
    parent being the nearest enclosing ``gs.*`` span (None at a root)."""
    edges: dict = {}
    for ev in prof.events():
        if not ev.name.startswith("gs."):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("gs."):
            parent = parent.cpu_parent
        key = (ev.name, None if parent is None else parent.name)
        edges[key] = edges.get(key, 0) + 1
    return edges


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _tree(prof)


def _expect(tree: dict, root: str, shape: set) -> None:
    assert set(tree) == {(root, None)} | shape, sorted(set(tree) ^ ({(root, None)} | shape))


def _step(four_d=False, profiled=False, steps=1, settings=None):
    cloud = _cloud(four_d)
    model = TrainableCloud(cloud)
    opt = adam(model, 0.01)
    cam = Camera.create(eye=EYE, width=W, height=H, device="cpu")
    target = torch.zeros((H, W, 4))
    if settings is None:
        settings = SETTINGS_4D if four_d else CloudSettings()

    def run():
        return [float(train_step(model, opt, cam, target, settings, gaussian_splatting_loss, time=0.3))
                for _ in range(steps)]

    if profiled:
        losses, tree = _profiled(run)
        return losses, tree, model
    return run(), None, model


def test_bin_and_replay_frames_open_their_layers():
    cloud, r = _cloud(), api.InteractiveRenderer(period_floor_ms=1e9, device="cpu")
    _, tree = _profiled(lambda: r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H))
    assert r.stats == {"bins": 1, "replays": 0, "oneshots": 0}
    _expect(tree, "gs.frame", BIN_FRAME)
    _, tree = _profiled(lambda: r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H))
    assert r.stats == {"bins": 1, "replays": 1, "oneshots": 0}
    _expect(tree, "gs.frame", REPLAY_FRAME)
    assert tree[("gs.frame", None)] == 1


def test_time_driven_and_off_grid_frames_open_their_layers():
    cloud, r = _cloud(True), api.InteractiveRenderer(SETTINGS_4D, device="cpu")
    r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H, time=0.25)
    _, tree = _profiled(lambda: r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H, time=0.5))
    assert r.stats == {"bins": 1, "replays": 0, "oneshots": 1}
    _expect(tree, "gs.frame", ONE_PASS_4D)

    cloud, r = _cloud(), api.InteractiveRenderer(device="cpu")
    _, tree = _profiled(lambda: r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H - 8))
    assert r.stats == {"bins": 0, "replays": 0, "oneshots": 1}
    # the frame's host camera, then the first frame of a key counts its
    # pairs through that camera
    _expect(tree, "gs.frame", ONE_PASS_4D - {("gs.project.time", "gs.project")} | RECOUNT
            - {("gs.camera", "gs.recount")})
    cam = Camera.create(eye=EYE, width=W, height=H - 8, device="cpu")
    _, tree = _profiled(lambda: r.render(cloud, cam))
    _expect(tree, "gs.frame", ONE_PASS_4D - {("gs.project.time", "gs.project"), ("gs.camera", "gs.frame")})


@pytest.mark.parametrize("four_d", [False, True], ids=["3d", "4d"])
def test_training_step_opens_its_layers(four_d):
    _, tree, _ = _step(four_d, profiled=True)
    _expect(tree, "gs.step", STEP | ({("gs.project.time", "gs.project")} if four_d else set()))
    assert tree[("gs.adam", "gs.step")] == 2  # zero_grad, then the update
    assert tree[("gs.unpermute", "gs.backward")] == 2  # into slot order, then cloud order


def test_surfel_frames_and_steps_open_the_surfel_span():
    """2DGS: the eager surfel chain (here, on the CPU, and in training) opens
    ``gs.project.surfel`` under ``gs.project``, and no ``gs.project.cov``."""
    cloud, r = _cloud(), api.InteractiveRenderer(SETTINGS_2D, period_floor_ms=1e9, device="cpu")
    _, tree = _profiled(lambda: r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H))
    _expect(tree, "gs.frame", BIN_FRAME - PROJECT | SURFEL_PROJECT)
    _, tree = _profiled(lambda: r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H))
    assert r.stats == {"bins": 1, "replays": 1, "oneshots": 0}
    _expect(tree, "gs.frame", REPLAY_FRAME - PROJECT | SURFEL_PROJECT)
    _, tree, _ = _step(profiled=True, settings=SETTINGS_2D)
    _expect(tree, "gs.step", STEP - PROJECT | SURFEL_PROJECT)


def test_surface_loss_and_densify_open_their_spans():
    """A 2DGS step with the geometric terms (``surface_loss``) opens
    ``gs.loss.geometry`` under ``gs.loss`` and counts in ``geometry.steps``;
    accumulating the densification statistics and a densify are each a
    ``gs.densify`` span of their own, and the densify's added and pruned
    gaussians count in ``densify.added`` and ``densify.pruned``."""
    model = TrainableCloud(_cloud())
    opt = adam(model, 0.01)
    cam = Camera.create(eye=EYE, width=W, height=H, device="cpu")
    target = torch.zeros((H, W, 4))
    state = densify.init_densify_state(N, device="cpu")
    before = trace.counters()

    def run():
        train_step(model, opt, cam, target, SETTINGS_2D, gaussian_splatting_loss, surface_loss=SurfaceLoss())
        return densify.densify_and_prune(model.cloud(), densify.accumulate_stats(state, model.grads()), k_budget=16)

    (_, _, stats), tree = _profiled(run)
    step = STEP - PROJECT | SURFEL_PROJECT | {("gs.loss.geometry", "gs.loss")}
    assert set(tree) == {("gs.step", None), ("gs.densify", None)} | step, sorted(set(tree) ^ step)
    assert tree[("gs.densify", None)] == 2 and tree[("gs.loss.geometry", "gs.loss")] == 1
    after = trace.counters()
    for name, want in (("geometry.steps", 1), ("densify.added", int(stats["added"])),
                       ("densify.pruned", int(stats["pruned"]))):
        assert after[name] - before.get(name, 0) == want, name


def test_without_a_profiler_no_span_is_entered(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    # the spans' entry point; torch's own annotations (the optimizer's)
    # open theirs through torch.autograd.profiler
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cloud, r = _cloud(), api.InteractiveRenderer(device="cpu")
    for h in (H, H - 8):
        r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=h)
    _step(steps=1)
    with trace.StageTimer().span("host"):
        pass


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _frame_and_step():
    cloud, r = _cloud(), api.InteractiveRenderer(device="cpu")
    with _Ops() as mode:
        r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H)
        r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H - 8)
        _step()
    return mode.ops


def test_spans_dispatch_nothing(monkeypatch):
    """The same ATen operations, in order, as with every span taken out."""
    with_spans = _frame_and_step()
    monkeypatch.setattr(api, "_BUDGET_STATE", {})
    off = lambda name: contextlib.nullcontext()  # noqa: E731
    monkeypatch.setattr(trace, "span", off)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("bevy_gaussian_splatting_tpu_torch") and \
                getattr(mod, "span", None) is not None and mod is not trace:
            monkeypatch.setattr(mod, "span", off)
    without = _frame_and_step()
    assert with_spans == without and len(with_spans) > 100


def test_images_and_losses_are_bitwise_the_same_profiled():
    cloud = _cloud(True)
    frames = []
    for profiled in (False, True):
        api._BUDGET_STATE.clear()
        r = api.InteractiveRenderer(SETTINGS_4D, device="cpu")

        def serve(r=r):
            return [r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=h, time=t)
                    for h, t in ((H, 0.25), (H, 0.25), (H, 0.5), (H - 8, 0.5))]

        frames.append(_profiled(serve)[0] if profiled else serve())
    assert all(torch.equal(a, b) for a, b in zip(*frames))
    plain, profiled = _step(True, steps=2), _step(True, profiled=True, steps=2)
    assert plain[0] == profiled[0]
    for name in plain[2].fields:
        assert torch.equal(getattr(plain[2], name), getattr(profiled[2], name)), name


def test_one_recount_in_a_period_of_one_key():
    cloud = _cloud()
    cam = Camera.create(eye=EYE, width=W, height=H, device="cpu")
    key = ("spans test",)
    seen = []
    for _ in range(3 * api._RECOUNT_PERIOD):
        before = trace.counters().get("budget.recounts", 0)
        api._current_bucket(key, CloudSettings(), cloud, cam, None)
        seen.append(trace.counters()["budget.recounts"] - before)
    assert [i for i, c in enumerate(seen) if c] == [0, api._RECOUNT_PERIOD, 2 * api._RECOUNT_PERIOD]
    assert sum(seen) == 3


def test_recount_pairs_and_budget_are_an_independent_count():
    cloud = _cloud()
    cam = Camera.create(eye=EYE, width=W, height=H, device="cpu")
    before = trace.counters()
    bucket = api._current_bucket(("spans test",), CloudSettings(), cloud, cam, None)
    after = trace.counters()
    pairs = int(rt.pair_count(cloud, cam, CloudSettings()))
    counted = after["budget.pairs_counted"] - before.get("budget.pairs_counted", 0)
    sized = after["budget.sized"] - before.get("budget.sized", 0)
    assert (counted, sized) == (pairs, bucket) == (pairs, rt.pairs_budget(N, pairs))
    assert 0 < counted / sized < 1


def test_every_one_pass_frame_counts_in_oneshots():
    cloud = _cloud()
    cam = Camera.create(eye=EYE, width=W, height=H - 8, device="cpu")
    r = api.InteractiveRenderer(device="cpu")
    r.render(cloud, cam)
    r.render_orbit(cloud, 0.1, 0.2, 60.0, width=W, height=H - 8)
    assert r.stats == {"bins": 0, "replays": 0, "oneshots": 2}
    oracle = api.InteractiveRenderer(impl="oracle", device="cpu")
    oracle.render_orbit(_cloud(), 0.1, 0.2, 60.0, width=32, height=32)
    assert oracle.stats == {"bins": 0, "replays": 0, "oneshots": 1}


def test_a_steps_pairs_are_its_cameras():
    cloud = _cloud()
    model = TrainableCloud(cloud)
    opt = adam(model, 0.01)
    target = torch.zeros((H, W, 4))
    want = []
    before = trace.counters()
    for eye in (EYE, (20.0, 5.0, 50.0)):
        cam = Camera.create(eye=eye, width=W, height=H, device="cpu")
        want.append(int(rt.pair_count(model.cloud(), cam, CloudSettings())))
        train_step(model, opt, cam, target, loss_fn=gaussian_splatting_loss)
    after = trace.counters()
    assert after["train.pairs"] - before.get("train.pairs", 0) == sum(want) > 0
    assert after["train.budget"] - before.get("train.budget", 0) == 2 * rt.pairs_budget(N)


def test_counted_later_values_fold_but_keep_their_sum(monkeypatch):
    monkeypatch.setattr(trace, "RING", 4)
    monkeypatch.setattr(trace, "_LATER", {})
    for v in range(10):
        trace.count_later("test.values", torch.tensor(v, dtype=torch.int64))
    assert len(trace._LATER[("test.values", CPU)]) < 4
    assert trace.counters()["test.values"] == sum(range(10))


@pytest.mark.cuda
def test_counted_later_values_sum_over_devices(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    monkeypatch.setattr(trace, "RING", 3)
    monkeypatch.setattr(trace, "_LATER", {})
    for v in range(10):
        for device in ("cpu", "cuda"):
            trace.count_later("test.devices", torch.tensor(v, dtype=torch.int64, device=device))
    # each device keeps and folds its own values
    assert sorted(device.type for _, device in trace._LATER) == ["cpu", "cuda"]
    assert all(len(ring) < 3 for ring in trace._LATER.values())
    assert trace.counters()["test.devices"] == 2 * sum(range(10))


def test_counted_later_value_is_a_copy():
    base = torch.arange(5, dtype=torch.int64)
    trace.count_later("test.copy", base[-1])
    kept = trace._LATER[("test.copy", CPU)][-1]
    assert kept.untyped_storage().data_ptr() != base.untyped_storage().data_ptr()


def test_stage_timer_sections_are_spans_on_the_trace(tmp_path):
    timer = trace.StageTimer()
    with trace.trace(str(tmp_path), device="cpu") as prof:
        with timer.span("binning"):
            torch.ones(3).sum()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    annotations = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert annotations == ["binning"]
    assert timer.counts == {"binning": 1}


def test_orbit_camera_device_is_a_camera_span():
    orbit = torch.tensor([0.1, 0.2, 60.0, 0.0, 0.0, 0.0])
    _, tree = _profiled(lambda: orbit_camera_device(orbit, W, H))
    assert tree == {("gs.camera", None): 1}


def test_viewer_info_reads_the_serving_counters():
    from bevy_gaussian_splatting_tpu_torch.viewer.serve import ViewerState

    state = ViewerState(_cloud(), CloudSettings(), W, H, None, (0.0, 0.0, 0.0), 60.0, device="cpu")
    assert state.budget_info()["replay_pct"] is None
    before = trace.counters()
    for _ in range(2):
        state.render_u8(0.1, 0.2, 60.0, None)
    info, after = state.budget_info(), trace.counters()
    assert info["replay_pct"] == 50.0  # a bin, then a replay
    assert info["recounts"] == after["budget.recounts"] >= before.get("budget.recounts", 0) + 1
    assert info["pair_fill_pct"] == 100.0 * after["budget.pairs_counted"] / after["budget.sized"]


def test_counters_lose_no_update_across_threads(monkeypatch):
    import threading

    monkeypatch.setattr(trace, "_COUNTS", {})
    monkeypatch.setattr(trace, "_LATER", {})
    monkeypatch.setattr(trace, "RING", 64)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def counting():
            for _ in range(2000):
                trace.count("test.threads")

        def keeping():
            for _ in range(200):
                trace.count_later("test.threads_later", torch.ones((), dtype=torch.int64))

        for work in (counting, keeping):
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    c = trace.counters()
    assert (c["test.threads"], c["test.threads_later"]) == (16 * 2000, 16 * 200)
