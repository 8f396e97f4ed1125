"""The yardstick's counts on a hand-worked scene, the trace reduction, the
run's refusals without a card, the no-JAX check, and that the benchmark
finds a new configuration, cell or metric by its files and entries."""

import ast
import json
import math
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import counts, run, trace
from benchmark.reference import splat

ONE = {
    "position_visibility": torch.tensor([[0.0, 0.0, 0.0, 1.0]]),
    "spherical_harmonic": torch.zeros(1, 48),
    "rotation": torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
    "scale_opacity": torch.tensor([[0.5, 0.5, 0.5, 0.5]]),
}


def test_counts_of_one_splat_by_hand():
    """One isotropic gaussian (scale 0.5, opacity 0.5) at the origin, seen
    from (0, 0, 60) at 64x64: the 2D covariance is 2.5753^2 0.25 + 0.3 =
    1.9582 on the diagonal (focal 154.51 vp units over the depth 60), the
    cutoff sqrt(9 + 2 ln 0.5) = 2.7594, so the OBB's half-side is 3.8613 vp
    units, 1.93 pixels.  Pixel columns 30-33 (vp offsets -3, -1, 1, 3) and
    the same rows fall inside: 16 (pair, pixel) visits, over the 4 tiles
    (1-2, 1-2) that the box touches, one pair walked in each."""
    c = {"walked": 0, "inside": 0}
    cam = splat.host_camera(splat.look_at_np((0.0, 0.0, 60.0)), splat.perspective_np(64, 64), 64, 64, "cpu")
    img, bins = splat.render_frame(ONE, cam, chunk=512, counts=c)
    assert c == {"walked": 4, "inside": 16, "visible": 1, "tiles": 16}
    assert bins["pairs"] == 4
    u = (2 * 31 - 63) / (math.sqrt(2.5753**2 * 0.25 + 0.3) * math.sqrt(9 + 2 * math.log(0.5)))
    assert float(img[31, 31, 3]) == pytest.approx(0.5 * math.exp(-4.5 * 2 * u * u), rel=1e-3)
    assert float(img[29, 31, 3]) == 0.0 and float(img[31, 34, 3]) == 0.0
    ops, nbytes = counts.compositor_work(4, 16, 16)
    assert (ops, nbytes) == (4 * 8 + 16 * 30, 4 * 40 + 16 * 8 + 16 * 256 * 16)
    ops_b, bytes_b = counts.compositor_work(4, 16, 16, backward=True)
    assert (ops_b, bytes_b) == (4 * 8 + 16 * 72, 4 * 40 * 2 + 16 * 8 + 16 * 256 * 20)
    assert counts.frame_ops("3d", 1, 1, 4, 16, 4096) == 44 + 409 + 512 + 2 * 4096
    assert counts.step_ops("3d", 1, 1, 4, 16, 4096, 60) == (
        44 + 409 + 512 + 2 * 4096 + 4096 * 3 * 242 * 3 + ops_b + 2 * (44 + 409) + 60 * 12)
    assert counts.least_time_s(67e12, 0.0) == 1.0 and counts.least_time_s(0.0, 3.35e12) == 1.0


def test_early_exit_stops_walking():
    """600 large, nearly opaque splats over a 32x32 image: every tile holds
    600 pairs and is covered after its first chunk of 256, so it walks only
    that chunk: the chunks are aligned to 128-pair boundaries of the sorted
    pair list, so the tiles starting at pairs 0, 600, 1200 and 1800 walk
    256, 168, 208 and 248 pairs."""
    n = 600
    f = {
        "position_visibility": torch.cat([torch.zeros(n, 3), torch.ones(n, 1)], dim=1),
        "spherical_harmonic": torch.zeros(n, 48),
        "rotation": torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1),
        "scale_opacity": torch.tensor([[20.0, 20.0, 20.0, 0.999]]).repeat(n, 1),
    }
    f["position_visibility"][:, 2] = torch.linspace(-1.0, 1.0, n)
    c = {"walked": 0, "inside": 0}
    cam = splat.host_camera(splat.look_at_np((0.0, 0.0, 60.0)), splat.perspective_np(32, 32), 32, 32, "cpu")
    splat.render_frame(f, cam, chunk=256, counts=c)
    assert c["tiles"] == 4 and c["walked"] == 256 + 168 + 208 + 248


def test_trace_reduction():
    events = [
        {"ph": "X", "cat": "kernel", "name": "composite_fwd_kernel<0>", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 16, "dur": 12},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "ts": 0, "dur": 60},
    ]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["launches"] == 3
    assert s["kernel_s"] == {"composite_fwd_kernel<0>": pytest.approx(10e-6), "k2": pytest.approx(20e-6)}
    assert s["device_ops"][0] == ["k2", pytest.approx(20e-6)]
    # gap 15-30 at 22.5 falls in the sync; gap 35-50 at 42.5 only in aten::outer
    assert dict(s["idle_gaps"]) == {"cudaStreamSynchronize": pytest.approx(15e-6), "aten::outer": pytest.approx(15e-6)}


def run_module(args, cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("trace_flag", ["0", "1"])
def test_a_run_without_a_card_fails_and_prints_no_result(trace_flag):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = run_module(["--workload", "gs3d-1m.orbit-720p", "--seed", "5", "--seconds", "1", "--trace", trace_flag],
                     run.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_module(["--workload", "gs3d-1m.orbit-720p", "--seed", "5", "--seconds", "1"], tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bevy_gaussian_splatting_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "bevy_gaussian_splatting_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bevy_gaussian_splatting_tpu.render", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"bevy_gaussian_splatting_tpu", "jax"} <= set(run.forbidden_modules())
    assert "jaxtyping" not in run.forbidden_modules()


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for path in run.BENCH.rglob("*.py"):
        assert not imported_tops(path) & set(run.FORBIDDEN), path
    for path in (run.BENCH / "reference").rglob("*.py"):
        assert "bevy_gaussian_splatting_tpu_torch" not in imported_tops(path), path


def test_new_files_and_entries_are_found_without_editing(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric as new files and new entries; a run of the new cell
    finds all three."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(run.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    config = json.loads((run.BENCH / "configs" / "gs3d-1m.json").read_text())
    config.update(name="gs3d-tiny", n_gaussians=1500)
    (root / "benchmark" / "configs" / "gs3d-tiny.json").write_text(json.dumps(config))
    cell = json.loads((run.BENCH / "workloads" / "gs3d-1m.orbit-720p.json").read_text())
    cell.update(name="gs3d-tiny.orbit-64", config="gs3d-tiny", width=64, height=48, radius=40.0, warmup_frames=2,
                trace_seconds=0.2)
    (root / "benchmark" / "workloads" / "gs3d-tiny.orbit-64.json").write_text(json.dumps(cell))
    (root / "benchmark" / "metrics" / "frames.traced.py").write_text(textwrap.dedent('''
        def read(r):
            return float(r.units) if r.units else None
    '''))
    man["configs"].append({"name": "gs3d-tiny", "source": "a test", "file": "benchmark/configs/gs3d-tiny.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "gs3d-tiny.orbit-64", "config": "gs3d-tiny", "traffic": "orbit-64",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "gs3d-1m.orbit-720p" in m.get("workloads", []):
            m["workloads"].append("gs3d-tiny.orbit-64")
    man["per_layer"].append({"name": "frames.traced", "unit": "frames", "better": "higher", "source": "host_clock",
                             "layer": "a test", "moves": "frame_ms", "workloads": ["gs3d-tiny.orbit-64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    code = textwrap.dedent(f'''
        import json, sys
        sys.path.insert(0, {str(root)!r})
        sys.path.append({str(run.ROOT)!r})
        from benchmark import run
        assert run.ROOT == __import__("pathlib").Path({str(root)!r})
        res = run.run_cell("gs3d-tiny.orbit-64", 3, 0.3, True, device="cpu", require_card=False)
        print(json.dumps(res))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["frames.traced"]["value"] > 0
    assert "replay_share.serve" in res["metrics"]
