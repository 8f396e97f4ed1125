"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name (``BENCHMARK.json`` at the root of
the checkout):

  - the cell, ``benchmark/workloads/<name>.json``: its traffic parameters,
    its configuration, its ``entry`` (its code, ``benchmark/traffic/<entry>.py``),
    the numbers compared for ``correct`` and their ``limits``;
  - the configuration, ``benchmark/configs/<config>.json``;
  - each per-layer metric, a reader ``benchmark/metrics/<metric>.py`` whose
    ``read(reading)`` returns the value, or None where it finds nothing.

A run makes its scene from the seed, sets up the program and warms it up
(``setup_s``, from the process's start to the first timed frame or step),
measures a closed loop for ``--seconds``, and, with ``--trace 1``, then
profiles a further ``trace_seconds`` of the same loop for the per-layer
metrics.  After the window it frees the program's state and checks what the
timed path produced against the plain reference (``benchmark/reference/``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``) and, last, ``checks``: each number compared with its limit.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded at the end, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "bevy_gaussian_splatting_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def pin_caches() -> None:
    """Every build and kernel cache in fixed folders inside the checkout.
    The port builds its kernels into its own ``_build/`` folder, which is
    inside the checkout too."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, man: dict | None = None) -> tuple:
    """(manifest entry, workload file, configuration file) of cell ``name``."""
    man = manifest() if man is None else man
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    return entry, workload, config


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(name: str, man: dict) -> tuple:
    """The cell's end-to-end and per-layer metric entries."""

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in man["end_to_end"] if listed(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"] if listed(m) and m["moves"] in reported]
    return e2e, layer


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    device: object
    n: int | None = None


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads."""

    kind: str
    units: int
    wall_per_unit_s: float
    stats: dict
    trace: dict
    work: dict


def card() -> dict:
    import torch

    limit = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "power_limit": limit}


def host_probe_ms() -> float:
    """Milliseconds of a fixed loop of Python on this thread: the host's
    speed beside each window, for reading the spread of host-bound cells."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def log(msg: str) -> None:
    print(f"[bench {process_age_s():8.2f} s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", n: int | None = None,
             overrides: dict | None = None, require_card: bool = True, hook=None) -> dict:
    """One run of cell ``name`` -> the result object (without printing).
    ``device``, ``n`` and ``overrides`` (workload keys) shrink a run for the
    CPU tests, which also pass ``require_card=False``; ``hook(traffic)``, if
    given, runs after set-up (the tests plant faults with it)."""
    man = manifest()
    entry, workload, config = cell_files(name, man)
    workload = {**workload, **(overrides or {})}
    import torch

    if require_card:
        chips = int(entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"cell {name} needs {chips} CUDA card(s); torch.cuda.is_available() is "
                             f"{torch.cuda.is_available()}, device count {torch.cuda.device_count()}")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"torch imported: {name}")
    traffic_mod = importlib.import_module(f"benchmark.traffic.{workload['entry']}")
    traffic = traffic_mod.Traffic(Cell(name, workload, config, int(seed), dev, n))
    if hook is not None:
        hook(traffic)
    setup_s = process_age_s()
    log(f"set-up done: {name}, seed {seed}; host probe {host_probe_ms():.3f} ms")
    res = traffic.run(seconds=seconds)
    log(f"host probe {host_probe_ms():.3f} ms")
    lat = res["latencies_s"]
    half = len(lat) // 2
    log(f"window: {res['units']} units in {res['wall_s']:.3f} s, stats {res.get('stats')}, mean ms of the "
        f"first and second half {1e3 * sum(lat[:half]) / max(half, 1):.3f} {1e3 * sum(lat[half:]) / max(len(lat) - half, 1):.3f}")
    e2e, layer = metrics_of(name, man)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "count": 1}
    result = {"correct": False, "attempted": res["units"], "failed": res.get("failed", 0)}
    if trace:
        from benchmark import trace as tr

        with tr.Window(dev) as win:
            tres = traffic.run(seconds=float(workload["trace_seconds"]), sample=False)
        log(f"traced window: {tres['units']} units in {win.window_s:.3f} s")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        summary = win.summary()
        log(f"trace read: {summary['launches']} launches, busy {summary['busy_s']:.4f} s")
        reading = Reading(traffic.kind, tres["units"], res["wall_s"] / max(res["units"], 1), res.get("stats", {}),
                          summary, traffic.work(tres))
        values = {}
        for m in layer:
            v = reader(m["name"])(reading)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        measured = {**traffic.end_to_end(res), "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]} for m in e2e}
    # the program's peak: read before the benchmark's own reference runs
    device_info["memory_peak_bytes"] = peak
    if dev.type == "cuda":
        device_info.update(card())
    result["device"] = device_info
    traffic.release()
    numbers = traffic.check()
    log(f"checked {traffic.sampled()} sampled units")
    limits = workload["limits"]
    result["correct"] = all(numbers[k] <= limits[k] for k in limits) and traffic.sampled() > 0
    for k, v in numbers.items():
        if k not in limits:
            log(f"not compared: {k} {v!r}")
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    pin_caches()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
