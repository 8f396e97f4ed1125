"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [extra flags] -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``bevy_gaussian_splatting_tpu_torch/_build/`` (ignored
by git), named by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.  Builds happen at first use, or all
at once and in parallel through :func:`build_all`.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Per-source extra flags.  The compositor is built with --fmad=false: a
# contracted multiply-add rounds once where the plain PyTorch version rounds
# twice, and in the OBB inside-test |u| <= 1 that one-ulp change can flip a
# fragment in or out of the quad, a jump of up to exp(-4.5) * opacity, far
# above the 2e-5 image tolerance.
EXTRA_FLAGS = {
    "tile_fwd": ["--fmad=false"],
}

SOURCES = ("expand", "tile_fwd")

_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _command(name: str, out: Path) -> list:
    return (
        [nvcc_path()]
        + ARCH_FLAGS
        + BASE_FLAGS
        + EXTRA_FLAGS.get(name, [])
        + ["-o", str(out), str(CSRC / f"{name}.cu")]
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, []))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc build; returns (Popen, tmp, final) or None if built."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT
    )
    return proc, tmp, final


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            + out.decode(errors="replace")
        )
    os.replace(tmp, final)


def build_all(names=SOURCES) -> None:
    """Build every source in ``names`` in parallel: one nvcc each, all
    started together."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, s in started.items():
        try:
            _finish(name, s)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
