"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [extra flags] -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``bevy_gaussian_splatting_tpu_torch/_build/`` (ignored
by git), named by a hash of its source, the shared headers ``csrc/*.cuh``
and the flags, so an edited source or header is rebuilt and an unchanged
one is reused.  Builds happen at first use, or all
at once and in parallel through :func:`build_all`.  A failed build raises.
ptxas reports each kernel's registers, shared memory and spills (``-Xptxas
-v``); the report is kept beside the library and read by
:func:`ptxas_usage`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Per-source extra flags.  The compositor is built with --fmad=false: a
# contracted multiply-add rounds once where the plain PyTorch version rounds
# twice, and in the OBB inside-test |u| <= 1 that one-ulp change can flip a
# fragment in or out of the quad, a jump of up to exp(-4.5) * opacity, far
# above the 2e-5 image tolerance.  Its backward recomputes the same alpha and
# transmittance and must round them as the forward did, so it takes the same
# flag.  The flag holds for everything the source includes: the warp mask
# both compositors share (csrc/cull.cuh) rounds under it too.  The fused
# projection takes it for the same reason: its OBB rows, masks and keys are
# the eager chain's bits only if it rounds every product and sum as that
# chain does.  The training colour stage (csrc/sh.cu) takes it too: its
# forward gives the eager chain's colour bits with the projection's SH code
# (csrc/sh.cuh).
EXTRA_FLAGS = {
    "tile_fwd": ["--fmad=false"],
    "tile_bwd": ["--fmad=false"],
    "project": ["--fmad=false"],
    "sh": ["--fmad=false"],
}

SOURCES = ("expand", "tile_fwd", "tile_bwd", "reduce", "project", "sh")

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
    """The library of ``csrc/<name>.cu``, named by a hash of the source, every
    header under ``csrc/`` (an edited header rebuilds each source that may
    include it) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


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
    final.with_suffix(".ptxas.txt").write_bytes(out)
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


def ptxas_usage(name: str) -> list:
    """(kernel, usage) for each kernel entry of ``csrc/<name>.cu`` as ptxas
    reported it at the build: registers, shared and constant memory, and
    the stack and spill line.  Empty if the library was not built here."""
    log = library_path(name).with_suffix(".ptxas.txt")
    if not log.exists():
        return []
    out, kernel, props = [], None, ""
    for line in log.read_text(errors="replace").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = entry.group(1)
        elif "bytes stack frame" in line:
            props = line.split(":", 1)[-1].strip()
        elif kernel and "Used" in line:
            out.append((kernel, line.split(":", 1)[-1].strip() + "; " + props))
            kernel, props = None, ""
    return out


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
