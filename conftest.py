"""Repository-wide pytest set-up: build the JAX package's native library once,
before any xdist worker starts.

``bevy_gaussian_splatting_tpu/native`` builds its library at first use,
every process into the same temporary path, and a process whose build or
load fails keeps ``None`` for its life.  Workers that build at once can lose
that race and run the tests that compare against the library without it.
Built here, in the controller of a run with workers, the library is on disk
before the workers start, and each of them only loads it.  The build runs in
a child interpreter, so the controller's ``sys.modules`` never holds the JAX
package (the benchmark's tests check that it does not).  A run without
workers has no race and builds nothing here.  Where JAX or a compiler is
missing this does nothing, and the tests behave as without it.
``tests/conftest.py`` holds the rest of the JAX-side set-up."""

import importlib.util
import subprocess
import sys
from pathlib import Path

BUILD = "from bevy_gaussian_splatting_tpu import native; native.available()"


def pytest_configure(config):
    if hasattr(config, "workerinput") or not config.getoption("numprocesses", None):
        return
    if importlib.util.find_spec("jax") is None:
        return
    try:
        subprocess.run([sys.executable, "-c", BUILD], cwd=Path(__file__).resolve().parent,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, check=False, timeout=600)
    except subprocess.TimeoutExpired:
        pass
