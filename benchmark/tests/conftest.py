"""The benchmark's own tests (``python -m pytest benchmark/tests -q``).

They run on the CPU at test sizes; those marked ``cuda`` need an NVIDIA card
and skip without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is False"
    )
