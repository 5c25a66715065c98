"""The benchmark's CPU tests run from the repo root with the program's
``src`` on the path; a test that needs the card carries the ``card``
marker and decides inside itself whether one is there."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where none is visible")
