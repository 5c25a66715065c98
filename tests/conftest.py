"""Shared test fixtures/shims.

Four concerns:

* make ``pytest`` runnable from the repo root without exporting
  ``PYTHONPATH=src`` by hand (the Makefile does it anyway; this is a belt
  for ad-hoc invocations),
* give the suite a multi-device host platform: the SPMD plan-execution
  tests need >= 4 devices, and ``--xla_force_host_platform_device_count``
  only takes effect if set before jax initializes its backends — conftest
  imports before any test module, so this is the one reliable hook.  An
  operator-provided ``XLA_FLAGS`` (e.g. CI's) always wins, and nothing is
  touched if jax is somehow already imported,
* keep the property-based test modules importable when ``hypothesis`` is
  not installed (offline images): a minimal stand-in is registered in
  ``sys.modules`` so ``from hypothesis import given, settings, strategies``
  still resolves, and every ``@given`` test *skips* at runtime instead of
  erroring the whole collection, and
* register the ``card`` marker of tests that need a CUDA card (each decides
  inside itself whether one is there, and skips where none is).
"""

from __future__ import annotations

import os
import pathlib
import sys
import types

import pytest

_SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

if "jax" not in sys.modules and "xla_force_host_platform_device_count" not in (
    os.environ.get("XLA_FLAGS") or ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()

try:
    import hypothesis  # noqa: F401  — real library wins when present
except ImportError:

    class _Strategy:
        """Opaque placeholder for hypothesis strategy objects."""

        def __init__(self, *args, **kwargs):
            pass

        def map(self, *args, **kwargs):
            return self

        def filter(self, *args, **kwargs):
            return self

        def flatmap(self, *args, **kwargs):
            return self

    def _make_strategy(*args, **kwargs):
        return _Strategy()

    def given(*args, **kwargs):
        def deco(fn):
            # No functools.wraps: the wrapper must NOT expose the strategy
            # parameters, or pytest would try to resolve them as fixtures.
            def skipper(*a, **k):
                pytest.skip("hypothesis not installed; property test skipped")

            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper

        return deco

    def settings(*args, **kwargs):
        def deco(fn):
            return fn

        return deco

    _strategies = types.ModuleType("hypothesis.strategies")
    for _name in (
        "booleans", "floats", "integers", "just", "lists", "none",
        "one_of", "sampled_from", "text", "tuples",
    ):
        setattr(_strategies, _name, _make_strategy)

    _mod = types.ModuleType("hypothesis")
    _mod.given = given
    _mod.settings = settings
    _mod.strategies = _strategies
    _mod.HealthCheck = types.SimpleNamespace(
        too_slow=None, filter_too_much=None, data_too_large=None
    )
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _strategies


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where none is visible")
