"""How the suite runs under pytest-xdist.

pytest loads this root conftest before ``tests/conftest.py``.  It changes
how the suite is run, not what any test checks, and acts only under xdist;
a serial run is left as it is:

* the files are queued longest first (``LONGEST_FILES``) instead of xdist's
  most tests first: the costly files have few tests, and started last they
  set the run's tail, and
* each worker gets its share of the cores (``thread_budget``): torch's
  intra-op pool and XLA's Eigen pool would otherwise each take every core
  in every worker.  ``tests/conftest.py`` still adds its 4 host devices to
  ``XLA_FLAGS`` after this.
"""

from __future__ import annotations

import os

# The files of 40 s or more under the tier-1 command (``-n 6 --dist
# loadfile`` on 8 cores, each worker on its thread budget), longest first.
LONGEST_FILES = (
    "tests/test_ring_attention.py",
    "tests/test_resume.py",
    "tests/test_engine.py",
    "tests/test_smoke_archs.py",
    "tests/test_flash_segment.py",
    "tests/test_plan_exec.py",
    "tests/test_models_numerics.py",
    "tests/test_kernels.py",
    "tests/test_sp_executor.py",
    "tests/test_torch_ssm.py",
    "tests/test_chaos.py",
    "tests/test_torch_plan_exec.py",
    "tests/test_torch_train.py",
    "tests/test_paged_attention.py",
    "tests/test_torch_hybrid.py",
    "tests/test_torch_dense_train.py",
    "tests/test_torch_contiguous_serve.py",
    "tests/test_serve.py",
    "tests/test_torch_ring.py",
    "tests/test_torch_kernels_bwd.py",
    "tests/test_torch_mesh_train.py",
    "tests/test_torch_flash_bwd_tiles.py",
    "tests/test_torch_resume.py",
    "tests/test_torch_lm_train.py",
)


def longest_files_first(nodeids: list[str], longest: tuple[str, ...]) -> list[int]:
    """The order to run ``nodeids`` in, as indices: grouped by file, the
    files of ``longest`` in its order, then the others most tests first
    (xdist's own order); within a file the collection order."""
    files: dict[str, list[int]] = {}
    for i, nodeid in enumerate(nodeids):
        files.setdefault(nodeid.split("::", 1)[0], []).append(i)
    rank = {f: i for i, f in enumerate(longest)}
    order = sorted(files, key=lambda f: (rank.get(f, len(longest)), -len(files[f])))
    return [i for f in order for i in files[f]]


def thread_budget(environ, cpu_count: int) -> int | None:
    """Threads for one xdist worker: its share of ``cpu_count``, at least
    one; None outside xdist."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    return max(1, cpu_count // int(workers)) if workers else None


def xla_flags(flags: str, threads: int | None) -> str:
    """``flags`` (the operator's ``XLA_FLAGS``) with a single-threaded Eigen
    at one thread; the operator's own setting wins."""
    if threads == 1 and "--xla_cpu_multi_thread_eigen" not in flags:
        return f"{flags} --xla_cpu_multi_thread_eigen=false".strip()
    return flags


_THREADS = thread_budget(os.environ, os.cpu_count() or 1)
if _THREADS is not None:  # read by torch, BLAS and XLA when they load
    os.environ.setdefault("OMP_NUM_THREADS", str(_THREADS))
    os.environ["XLA_FLAGS"] = xla_flags(os.environ.get("XLA_FLAGS", ""), _THREADS)


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):  # xdist: keep the order the workers collect
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    if "PYTEST_XDIST_WORKER" in os.environ:  # the scheduler queues the workers' order
        order = longest_files_first([item.nodeid for item in items], LONGEST_FILES)
        items[:] = [items[i] for i in order]
