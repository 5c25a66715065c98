"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` under ``repro_torch/kernels`` is one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes); sources of one family may share a ``csrc/*.cuh`` header, and
every family the Hopper building blocks of ``kernels/csrc/*.cuh``.
Libraries land in ``<repo>/build/repro_torch_kernels/`` named by a hash of
their source, the headers beside it, the shared ones and the flags, are built at first use,
and are reused while those are unchanged.  :func:`build_all` starts one ``nvcc`` per
source, all together, and waits for them.

Every C entry point takes pointers and the stream as ``void*`` (declared
``c_void_p`` here, so ctypes never cuts a 64-bit pointer to an int) and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.  A build failure raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    "-split-compile", "0",  # nvcc's optimiser on threads: about 2 s off a parallel build
)

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, pathlib.Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    # the only headers of ours: the family's and the shared ones
    shared = sorted((KERNELS_DIR / "csrc").glob("*.cuh"))
    for header in [*sorted(src.parent.glob("*.cuh")), *shared]:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: pathlib.Path) -> tuple[subprocess.Popen, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp


def _wait(proc: subprocess.Popen, tmp: str, out: pathlib.Path) -> tuple[int, str]:
    log, _ = proc.communicate()
    if proc.returncode == 0:
        os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    else:
        os.unlink(tmp)
    return proc.returncode, log


def _raise_failed(results: dict[str, tuple[int, str]]) -> None:
    failed = {n: r for n, r in results.items() if r[0] != 0}
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed for {n} (exit {code}):\n{log}"
            for n, (code, log) in failed.items()
        ))


def build_all() -> dict[str, str]:
    """Build every kernel whose library is missing, one ``nvcc`` per source,
    all started together.  Waits for every one before raising on a failure.
    Returns nvcc's output (register and spill report) by name."""
    jobs = {}
    for name, src in sources().items():
        out = _target(src)
        if not out.exists():
            jobs[name] = (*_start(src), out)
    results = {name: _wait(*job) for name, job in jobs.items()}
    _raise_failed(results)
    return {name: log for name, (_, log) in results.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        src = sources()[name]
        out = _target(src)
        if not out.exists():
            _raise_failed({name: _wait(*_start(src), out)})
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``fn`` of kernel ``name``'s library, with ``argtypes``
    declared and an ``int`` (the CUDA error code) as its result."""
    f = getattr(library(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what} takes tensors on one CUDA device, got {sorted(map(str, devs))}")


def aligned(t, elems: int) -> bool:
    """Whether rows of ``t`` (last axis contiguous) start on ``elems``-element
    boundaries: base pointer and every other stride."""
    if t.stride(-1) != 1:
        return False
    if t.data_ptr() % (elems * t.element_size()):
        return False
    return all(s % elems == 0 for s in t.stride()[:-1])
