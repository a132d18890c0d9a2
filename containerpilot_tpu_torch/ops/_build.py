"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

into a git-ignored build directory (``build/kernels`` at the root of the
checkout, or ``$CONTAINERPILOT_TORCH_BUILD_DIR``), then loads with
``ctypes``. No PyTorch headers are included, which keeps a build to
seconds. The file name carries a hash of the source, every shared
header (``csrc/*.cuh``) and the flags, so an edited kernel or header
rebuilds and concurrent processes never load a half-written library
(each writes a temporary file and renames it).

``build_all()`` starts one nvcc per source, all at once, and waits for
them; ``load(name)`` builds one library if it is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc runs this process made (a library already built costs none)
BUILDS = 0


def build_dir() -> str:
    root = os.path.dirname(os.path.dirname(CSRC))
    return os.environ.get(
        "CONTAINERPILOT_TORCH_BUILD_DIR",
        os.path.join(root, "build", "kernels"),
    )


def sources() -> List[str]:
    return sorted(
        f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build only where the CUDA toolkit is installed"
    )


def headers() -> List[str]:
    """The shared headers (``csrc/*.cuh``) any source may include."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    for path in [src] + [os.path.join(CSRC, f) for f in headers()]:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (final path, tmp path, proc),
    proc None when the library is already built."""
    src, out = _target(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    return out, tmp, proc


def _finish(name: str, out: str, tmp: str, proc) -> None:
    global BUILDS
    if proc is None:
        return
    BUILDS += 1
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu "
            f"(exit {proc.returncode}):\n{log.decode(errors='replace')}"
        )
    os.replace(tmp, out)


def build_all() -> float:
    """Build every kernel library in parallel (one nvcc per source);
    returns the wall seconds it took. Already-built libraries cost
    nothing."""
    t0 = time.perf_counter()
    with _lock:
        started = [(name, *_start(name)) for name in sources()]
        for name, out, tmp, proc in started:
            _finish(name, out, tmp, proc)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, tmp, proc = _start(name)
            _finish(name, out, tmp, proc)
            lib = ctypes.CDLL(out)
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry
    (each source exports ``<name>_error_string`` for the message)."""
    if err != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({describe(err).decode()})"
        )
