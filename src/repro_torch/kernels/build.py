"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, in the build directory (``REPRO_TORCH_BUILD_DIR``, default
``_build/`` beside this package, which git ignores), and again whenever
the source's hash changes: the library's file name carries the hash.
Several processes may build at once; each writes a private temporary file
and renames it into place.

Nothing here falls back: a missing ``nvcc`` or a failed build raises
:class:`KernelError`, as does every wrapper whose launch fails.
:func:`count_launch` adds to a wrapper's launch count under one lock, so
the counts stay exact while several threads launch (the sharded compress
and decode).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("interp3d", "histogram", "bitshuffle", "lorenzo3d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
COUNT_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A CUDA kernel failed to build, load or launch."""


def count_launch(table: dict, key: str) -> None:
    """One more launch of kernel ``key`` in a wrapper's ``LAUNCHES`` table."""
    with COUNT_LOCK:
        table[key] += 1


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(env) if env else pathlib.Path(__file__).resolve().parent.parent / "_build"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels build from source at first use")
    return found


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the seconds each took (0.0 when already built); the
    compiler's resource report lands in ``<build dir>/<name>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, target)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, target)
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
