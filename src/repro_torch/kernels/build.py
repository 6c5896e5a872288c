"""Build, load and launch the hand-written CUDA kernels (nvcc -> shared
library -> ctypes).

Every source under ``kernels/csrc`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``build/kernels/`` at the repository root (listed in
``.gitignore``), one shared library per source with a plain C entry
point. The file name carries a hash of the source, of every shared
header (``csrc/*.cuh``) and of the flags, so an edited source or header
builds anew and a stale library is never loaded. All
sources build in parallel, one ``nvcc`` each, started together.

The kernel modules declare each C entry point ``<name>_launch`` once
(:func:`declare`), and every launch goes through :func:`launch`, on
:func:`stream`'s handle, counted in ``LAUNCHES``.

Nothing here runs at import: this module imports on a machine without
``nvcc`` (the CPU tests), and a build is only attempted when a kernel is
launched on a CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from collections.abc import Callable, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}

# The C types of the entry points' arguments (each returns 0 or a
# cudaError_t, which its library's gpq_error_string names).
PTR = ctypes.c_void_p  # a tensor's data_ptr(), or None for NULL
INT = ctypes.c_int
INT64 = ctypes.c_longlong
FLOAT = ctypes.c_float
STREAM = ctypes.c_void_p  # stream()'s handle

# Launches by kernel name (a graph's replays call no launcher).
LAUNCHES: collections.Counter[str] = collections.Counter()
_SIGNATURES: dict[tuple[str, str], tuple] = {}
_ENTRIES: dict[tuple[str, str], tuple[Callable, Callable]] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> dict[str, pathlib.Path]:
    """Kernel name -> its .cu source, for every source in csrc/."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", ""),
        "/usr/local/cuda",
    ):
        p = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels need the CUDA toolkit"
        )
    return found


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Compile the named sources (default: all) in parallel; return their
    library paths. Sources whose library already exists are skipped."""
    srcs = sources()
    names = list(srcs) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, pathlib.Path] = {}
    for name in names:
        if name not in srcs:
            raise KeyError(f"no kernel source {name}.cu in {CSRC}")
        lib = _lib_path(srcs[name])
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (time.perf_counter(), tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    for name, (t0, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}"
            )
        tmp.replace(out[name])  # atomic publish
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.gpq_error_string.argtypes = [INT]
            lib.gpq_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def declare(source: str, argtypes: dict[str, Sequence]) -> None:
    """Declare the argument types of each ``<name>_launch`` in
    ``csrc/<source>.cu``, by name, in their C order. Builds nothing."""
    for name, types in argtypes.items():
        _SIGNATURES[source, name] = tuple(types)


def entry(source: str, name: str) -> tuple[Callable, Callable]:
    """``<name>_launch`` of ``lib<source>``, bound to its declaration, and
    the library's ``gpq_error_string``; the library built on first use."""
    got = _ENTRIES.get((source, name))
    if got is None:
        lib = library(source)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _SIGNATURES[source, name]
        fn.restype = INT
        got = _ENTRIES[source, name] = (fn, lib.gpq_error_string)
    return got


def launch(source: str, name: str, *args) -> None:
    """Enqueue ``<name>_launch(*args)`` of ``lib<source>`` without
    synchronising; raise RuntimeError on a non-zero return code, else
    count the launch."""
    fn, error_string = entry(source, name)
    rc = fn(*args)
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on CUDA tensor ``t``'s device
    (also under ``torch.cuda.stream`` and in a graph's capture): the
    stream object's ``cuda_stream`` at a tenth of its host time."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
