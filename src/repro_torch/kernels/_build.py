"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers) and
is compiled at first use, in-process, with::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

into ``kernels/build/`` (git-ignored), then loaded with ``ctypes``.  The
library name carries the hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt and a stale
library is never loaded.  Pointers and the CUDA stream pass as
``c_void_p``; every C entry returns ``cudaGetLastError()`` and
:meth:`Kernel.launch` raises when it is not 0.

Nothing here runs at import time: the CPU tests import every module, and a
machine without ``nvcc`` never builds anything.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attn", "selective_attn", "ssd_chunk")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # source name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of the source,
    of every header under ``csrc/`` (a source may include any of them) and
    of the flags."""
    data = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha1(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> Dict[str, float]:
    """Compile every source in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns seconds per source
    built (empty when all were current).  Raises with nvcc's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    secs = {}
    errors = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


class Kernel:
    """One kernel of a source: its C entry points (one per input dtype),
    and the count of its launches.

    ``launches`` grows by one in :meth:`launch`, right where the kernel is
    launched, and nowhere else; a run resets it to 0 before the work it
    wants to attribute.  A kernel with several routes (one C entry each)
    also counts each call under its route in ``route_launches``."""

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name
        self.source = source
        self.argtypes = argtypes + [ctypes.c_void_p]    # ..., stream
        self.launches = 0
        self.route_launches: Dict[str, int] = {}
        self._entries = {}      # suffix -> bound C entry

    def launch(self, suffix: str, *args, route: str = "") -> None:
        """Launch the entry ``<name>_<suffix>`` on the current stream;
        ``route`` names the route it takes, if the kernel has several."""
        import torch

        fn = self._entries.get(suffix)
        if fn is None:
            fn = getattr(library(self.source), f"{self.name}_{suffix}")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._entries[suffix] = fn
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name}_{suffix} failed to launch "
                f"(cudaError {err})")
        self.launches += 1
        if route:
            self.route_launches[route] = self.route_launches.get(route, 0) + 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0
        k.route_launches = {}
