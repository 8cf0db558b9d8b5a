"""Build and load the package's hand-written CUDA kernels and host code.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/lib<name>-<hash>.so``, at its first
use, and loaded with ``ctypes``; a source may include the headers
(``csrc/*.cuh``) beside it. Each ``csrc/<name>.cc`` (host code: the
evaluators' rotated overlap) is compiled the same way by the host C++
compiler (``load_host``). The file name carries a hash of the source (and,
for a ``.cu``, of the headers), so an edited source or header is rebuilt
and a stale library is never loaded. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's flags for the same source (hgsfusion_tpu/native)
HOST_CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    every header in ``csrc/`` (``*.cuh``: a source may include any of them)
    and of the flags."""
    digest = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, all at once.

    Returns {name: {"seconds": wall time, "ptxas": compiler report}} for the
    sources built by this call.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def host_library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cc").read_bytes()
    digest = hashlib.sha1(src + " ".join(HOST_CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The host library of ``csrc/<name>.cc``, built by ``g++`` (or ``$CXX``)
    first if needed; thread-safe."""
    with _host_lock:
        lib = _loaded.get(name)
        if lib is None:
            out = host_library_path(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cxx = os.environ.get("CXX", "g++")
                proc = subprocess.run([cxx, *HOST_CXX_FLAGS, str(CSRC_DIR / f"{name}.cc"),
                                       "-o", tmp], capture_output=True, text=True)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"{cxx} failed for csrc/{name}.cc:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            _loaded[name] = lib
    return lib
