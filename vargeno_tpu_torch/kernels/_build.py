"""Build and load the port's CUDA kernels: one shared library per source in
``csrc/``, compiled with nvcc for sm_90a at first use into
``vargeno_tpu_torch/_build/`` under a name keyed by the source hash, and
loaded with ctypes. Nothing is compiled when a module is imported."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict = {}        # source name -> loaded ctypes.CDLL
build_logs: dict = {}   # source name -> nvcc/ptxas output of this process's
                        # build (register use); absent when the .so was cached


def source_path(name: str) -> str:
    return os.path.join(_PKG, "csrc", name + ".cu")


def _nvcc() -> str:
    for p in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if p and os.path.exists(p):
            return p
    raise RuntimeError("nvcc not found: the kernels are built from csrc/*.cu "
                       "with the CUDA toolkit")


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libvgt{name}_{tag}.so")


def _compile_command(name: str, out: str) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, source_path(name)]


def _build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless this version's library exists."""
    so = _library_path(name)
    if os.path.exists(so):
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run(_compile_command(name, tmp), stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{r.stdout}")
    os.replace(tmp, so)
    build_logs[name] = r.stdout


def load_library(name: str, bind) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built once per source version.
    ``bind(lib)`` sets restype/argtypes when the library is first loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build(name)
            lib = ctypes.CDLL(_library_path(name))
            bind(lib)
            _libs[name] = lib
        return lib
