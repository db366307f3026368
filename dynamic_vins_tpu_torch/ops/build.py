"""Build the port's native sources and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc (for sm_90a, plain C entry
points, no PyTorch headers: a few seconds), each `csrc/<name>.c` with
the host C compiler and each `csrc/<name>.cpp` with the host C++
compiler (no fused multiply-adds: the line detector reproduces
OpenCV's double arithmetic), into `build/kernels/<name>-<hash>.so` at the
repository root, keyed by a hash of the source and flags, at first use.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
HOST_CC_FLAGS = ["-O2", "-shared", "-fPIC"]
HOST_CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17",
                  "-ffp-contract=off"]

_lock = threading.Lock()
_loaded: dict = {}
build_logs: dict = {}      # name -> nvcc output (-Xptxas -v lines)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _host_cc(cxx: bool = False) -> str:
    cands = (os.environ.get("CXX"), "c++", "g++", "clang++") if cxx \
        else (os.environ.get("CC"), "cc", "gcc", "clang")
    for cand in cands:
        found = cand and shutil.which(cand)
        if found:
            return found
    kind = "C++" if cxx else "C"
    raise RuntimeError(f"no host {kind} compiler ({', '.join(cands[1:])}) "
                       f"found: the port's {kind} sources build at first "
                       f"use")


def _source(name: str):
    """(source path, flags) of csrc/<name>.cu, .cpp or .c."""
    for suffix, flags in ((".cu", NVCC_FLAGS), (".cpp", HOST_CXX_FLAGS)):
        src = CSRC / f"{name}{suffix}"
        if src.exists():
            return src, flags
    return CSRC / f"{name}.c", HOST_CC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(name: str, force: bool = False) -> Path:
    """Compile csrc/<name>.cu (nvcc), .cpp or .c (host compilers)
    unless an up-to-date library exists (or `force`)."""
    out = library_path(name)
    if out.exists() and not force:
        return out
    src, flags = _source(name)
    cc = _nvcc() if src.suffix == ".cu" else \
        _host_cc(cxx=src.suffix == ".cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed for {name}:\n"
                           f"{build_logs[name]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
