"""Build the CUDA sources in csrc/ with nvcc into shared libraries with a
plain C interface, and load them with ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

Each library is built at first use into rust_local_rag_tpu_torch/build/
(listed in .gitignore). The file name carries a hash of the sources and
flags, so an edited source builds anew and an unchanged one is reused. The
output is written to a temporary name and renamed into place: there is no
lock file to wait on. ``-Xptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside the library for the chip smoke to print.
``build_all`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel library name -> its ctypes signatures {function: (restype, argtypes)}
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "score_segmax": {
        "score_segmax_masked": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "score_segmax_error_string": (ctypes.c_char_p, [_I]),
    },
}


@dataclass
class BuildResult:
    name: str
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    ptxas: str      # nvcc -Xptxas -v output of the build that made `path`


_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc, else /usr/local/cuda/bin/nvcc;
    raises FileNotFoundError when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh", ".h")):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, BuildResult]:
    """Build every stale library, one nvcc per source started together.
    Raises RuntimeError with the compiler output when a build fails."""
    results: Dict[str, BuildResult] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            with open(out + ".ptxas.txt") as f:
                results[name] = BuildResult(name, out, 0.0, f.read())
        else:
            running[name] = (out, _start(name, out))
    for name, (out, proc) in running.items():
        text, _ = proc.communicate()
        tmp = f"{out}.{os.getpid()}.tmp"
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_source(name)}:\n{text}")
        with open(out + ".ptxas.txt", "w") as f:
            f.write(text)
        os.replace(tmp, out)  # the log first: a present library has one
        results[name] = BuildResult(name, out, time.perf_counter() - t0, text)
    return results


def load(name: str) -> ctypes.CDLL:
    """The built library `name` with argtypes/restype set (built first if
    needed; cached for the process)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name].path
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[name] = lib
    return lib
