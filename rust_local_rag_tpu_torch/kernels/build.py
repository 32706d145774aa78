"""Build the native sources in csrc/ into shared libraries with a plain C
interface, and load them with ctypes.

Two toolchains, chosen by the library:

  * CUDA kernels (csrc/<name>.cu), on the card's machine only:

        nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
             -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

  * the host tier (csrc/<name>.cpp: the BM25 index, the WordPiece
    tokenizer, the JSON response serializer and the PDF text extractor),
    wherever the port runs, the CPU tests included:

        g++ -O3 -fPIC -std=c++17 -shared -o build/lib<name>-<hash>.so csrc/<name>.cpp [-lz]

    (-lz for the PDF extractor only, as native/Makefile links it).

Each library is built at first use into rust_local_rag_tpu_torch/build/
(listed in .gitignore). The file name carries a hash of the sources and
flags, so an edited source builds anew and an unchanged one is reused. The
output is written to a temporary name and renamed into place, so processes
that build the same library at once each finish with a whole file and no
lock file is needed. The compiler's output (for nvcc the ``-Xptxas -v``
lines: registers, shared memory, spills per kernel) is kept beside the
library for the chip smoke to print. ``build_all`` starts one compiler per
source, all at once.
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
# the flags of the JAX package's native/Makefile; -lz goes to the one
# library that inflates streams (GXX_LIBS)
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
GXX_LIBS = {"pdftext": ("-lz",)}

# libraries built from csrc/<name>.cpp with g++; every other one is
# csrc/<name>.cu built with nvcc
HOST_LIBRARIES = ("lexical", "wordpiece", "serializer", "pdftext")

# library name -> its ctypes signatures {function: (restype, argtypes)};
# pointers are passed as Python ints (c_void_p), byte strings as c_char_p
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_I32, _I64, _S = ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "score_segmax": {
        "score_segmax_masked": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P]),
        "score_segmax_unmasked": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P]),
        "score_segmax_error_string": (ctypes.c_char_p, [_I]),
    },
    "attention": {
        "attention_fwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, *[_L] * 9, _I, _I, _P]),
        "attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "segmax": {
        "segmax_rows": (_I, [_P, _P, _L, _L, _I, _L, _I, _I, _P]),
        "segmax_error_string": (ctypes.c_char_p, [_I]),
    },
    "stream_probe": {
        "stream_segmax": (_I, [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P]),
        "read_probe": (_I, [_P, _P, _P, _L, _I, _L, _I, _I, _I, _I, _P]),
        "stream_probe_error_string": (ctypes.c_char_p, [_I]),
    },
    "resident_dot": {
        "resident_dot_segmax": (_I, [_P, _P, _P, _I, _L, _I, _L, _I, _I, _I, _P]),
        "resident_dot_error_string": (ctypes.c_char_p, [_I]),
    },
    "lexical": {
        "bm25_create": (_P, []),
        "bm25_destroy": (None, [_P]),
        "bm25_add_tokens": (None, [_P, _I64, _S, _I64]),
        "bm25_remove_chunk": (None, [_P, _I64]),
        "bm25_contains": (_I32, [_P, _I64]),
        "bm25_num_docs": (_I64, [_P]),
        "bm25_score": (_I64, [_P, _S, _I64, _I64, _P, _P]),
        "bm25_score_tokens": (_I64, [_P, _S, _I64, _I64, _P, _P]),
        "bm25_unseen_mass": (ctypes.c_float, [_P, _S, _I64]),
        "bm25_compile_all": (_I64, [_P]),
        "bm25_drop_stale": (None, [_P, _P, _I64]),
    },
    "wordpiece": {
        "wp_create": (_P, [_S, _I64, _I32, _I32, _I32, _I32, _I32, _I32]),
        "wp_encode_batch": (None, [_P, _S, _P, _I32, _I32, _P, _P]),
        "wp_destroy": (None, [_P]),
    },
    "serializer": {
        "resp_create": (_P, []),
        "resp_destroy": (None, [_P]),
        "resp_register": (None, [_P, _I64, _S, _I64]),
        "resp_register_bulk": (None, [_P, _P, _S, _P, _I64]),
        "resp_clear_slot": (None, [_P, _I64]),
        "resp_count": (_I64, [_P]),
        "resp_serialize": (_I64, [_P, _P, _P, _P, _P, _I64, ctypes.c_float, _P, _I64]),
        "resp_serialize_batch": (_I64, [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _P, _I64, _P]),
        "resp_serialize_batch_rr": (
            _I64, [_P, *[_P] * 8, _I64, _I64, ctypes.c_float, ctypes.c_float, _P, _I64, _P],
        ),
    },
    "pdftext": {  # as the JAX package's ingest/pdf.py binds them
        "pdf_extract_text": (_I, [_S, _I64, ctypes.POINTER(_S), ctypes.POINTER(_I64)]),
        "pdf_free_text": (None, [_S]),
    },
}


@dataclass
class BuildResult:
    name: str
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str        # compiler output of the build that made `path`


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


def gxx_path() -> str:
    """g++ on PATH; raises FileNotFoundError when there is none."""
    found = shutil.which("g++")
    if not found:
        raise FileNotFoundError("g++ not found on PATH (the port's host libraries build with it)")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cpp" if name in HOST_LIBRARIES else f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh", ".h", ".cpp")):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode() + b"\0" + " ".join(GXX_FLAGS).encode()
             + b"\0" + " ".join(GXX_LIBS.get(name, ())).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    if name in HOST_LIBRARIES:
        cmd = [gxx_path(), *GXX_FLAGS, "-o", tmp, _source(name), *GXX_LIBS.get(name, ())]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, BuildResult]:
    """Build every stale library, one compiler per source started together.
    Raises RuntimeError with the compiler output when a build fails."""
    results: Dict[str, BuildResult] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            with open(out + ".log.txt") as f:
                results[name] = BuildResult(name, out, 0.0, f.read())
        else:
            running[name] = (out, _start(name, out))
    for name, (out, proc) in running.items():
        text, _ = proc.communicate()
        tmp = f"{out}.{os.getpid()}.tmp"
        if proc.returncode != 0:
            raise RuntimeError(f"building {_source(name)} failed:\n{text}")
        with open(out + ".log.txt", "w") as f:
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
