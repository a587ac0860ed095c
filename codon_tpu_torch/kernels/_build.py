"""Build the CUDA kernels with plain nvcc and bind them with ctypes.

`load()` compiles `csrc/*.cu` at first use into one shared library under
`kernels/_build/` (listed in .gitignore), named by a hash of the sources and
the flags, so a changed source rebuilds and an unchanged one loads the
library already built. The sources have a plain C interface and include no
PyTorch header: nvcc takes seconds, not the minutes that
`torch.utils.cpp_extension.load` takes for a source built against torch.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes: every pointer and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to a 32-bit int
_SIGNATURES = {
    "codon_cac_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _P],
    "codon_spatial_logits": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "codon_cac_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P],
}

_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcodon_cac_{h.hexdigest()[:16]}.so")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def build() -> tuple:
    """Compile if needed. -> (library path, seconds spent compiling; 0.0 if
    the library for these sources was already built)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent build of the
    # same sources never loads a half-written file
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in _sources() if p.endswith(".cu")]]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.time() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    if res.stderr.strip():
        print(res.stderr.strip(), file=sys.stderr)
    os.replace(tmp, path)
    print(f"codon_tpu_torch: built {os.path.basename(path)} with nvcc in "
          f"{dt:.1f} s", file=sys.stderr)
    return path, dt


def load():
    """The bound library (built on first call in this process)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.codon_cuda_error_string.argtypes = [ctypes.c_int]
        lib.codon_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = load().codon_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
