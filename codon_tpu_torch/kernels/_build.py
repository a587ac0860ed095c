"""Build the CUDA kernels with plain nvcc and bind them with ctypes.

`load()` compiles `csrc/*.cu` at first use, one nvcc a source, all started
together, and links them into one shared library under `kernels/_build/`
(listed in .gitignore), named by a hash of the sources and the flags, so a
changed source rebuilds and an unchanged one loads the library already
built. The sources have a plain C interface and include no PyTorch
header: nvcc takes seconds, not the minutes that
`torch.utils.cpp_extension.load` takes for a source built against torch.
ptxas reports each kernel's registers, shared memory and spills (`-Xptxas
-v`); the report is kept beside the library (`<library>.log`), its kernel
names demangled by the toolkit's cu++filt, and read by `ptxas_usage()`.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry point -> argtypes: every pointer and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to a 32-bit int
_SIGNATURES = {
    "codon_cac_stats": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    "codon_spatial_logits": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "codon_cac_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    "codon_copy4d": [_P, _P, _L, _L, _L, _L, _P],
    "codon_copyflat": [_P, _P, _L, _L, _L, _L, _P],
    "codon_copy3d": [_P, _P, _L, _L, _L, _P],
    "codon_copy_ring_grid": [ctypes.POINTER(_I)],
    "codon_quant_im2col": [_I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P],
    "codon_dequant_epilogue": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _P],
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
    return os.path.join(BUILD_DIR, f"libcodon_kernels_{h.hexdigest()[:16]}.so")


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
    # compile and link to private names, then rename: a concurrent build of
    # the same sources never loads a half-written file
    tmp = f"{path}.{os.getpid()}.tmp"
    jobs = []
    t0 = time.time()
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs = [obj for _, obj, _ in jobs]
    try:
        # every compile waited for before a failure is reported
        runs = []
        for cmd, _, proc in jobs:
            out = "".join(proc.communicate())
            runs.append((cmd, proc.returncode, out))
        cmd = [nvcc(), *ARCH, "-shared", "-o", tmp, *objs]
        if all(rc == 0 for _, rc, _ in runs):
            res = subprocess.run(cmd, capture_output=True, text=True)
            runs.append((cmd, res.returncode, res.stdout + res.stderr))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    dt = time.time() - t0
    for cmd, rc, out in runs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    said = "".join(out for _, _, out in runs)
    with open(f"{path}.log", "w") as f:
        f.write(demangle(said))
    # ptxas' per-kernel report goes to the log; anything else is shown
    other = [ln for ln in said.splitlines()
             if ln.strip() and not ln.startswith("ptxas info")
             and not re.match(r"\s+\d+ bytes stack frame", ln)]
    if other:
        print("\n".join(other), file=sys.stderr)
    os.replace(tmp, path)
    print(f"codon_tpu_torch: built {os.path.basename(path)} with nvcc in "
          f"{dt:.1f} s", file=sys.stderr)
    return path, dt


def demangle(report: str) -> str:
    """ptxas' report with each mangled kernel name replaced by what
    cu++filt (beside nvcc) makes of it, without its parameters, e.g. 'void
    (anonymous namespace)::cac_apply_kernel<__half>'; unchanged if
    cu++filt is missing or fails."""
    names = sorted(set(re.findall(r"\b_Z\w+", report)))
    tool = os.path.join(os.path.dirname(nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return report
    res = subprocess.run([tool, "-p", *names], capture_output=True, text=True)
    plain = res.stdout.splitlines()
    if res.returncode or len(plain) != len(names):
        return report
    table = dict(zip(names, plain))
    return re.sub(r"\b_Z\w+", lambda m: table[m.group()], report)


def ptxas_usage(path: str) -> dict:
    """{kernel: {"registers", "smem_bytes", "spill_bytes"}} from the ptxas
    report of the library at `path`, or {} if it was built without one.
    smem_bytes is static shared memory; a kernel's dynamic shared memory
    is set at launch."""
    log = f"{path}.log"
    if not os.path.exists(log):
        return {}
    usage, name = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(.+?)' for", line)
            if m:
                # a demangled name: the kernel and its template arguments
                short = (None if m.group(1).startswith("_Z") else
                         re.search(r"\w+_kernel(<[^>]*>)?", m.group(1)))
                name = short.group() if short else m.group(1)
                usage[name] = {"registers": 0, "smem_bytes": 0,
                               "spill_bytes": 0}
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                usage[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[name]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                usage[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return usage


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
