"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled at first use by nvcc (one process per
source, run together) and linked into one shared library with a plain C
interface, loaded with ctypes.  The library lands in
`_build/` beside this file, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# No FMA contraction (--fmad=false) and IEEE division: the kernels must
# round every step as the plain torch versions do, or near-tie winners and
# u + v <= 1 accepts flip.
# -Xptxas -v reports each kernel's registers, shared memory and spills
# (kept in `build_log`).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Blocks of 128 rays per SM a select call aims for when it splits its work
# over a second grid dimension (ops/intersect_brute.py::k1_split,
# ops/intersect_sweep.py::sweep_split).  An SM runs at most 16 such blocks
# at once (10 of the sweep's, by shared memory); more, smaller shares
# balance the blocks' early exits and uneven work.  `chip_smoke.py
# --fill-targets` times the two largest calls at 16, 32 and 64.
BLOCKS_PER_SM = 32

_lock = threading.Lock()
_lib = None
# Seconds the nvcc build took in this process (0.0 when the library was
# already built), set by library().
build_seconds = None
# What ptxas said about each kernel when the library was built (kept in a
# file beside it), set by library().
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "",
            os.path.join("/usr/local/cuda", "bin", "nvcc")]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsrt_kernels_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile every source into an object, all at once, and link them
    into `out`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources(), objs)]
    outs = [p.communicate() for p in procs]
    logs = [f"{o}{e}" for o, e in outs]
    try:
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
        link = subprocess.run([_nvcc(), "-gencode", NVCC_FLAGS[1], "-shared",
                               "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out + ".ptxas.txt", "w") as f:
        f.write("".join(logs))
    os.replace(tmp, out)


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # o, d, tmax, tri, mask | n_rays, n_tris, split | eps, cull, any_hit |
    # keys, stream
    lib.srt_mt_select.argtypes = [p] * 5 + [i] * 3 + [f, i, i] + [p, p]
    lib.srt_mt_select.restype = i
    # count, order, tnear, o, d, tri_soa, ids, mask | n_tiles, n_slices,
    # split | eps, cull, any_hit | keys, stream
    lib.srt_sweep_select.argtypes = [p] * 8 + [i] * 3 + [f, i, i] + [p, p]
    lib.srt_sweep_select.restype = i
    # o, d, tri, mask, node_box, node_link, leaf_tris | n_rays, n_nodes,
    # cap | eps, cull | idx, hit, stream
    lib.srt_kd_select.argtypes = [p] * 7 + [i] * 3 + [f, i] + [p] * 3
    lib.srt_kd_select.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            t0 = time.perf_counter()
            if not os.path.exists(path):
                _build(path)
            build_seconds = time.perf_counter() - t0
            if os.path.exists(path + ".ptxas.txt"):
                with open(path + ".ptxas.txt") as f:
                    build_log = f.read()
            _lib = _bind(path)
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
