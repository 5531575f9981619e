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
# over a second grid dimension (`split`).  An SM runs at most 16 such blocks
# at once (10 of the sweep's, by shared memory); more, smaller shares
# balance the blocks' early exits and uneven work.  `chip_smoke.py
# --fill-targets` times the two largest calls at 16, 32 and 64.
BLOCKS_PER_SM = 32


def split(groups: int, steps: int, n_sms: int) -> int:
    """Blocks per ray group of a select call of `groups` groups (a block
    each unsplit) sharing `steps` units of work (triangle tiles, schedule
    steps) on n_sms SMs: enough for BLOCKS_PER_SM blocks an SM, 1 when the
    groups alone do that, at most `steps` and a grid dimension's 65,535."""
    want = -(-BLOCKS_PER_SM * n_sms // max(groups, 1))
    return max(1, min(want, steps, 65535))

_lock = threading.Lock()
_lib = None
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
    # o, d, tri, ids, mask, leaf_tile, leaf_len, node_box, node_link |
    # n_rays, rays_per_block, lanes | eps, cull | idx, hit, counter, stream
    lib.srt_kd_select.argtypes = [p] * 9 + [i] * 3 + [f, i] + [p] * 4
    lib.srt_kd_select.restype = i
    # o, d, center, tmax, pack, mask | n_rays, n_tris, split | eps, cull,
    # any_hit | keys, stream
    lib.srt_fast_select.argtypes = [p] * 6 + [i] * 3 + [f, i, i] + [p, p]
    lib.srt_fast_select.restype = i
    # rows, perm, grad | n, width, n_rows, is_double | partial, out, stream
    ll = ctypes.c_longlong
    lib.srt_gather_grad.argtypes = [p] * 3 + [ll, i, ll, i] + [p] * 3
    lib.srt_gather_grad.restype = i
    bind_shade(lib)
    bind_trace(lib)
    return lib


def bind_shade(lib: ctypes.CDLL) -> None:
    """Declare the shading kernels' C interface (csrc/shade.cu and
    csrc/shade_grad.cu) on `lib`, and refuse a library whose argument
    blocks differ in size from ops/shade.py's ctypes mirrors."""
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    # need, m, n_lights | position, hit_n, face_n, smooth, light_pos,
    # light_intensity | shadow_bias, four_pi | shadow_o, shadow_d, max_t,
    # term, stream
    lib.srt_shade_lights.argtypes = [p, ll, i] + [p] * 6 + [f, f] + [p] * 5
    lib.srt_shade_lights.restype = i
    # need, m, n_lights | occ, term, factor, stream
    lib.srt_shade_factor.argtypes = [p, ll, i] + [p] * 4
    lib.srt_shade_factor.restype = i
    # args (ops/shade.py::BounceArgs, by reference), stream
    lib.srt_shade_bounce.argtypes = [p, p]
    lib.srt_shade_bounce.restype = i
    # args (ops/shade.py::BounceGradArgs, by reference), stream
    lib.srt_shade_bounce_grad.argtypes = [p, p]
    lib.srt_shade_bounce_grad.restype = i
    # need, m, n_lights | position, hit_n, face_n, smooth, light_pos,
    # light_intensity, occ, g_factor | four_pi | g_position, g_hit_n,
    # g_face_n, light_key, light_grad, stream
    lib.srt_shade_lights_grad.argtypes = [p, ll, i] + [p] * 8 + [f] + [p] * 6
    lib.srt_shade_lights_grad.restype = i
    from .ops.shade import BounceArgs, BounceGradArgs
    _check_sizes(((lib.srt_shade_args_size, BounceArgs),
                  (lib.srt_shade_grad_args_size, BounceGradArgs)),
                 "ops/shade.py")


def bind_trace(lib: ctypes.CDLL) -> None:
    """Declare the hit record's kernels' C interface (csrc/trace.cu) on
    `lib`, and refuse a library whose argument blocks differ in size from
    ops/intersect.py's ctypes mirrors."""
    # args (ops/intersect.py::RecordArgs or RecordGradArgs, by reference),
    # stream
    for fn in (lib.srt_trace_record, lib.srt_trace_record_grad):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    from .ops.intersect import RecordArgs, RecordGradArgs
    _check_sizes(((lib.srt_trace_args_size, RecordArgs),
                  (lib.srt_trace_grad_args_size, RecordGradArgs)),
                 "ops/intersect.py")


def _check_sizes(pairs, where: str) -> None:
    """Refuse a library whose size function of an argument block differs
    from its ctypes mirror's size."""
    for fn, mirror in pairs:
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
        if fn() != ctypes.sizeof(mirror):
            raise RuntimeError(
                f"the library's {mirror.__name__} takes {fn()} bytes, "
                f"{where}'s {ctypes.sizeof(mirror)}")


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (the set-up phase
    `kernel_library` of utils/profiling.py::SETUP: the nvcc build or the
    load, and the binding)."""
    global _lib, build_log
    from .utils.profiling import SETUP
    with _lock:
        if _lib is None:
            with SETUP.phase("kernel_library"):
                path = library_path()
                if not os.path.exists(path):
                    _build(path)
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


def data_ptr(t, dtype, shape: tuple, device) -> int:
    """The data pointer of tensor `t` after checking what a kernel takes:
    its dtype, shape and device, and a contiguous layout."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"a kernel expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"a kernel's {tuple(t.shape)} input is not "
                         f"contiguous")
    return t.data_ptr()


def stream(device) -> int:
    """The handle of CUDA `device`'s current stream, which every launch
    takes."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
