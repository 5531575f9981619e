"""The shading kernels (csrc/shade.cu, csrc/shade_grad.cu) and the hit
record's (csrc/trace.cu) built for the CPU with g++, so that CPU tests run
their arithmetic without a card.

The sources compile as C++ against a stand-in `cuda_runtime.h` that
defines the CUDA qualifiers away and holds each thread's block and thread
index, and every `kernel<<<grid, block, ...>>>(args)` launch becomes loops
over the grid's blocks and threads, run one after another.  That is sound
for kernels whose threads share nothing (no shared memory, barriers or
atomics), as these kernels'.  A read through the read-only cache
(`__ldg`) is a plain read.  The pointers are the CPU tensors' own; the
stream is ignored.  glibc's cosf and sinf may round otherwise
than torch's CPU kernels, so GI directions may differ by an ulp from the
plain version's.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

from simd_raytracer_tpu_torch import kernels

SOURCES = ("shade.cu", "shade_grad.cu", "trace.cu")
HEADERS = ("shade.cuh",)

RUNTIME = """#pragma once
#include <cmath>
#include <cstdint>
using std::isnan;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __ldg(p) (*(p))
typedef void* cudaStream_t;
struct SrtIndex { unsigned x, y, z; };
static thread_local SrtIndex blockIdx, threadIdx;
inline int cudaGetLastError() { return 0; }
"""

LAUNCH = re.compile(r"(\w+)\s*<<<(.*?)>>>\s*\(", re.S)


def _top_level(args: str) -> list:
    """`args` split at its commas outside parentheses and angle brackets."""
    parts, depth, start = [], 0, 0
    for j, ch in enumerate(args):
        depth += {"(": 1, "<": 1, ")": -1, ">": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            parts.append(args[start:j].strip())
            start = j + 1
    return parts + [args[start:].strip()]


def unlaunch(src: str) -> str:
    """`src` with each kernel launch as loops over blocks and threads."""
    out, pos = [], 0
    while (m := LAUNCH.search(src, pos)):
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        grid, block = _top_level(m.group(2))[:2]
        out += [src[pos:m.start()],
                f"for (unsigned b_ = 0; b_ < ({grid}); ++b_) "
                f"for (unsigned t_ = 0; t_ < ({block}); ++t_) {{ "
                f"blockIdx.x = b_; threadIdx.x = t_; "
                f"{m.group(1)}({src[m.end():j - 1]}); }}"]
        pos = j
    return "".join(out) + src[pos:]


def build(out_dir: str) -> ctypes.CDLL:
    """Compile the shading and record kernels for the CPU into `out_dir`
    and load them, bound as `kernels.library()` binds them."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the CPU build of the kernels "
                           "needs it")
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as f:
        f.write(RUNTIME)
    for name in HEADERS:
        shutil.copy(os.path.join(kernels.CSRC, name), out_dir)
    objs = []
    for name in SOURCES:
        with open(os.path.join(kernels.CSRC, name)) as f:
            src = unlaunch(f.read())
        objs.append(os.path.join(out_dir, name + ".cpp"))
        with open(objs[-1], "w") as f:
            f.write(src)
    lib = os.path.join(out_dir, "libkernels_cpu.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", out_dir, "-o", lib, *objs],
                   check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(lib)
    kernels.bind_shade(cdll)
    kernels.bind_trace(cdll)
    return cdll
