"""The division-free bilinear select ("fast"): the CUDA kernel
`csrc/fast_select.cu` and its plain version.

Counterpart of `simd_raytracer_tpu.ops.intersect_mxu.mt_select_fast`, jnp
code that XLA compiles into one fusion on the TPU.  Every Moller-Trumbore
numerator is a scalar triple product, bilinear in per-ray features (o, d,
c = o x d) and per-triangle constants (n = e1 x e2, v0 . n, v0 x e2,
e1 x v0); the accept tests compare numerators against |det| with no
division, and one division per accepted pair gives the sort key.  The last
ulps differ from the classic formulation, so exact-tie winners on shared
edges can flip; the differentiable refine recomputes the winner's t, u, v
either way.

Rays and triangles are re-centred on the mean of v0 first: the
factorisation is translation invariant, and centring keeps the o x d
cancellation at scene scale wherever the scene sits.  The per-triangle
constants form a `FastTable`, built by `fast_table` with the same torch
ops on the device of the triangles, once per frame by `bind` (the select
bound to a frame's Geometry object); the kernel and the plain version
read the same table, so they share the centre's bits.
The table is one (T padded to FAST_TILE, 16) array, a triangle's 16
constants in a row in the order the kernel's tests use them, so that the
kernel reads a row as four 16-byte words; the plain version reads its
columns.

`mt_select_fast` runs the kernel for CUDA tensors (float32, as the brute-
force kernel) and the plain version, blocked over triangles like
`ops/intersect.py::_pair_blocks` and computed in the dtype of the rays,
for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .. import kernels
from ..models.scene import cross3
from ..utils import profiling
from .intersect import BIG, _block, counted_select
from .select_keys import (check_eps, check_table, decode_any, decode_closest,
                          launch, seed_keys)

# Columns of FastTable.pack (rows of FastTable.soa), in the order the
# kernel's tests read them as four float4 words: n (3) and v0 . n (the cull
# test; the t test), e2 (3) and wu = v0 x e2 (3) (the u test), wv = e1 x v0
# (3) and e1 (3) (the v test), with v0 centred.
N, V0N, E2, WU, WV, E1 = 0, 3, 4, 7, 10, 13
ROWS = 16
# The kernel's shape (csrc/fast_select.cu's kThreads, kWidth, kTile):
# FAST_THREADS threads a block, each holding FAST_WIDTH rays, and FAST_TILE
# triangles staged per step; the table is padded to a whole number of
# tiles.
FAST_THREADS = 128
FAST_WIDTH = 3
FAST_TILE = 128


@dataclasses.dataclass(frozen=True)
class FastTable:
    """Per-triangle constants of the fast select, from one (v0, e1, e2)."""

    center: torch.Tensor     # (3,) mean of v0
    pack: torch.Tensor       # (T padded to FAST_TILE, 16), zero padding
    source: tuple            # the (v0, e1, e2) it was built from, detached

    @property
    def soa(self) -> torch.Tensor:
        """(16, T) view of pack: row k is constant k of every triangle."""
        return self.pack[:self.source[0].shape[0]].T


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a and b view the same memory as the same tensor."""
    return (a.device == b.device and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride()
            and a.data_ptr() == b.data_ptr())


@profiling.spanned("table")
def fast_table(v0, e1, e2, dtype=None) -> FastTable:
    """The fast select's per-triangle constants, computed in `dtype`
    (default v0's) on v0's device with the plain version's ops; counted
    in `build.table` (the render path builds one per frame)."""
    src = tuple(x.detach() for x in (v0, e1, e2))
    dtype = v0.dtype if dtype is None else dtype
    v0, e1, e2 = (x.detach().to(dtype) for x in (v0, e1, e2))
    center = v0.mean(dim=0)
    v0 = v0 - center[None, :]
    n = cross3(e1, e2)
    v0n = n[:, 0] * v0[:, 0] + n[:, 1] * v0[:, 1] + n[:, 2] * v0[:, 2]
    t = v0.shape[0]
    pack = torch.zeros((-(-t // FAST_TILE) * FAST_TILE, ROWS), dtype=dtype,
                       device=v0.device)
    pack[:t] = torch.cat([n, v0n[:, None], e2, cross3(v0, e2),
                          cross3(e1, v0), e1], dim=1)
    profiling.count("build.table")
    return FastTable(center=center, pack=pack, source=src)


def _checked_table(table, v0, e1, e2, dtype) -> FastTable:
    """`table` when it was built from these (v0, e1, e2) in `dtype`, a new
    table when None; raises for a table of other triangles."""
    if table is None:
        return fast_table(v0, e1, e2, dtype)
    if (table.pack.dtype != dtype
            or not all(map(_same, table.source, (v0, e1, e2)))):
        raise ValueError("fast select: the table was built from other "
                         "triangles or in another dtype than this call's "
                         f"{dtype}")
    return table


def numerators(o, d, c, blk):
    """(det, t_num, u_num, v_num), each (R, B): the centred rays (o, d and
    c = o x d, each (R, 3)) against the table columns `blk` (16, B; a slice
    of FastTable.soa), every sum left to right as csrc/fast_select.cu adds
    it."""

    def col(a, k):                                     # (R,) -> (R, 1)
        return a[:, k:k + 1]

    def row(first, k):                                 # -> (1, B)
        return blk[first + k][None, :]

    det = -(col(d, 0) * row(N, 0) + col(d, 1) * row(N, 1)
            + col(d, 2) * row(N, 2))
    t_num = (col(o, 0) * row(N, 0) + col(o, 1) * row(N, 1)
             + col(o, 2) * row(N, 2)) - row(V0N, 0)
    u_num = (col(c, 0) * row(E2, 0) + col(c, 1) * row(E2, 1)
             + col(c, 2) * row(E2, 2)
             + col(d, 0) * row(WU, 0) + col(d, 1) * row(WU, 1)
             + col(d, 2) * row(WU, 2))
    v_num = (col(d, 0) * row(WV, 0) + col(d, 1) * row(WV, 1)
             + col(d, 2) * row(WV, 2)
             - (col(c, 0) * row(E1, 0) + col(c, 1) * row(E1, 1)
                + col(c, 2) * row(E1, 2)))
    return det, t_num, u_num, v_num


def mt_select_fast_reference(o, d, v0, e1, e2, eps: float, cull: bool,
                             tri_mask: Optional[torch.Tensor] = None,
                             t_max: Optional[torch.Tensor] = None,
                             any_hit: bool = False,
                             table: Optional[FastTable] = None):
    """Plain torch version, in the dtype of the rays -> (idx (R,) int32,
    hit (R,) bool).  The optional window is inclusive and division-free,
    t_num * s <= t_max * |det|; with any_hit the reduction is one `any`
    and idx is zeros."""
    dtype = o.dtype
    tab = _checked_table(table, v0, e1, e2, dtype)
    o = o - tab.center[None, :]
    c = cross3(o, d)                                   # (R, 3) once per ray
    tm = None if t_max is None else t_max.to(dtype)[:, None]
    r = o.shape[0]
    hit = torch.zeros(r, dtype=torch.bool, device=o.device)
    best_t = torch.full((r,), BIG, dtype=dtype, device=o.device)
    best_i = torch.zeros(r, dtype=torch.int64, device=o.device)
    step = _block(r)
    for s in range(0, v0.shape[0], step):
        det, t_num, u_num, v_num = numerators(o, d, c, tab.soa[:, s:s + step])
        sgn = torch.where(det >= 0.0, 1.0, -1.0).to(dtype)
        adet = det * sgn
        ok = det > eps if cull else adet > eps
        us = u_num * sgn
        vs = v_num * sgn
        ok = ok & (us >= 0.0) & (us <= adet)
        ok = ok & (vs >= 0.0) & (us + vs <= adet)
        ok = ok & (t_num * sgn > eps * adet)
        if tri_mask is not None:
            ok = ok & tri_mask[None, s:s + step]
        if tm is not None:
            ok = ok & (t_num * sgn <= tm * adet)
        if any_hit:
            hit = hit | ok.any(dim=1)
            continue

        t_m = torch.where(ok, t_num / torch.where(ok, det, 1.0), BIG)
        blk_i = t_m.argmin(dim=1)                      # first minimum
        blk_t = t_m.gather(1, blk_i[:, None])[:, 0]
        upd = blk_t < best_t                # earlier blocks win ties
        best_t = torch.where(upd, blk_t, best_t)
        best_i = torch.where(upd, blk_i + s, best_i)
    if any_hit:
        return torch.zeros(r, dtype=torch.int32, device=o.device), hit
    return best_i.to(torch.int32), best_t < BIG


@counted_select
def mt_select_fast(o, d, v0, e1, e2, eps: float, cull: bool,
                   tri_mask: Optional[torch.Tensor] = None,
                   t_max: Optional[torch.Tensor] = None,
                   any_hit: bool = False,
                   table: Optional[FastTable] = None):
    """The fast select under the contract of `ops.intersect.mt_select` ->
    (idx (R,) int32, hit (R,) bool): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  table: `fast_table(v0, e1, e2)` where
    the caller holds it (the select `bind` makes), built here otherwise.
    eps must be >= 0 on every device (the key merge needs t >= 0).

    The kernel takes FAST_THREADS * FAST_WIDTH rays a block and splits
    the FAST_TILE-triangle tiles evenly over `kernels.split` blocks per
    ray block, so a small call (a march hop) still fills the card, down to
    one tile a block (blocks of at least two or four tiles made the march
    call's kernel 19% and 81% slower, PERF.md)."""
    check_eps(eps)
    if not o.is_cuda:
        return mt_select_fast_reference(o, d, v0, e1, e2, eps, cull,
                                        tri_mask, t_max, any_hit, table)
    r, t = o.shape[0], v0.shape[0]
    tab = _checked_table(table, v0, e1, e2, torch.float32)
    tiles = -(-t // FAST_TILE)
    check_table("table", tab.pack, (tiles * FAST_TILE, ROWS), torch.float32,
                o.device)
    if tab.pack.data_ptr() % 16:
        raise ValueError("fast select: the table must be 16-byte aligned "
                         "(the kernel copies float4 words)")
    keys = seed_keys(torch.full((r,), BIG, dtype=torch.float32,
                                device=o.device))
    # A bool mask is read in place, one byte a triangle; None: all live.
    launch("fast", o, d, (v0, e1, e2), tri_mask, t_max, torch.bool,
           lambda o32, d32, mask, tmax: (
               o32.data_ptr(), d32.data_ptr(), tab.center.data_ptr(),
               None if tmax is None else tmax.data_ptr(), tab.pack.data_ptr(),
               None if mask is None else mask.data_ptr(), r, t,
               kernels.split(-(-r // (FAST_THREADS * FAST_WIDTH)), tiles,
                             kernels.sm_count(o.device.index or 0)),
               float(eps), int(bool(cull)), int(bool(any_hit)),
               keys.data_ptr()))
    if any_hit:
        return decode_any(keys)
    return decode_closest(keys)


def bind(accel, geom):
    """The fast select, bound to the fast_table of `geom`'s triangles when
    given: float32 on a CUDA device (the kernel's type), the geometry's
    dtype on the CPU (the accelerator is not read)."""
    if geom is None:
        return mt_select_fast
    return functools.partial(mt_select_fast, table=fast_table(
        geom.v0, geom.e1, geom.e2,
        torch.float32 if geom.v0.is_cuda else None))
