"""Brute-force select: the CUDA kernel `csrc/mt_select.cu` and its plain
version.

Counterpart of `simd_raytracer_tpu.ops.intersect_pallas` (the Pallas TPU
kernel `_kernel`, reached through `mt_select_pallas`).  Same contract and
the same answers: the closest accepted triangle per ray, lowest index on
exact t ties, `idx` 0 when nothing is accepted and otherwise the closest
winner even when it lies beyond `t_max` (then `hit` is False); with
`any_hit`, whether any accepted pair lies inside the inclusive window.
Everything is computed in float32, as the TPU kernel does.

The kernel splits the triangle range over `kernels.split` blocks per 128
rays when the ray blocks alone would not fill the card; blocks merge
winners through the packed keys of `ops/select_keys.py`.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..models.scene import pack_triangles
from .intersect import BIG, any_pair, closest_pairs, counted_select
from .select_keys import (check_eps, check_table, decode_any, decode_closest,
                          key_t, launch, seed_keys)

# Rays per block and triangles per staged tile (kRays, kTile of
# csrc/mt_select.cu).
RAY_BLOCK = 128
TRI_TILE = 256


def mt_select_reference(o, d, v0, e1, e2, eps, cull, tri_mask=None,
                        t_max=None, any_hit=False):
    """Plain torch version of the kernel: (idx (R,) int32, hit (R,) bool)."""
    o, d, v0, e1, e2 = (x.float() for x in (o, d, v0, e1, e2))
    tm = None if t_max is None else t_max.float().reshape(-1)
    if any_hit:
        hit = any_pair(o, d, v0, e1, e2, eps, cull, tri_mask, tm)
        return torch.zeros_like(hit, dtype=torch.int32), hit
    best_t, best_i = closest_pairs(o, d, v0, e1, e2, eps, cull, tri_mask)
    won = best_t < BIG
    hit = won if tm is None else won & (best_t <= tm)
    return torch.where(won, best_i, 0).to(torch.int32), hit


@counted_select
def mt_select_brute(o, d, v0, e1, e2, eps, cull, tri_mask=None, t_max=None,
                    any_hit=False, tri_soa=None):
    """The brute-force select: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  tri_soa is pack_triangles(v0, e1, e2) where
    the caller holds it (the select `bind` makes); it is packed here
    otherwise.  eps must be >= 0 on every device (the key merge needs
    t >= 0)."""
    check_eps(eps)
    if not o.is_cuda:
        return mt_select_reference(o, d, v0, e1, e2, eps, cull, tri_mask,
                                   t_max, any_hit)
    r, t = o.shape[0], v0.shape[0]
    tri = pack_triangles(v0, e1, e2) if tri_soa is None else tri_soa
    check_table("tri_soa", tri, (9, t), torch.float32, o.device)
    if tri_mask is None:
        tri_mask = torch.ones(t, dtype=torch.int32, device=o.device)
    if t_max is None:
        t_max = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    keys = seed_keys(torch.full((r,), BIG, dtype=torch.float32,
                                device=o.device))
    _, tmax = launch(
        "brute", o, d, (v0, e1, e2), tri_mask, t_max, torch.int32,
        lambda o32, d32, mask, tmax: (
            o32.data_ptr(), d32.data_ptr(), tmax.data_ptr(), tri.data_ptr(),
            mask.data_ptr(), r, t,
            kernels.split(-(-r // RAY_BLOCK), -(-t // TRI_TILE),
                          kernels.sm_count(o.device.index or 0)),
            float(eps), int(bool(cull)), int(bool(any_hit)),
            keys.data_ptr()))
    if any_hit:
        return decode_any(keys)
    idx, won = decode_closest(keys)
    return idx, won & (key_t(keys) <= tmax)


def bind(accel, geom):
    """The brute-force select, bound to pack_triangles of `geom`'s
    triangles when given (the accelerator is not read)."""
    if geom is None:
        return mt_select_brute
    return functools.partial(mt_select_brute, tri_soa=pack_triangles(
        geom.v0, geom.e1, geom.e2))
