"""Brute-force select: the CUDA kernel `csrc/mt_select.cu` and its plain
version.

Counterpart of `simd_raytracer_tpu.ops.intersect_pallas` (the Pallas TPU
kernel `_kernel`, reached through `mt_select_pallas`).  Same contract and
the same answers: the closest accepted triangle per ray, lowest index on
exact t ties, `idx` 0 when nothing is accepted and otherwise the closest
winner even when it lies beyond `t_max` (then `hit` is False); with
`any_hit`, whether any accepted pair lies inside the inclusive window.
Everything is computed in float32, as the TPU kernel does.

The kernel splits the triangle range over `k1_split` blocks per 128 rays
when the ray blocks alone would not fill the card; blocks merge winners
through the packed keys of `ops/select_keys.py`.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..models.scene import pack_triangles
from ..utils import profiling
from .intersect import BIG, any_pair, closest_pairs, counted_select
from .select_keys import (check_eps, decode_any, decode_closest, key_t,
                          seed_keys)

# Rays per block and triangles per staged tile (kRays, kTile of
# csrc/mt_select.cu).
RAY_BLOCK = 128
TRI_TILE = 256


def k1_split(n_rays: int, n_tris: int, n_sms: int, ray_block: int = RAY_BLOCK,
             tile: int = TRI_TILE) -> int:
    """Blocks per `ray_block` rays, each taking a share of the triangle
    tiles of `tile` triangles, for a call of n_rays x n_tris on a card with
    n_sms SMs: enough for kernels.BLOCKS_PER_SM blocks on every SM, 1 when
    the ray blocks alone do that, never more than there are tiles.  The
    defaults are K1's widths (ops/intersect_fast.py::fast_split passes the
    fast kernel's)."""
    ray_blocks = max(1, -(-n_rays // ray_block))
    tiles = max(1, -(-n_tris // tile))
    want = -(-kernels.BLOCKS_PER_SM * n_sms // ray_blocks)
    return max(1, min(want, tiles, 65535))


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
    the caller holds it (Geometry.tri_soa); it is packed here otherwise.
    eps must be >= 0 on every device (the key merge needs t >= 0)."""
    check_eps(eps)
    if not o.is_cuda:
        return mt_select_reference(o, d, v0, e1, e2, eps, cull, tri_mask,
                                   t_max, any_hit)
    r, t = o.shape[0], v0.shape[0]
    for name, x, rows in (("o", o, r), ("d", d, r), ("v0", v0, t),
                          ("e1", e1, t), ("e2", e2, t)):
        if x.device != o.device or x.shape != (rows, 3):
            raise ValueError(f"{name}: expected ({rows}, 3) on {o.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    o32 = o.float().contiguous()
    d32 = d.float().contiguous()
    tri = pack_triangles(v0, e1, e2) if tri_soa is None else tri_soa
    if (tri.device != o.device or tri.shape != (9, t)
            or tri.dtype != torch.float32 or not tri.is_contiguous()):
        raise ValueError(f"tri_soa: expected contiguous float32 (9, {t}) on "
                         f"{o.device}, got {tri.dtype} {tuple(tri.shape)} "
                         f"on {tri.device}")
    mask = (torch.ones(t, dtype=torch.int32, device=o.device)
            if tri_mask is None else
            tri_mask.to(device=o.device, dtype=torch.int32).contiguous())
    tmax = (torch.full((r,), BIG, dtype=torch.float32, device=o.device)
            if t_max is None else
            t_max.to(device=o.device, dtype=torch.float32).contiguous())
    if mask.shape != (t,) or tmax.shape != (r,):
        raise ValueError(f"tri_mask {tuple(mask.shape)} / t_max "
                         f"{tuple(tmax.shape)} do not match T={t}, R={r}")
    keys = seed_keys(torch.full((r,), BIG, dtype=torch.float32,
                                device=o.device))
    if r:
        rc = kernels.library().srt_mt_select(
            o32.data_ptr(), d32.data_ptr(), tmax.data_ptr(), tri.data_ptr(),
            mask.data_ptr(), r, t,
            k1_split(r, t, kernels.sm_count(o.device.index or 0)),
            float(eps), int(bool(cull)), int(bool(any_hit)),
            keys.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
        kernels.check(rc, "mt_select")
        profiling.count("select.launches.brute")
    if any_hit:
        return decode_any(keys)
    idx, won = decode_closest(keys)
    return idx, won & (key_t(keys) <= tmax)
