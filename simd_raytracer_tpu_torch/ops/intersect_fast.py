"""The division-free bilinear select ("fast"), in plain torch.

Counterpart of `simd_raytracer_tpu.ops.intersect_mxu.mt_select_fast`, which
is jnp code compiled by XLA, not a Pallas kernel: so it runs as torch ops
on every device.  Every Moller-Trumbore numerator is a scalar triple
product, bilinear in per-ray features (o, d, c = o x d) and per-triangle
constants (n = e1 x e2, v0 . n, v0 x e2, e1 x v0); the accept tests compare
numerators against |det| with no division, and one division per accepted
pair gives the sort key.  The last ulps differ from the classic
formulation, so exact-tie winners on shared edges can flip; the
differentiable refine recomputes the winner's t, u, v either way.

Rays and triangles are re-centred on the mean of v0 first: the
factorisation is translation invariant, and centring keeps the o x d
cancellation at scene scale wherever the scene sits.  Blocked over
triangles like `ops/intersect.py::_pair_blocks`; computed in the dtype of
the rays.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.scene import cross3
from .intersect import BIG, _block


def mt_select_fast(o, d, v0, e1, e2, eps: float, cull: bool,
                   tri_mask: Optional[torch.Tensor] = None,
                   t_max: Optional[torch.Tensor] = None,
                   any_hit: bool = False):
    """Same contract as `ops.intersect.mt_select` -> (idx (R,) int32,
    hit (R,) bool).  The optional window is inclusive and division-free,
    t_num * s <= t_max * |det|; with any_hit the reduction is one `any`
    and idx is zeros."""
    dtype = o.dtype
    v0, e1, e2 = (x.to(dtype) for x in (v0, e1, e2))
    center = v0.mean(dim=0)
    o = o - center[None, :]
    v0 = v0 - center[None, :]
    c = cross3(o, d)                                   # (R, 3) once per ray
    tm = None if t_max is None else t_max.to(dtype)[:, None]

    def col(a, k):                                     # (R,) -> (R, 1)
        return a[:, k:k + 1]

    r = o.shape[0]
    hit = torch.zeros(r, dtype=torch.bool, device=o.device)
    best_t = torch.full((r,), BIG, dtype=dtype, device=o.device)
    best_i = torch.zeros(r, dtype=torch.int64, device=o.device)
    step = _block(r)
    for s in range(0, v0.shape[0], step):
        bv0, be1, be2 = v0[s:s + step], e1[s:s + step], e2[s:s + step]
        n = cross3(be1, be2)                           # (B, 3)
        v0n = n[:, 0] * bv0[:, 0] + n[:, 1] * bv0[:, 1] + n[:, 2] * bv0[:, 2]
        wu = cross3(bv0, be2)                          # d-coefficient of u_num
        wv = cross3(be1, bv0)                          # d-coefficient of v_num

        def row(a, k):                                 # (B, 3) -> (1, B)
            return a[None, :, k]

        det = -(col(d, 0) * row(n, 0) + col(d, 1) * row(n, 1)
                + col(d, 2) * row(n, 2))
        t_num = (col(o, 0) * row(n, 0) + col(o, 1) * row(n, 1)
                 + col(o, 2) * row(n, 2)) - v0n[None, :]
        u_num = (col(c, 0) * row(be2, 0) + col(c, 1) * row(be2, 1)
                 + col(c, 2) * row(be2, 2)
                 + col(d, 0) * row(wu, 0) + col(d, 1) * row(wu, 1)
                 + col(d, 2) * row(wu, 2))
        v_num = (col(d, 0) * row(wv, 0) + col(d, 1) * row(wv, 1)
                 + col(d, 2) * row(wv, 2)
                 - (col(c, 0) * row(be1, 0) + col(c, 1) * row(be1, 1)
                    + col(c, 2) * row(be1, 2)))

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
