"""The "mxu" select: Moller-Trumbore numerators as one float32 matrix
product a block, then a plain torch epilogue.

Counterpart of `simd_raytracer_tpu.ops.intersect_mxu.mt_select_mxu`, which
runs the product on the TPU's matrix unit at `Precision.HIGHEST`.  Every
numerator is a scalar triple product, bilinear in the ray features

    f = [o, d, c, 1]          where  c = o x d        (10 features)

and per-triangle weight vectors (n = e1 x e2):

    det   = f . [ 0,  -n,      0,   0      ]
    t_num = f . [ n,   0,      0,  -(v0.n) ]
    u_num = f . [ 0,  v0 x e2, e2,  0      ]
    v_num = f . [ 0,  e1 x v0, -e1, 0      ]

so one (B, 10) @ (10, 4T) product gives all four for every pair; the
accept tests are division-free sign comparisons, as in the fast select
(`ops/intersect_fast.py`), and one division per accepted pair gives the
sort key.  Unlike "fast" nothing is re-centred, as in the JAX package.

The product is a plain large matrix product, so it goes to torch.matmul
(no kernel of this package), always in full float32: TF32 would cut the
numerators to 10 mantissa bits and flip winners by the thousand, so
`full_f32_matmul` switches it off around the product whatever the global
setting.  The JAX package blocks over rays only; at T = 106,510 one
8,192-ray product alone would be 14 GB, so blocks here cover rays and
triangles, at most PRODUCT_ELEMS elements a product, merged with a strict
`<` so that the lowest index still wins exact t ties.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..models.scene import cross3, dot3
from .intersect import BIG, counted_select

RAY_BLOCK = 8192          # rays per product, as the JAX package's block
PRODUCT_ELEMS = 1 << 26   # elements of one (rays, 4 x triangles) product


def tri_block(rays: int) -> int:
    """Triangles per product for a block of `rays` rays."""
    return max(1, PRODUCT_ELEMS // (4 * max(rays, 1)))


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 (no TF32) inside the
    block, and restore the caller's setting after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def tri_weights(v0, e1, e2) -> torch.Tensor:
    """(4, T, 10): the det, t, u and v numerators' weights per triangle."""
    t = v0.shape[0]
    z3 = v0.new_zeros((t, 3))
    z1 = v0.new_zeros((t, 1))
    n = cross3(e1, e2)
    return torch.stack([
        torch.cat([z3, -n, z3, z1], dim=1),
        torch.cat([n, z3, z3, -dot3(v0, n)[:, None]], dim=1),
        torch.cat([z3, cross3(v0, e2), e2, z1], dim=1),
        torch.cat([z3, cross3(e1, v0), -e1, z1], dim=1)])


def ray_features(o, d) -> torch.Tensor:
    """(R, 10): o, d, o x d, 1."""
    return torch.cat([o, d, cross3(o, d), o.new_ones((o.shape[0], 1))],
                     dim=1)


@counted_select
def mt_select_mxu(o, d, v0, e1, e2, eps: float, cull: bool,
                  tri_mask: Optional[torch.Tensor] = None,
                  t_max: Optional[torch.Tensor] = None,
                  any_hit: bool = False):
    """Same contract as `ops.intersect.mt_select` -> (idx (R,) int32,
    hit (R,) bool), in the dtype of the rays on any device.  The optional
    window is inclusive and division-free, t_num * s <= t_max * |det|;
    with any_hit the reduction is one `any` and idx is zeros."""
    dtype = o.dtype
    r, t = o.shape[0], v0.shape[0]
    w = tri_weights(*(x.detach().to(dtype) for x in (v0, e1, e2)))
    feats = ray_features(o, d)
    tmax = None if t_max is None else t_max.to(dtype)
    rb = min(RAY_BLOCK, max(r, 1))
    tb = tri_block(rb)
    idx, hit = [], []
    with full_f32_matmul():
        for rs in range(0, r, rb):
            f = feats[rs:rs + rb]
            n_r = f.shape[0]
            tm = None if tmax is None else tmax[rs:rs + rb, None]
            best_t = torch.full((n_r,), BIG, dtype=dtype, device=o.device)
            best_i = torch.zeros(n_r, dtype=torch.int64, device=o.device)
            any_ok = torch.zeros(n_r, dtype=torch.bool, device=o.device)
            for ts in range(0, t, tb):
                wb = w[:, ts:ts + tb]
                k = wb.shape[1]
                nums = torch.matmul(f, wb.reshape(4 * k, 10).T)  # (B, 4k)
                det, t_num, u_num, v_num = nums.split(k, dim=1)

                s = torch.where(det >= 0.0, 1.0, -1.0).to(dtype)
                adet = det * s
                ok = det > eps if cull else adet > eps
                us = u_num * s
                vs = v_num * s
                ok = ok & (us >= 0.0) & (us <= adet)
                ok = ok & (vs >= 0.0) & (us + vs <= adet)
                ok = ok & (t_num * s > eps * adet)
                if tri_mask is not None:
                    ok = ok & tri_mask[None, ts:ts + tb]
                if tm is not None:
                    ok = ok & (t_num * s <= tm * adet)
                if any_hit:
                    any_ok = any_ok | ok.any(dim=1)
                    continue
                t_m = torch.where(ok, t_num / torch.where(ok, det, 1.0), BIG)
                blk_i = t_m.argmin(dim=1)              # first minimum
                blk_t = t_m.gather(1, blk_i[:, None])[:, 0]
                upd = blk_t < best_t                   # earlier blocks win
                best_t = torch.where(upd, blk_t, best_t)
                best_i = torch.where(upd, blk_i + ts, best_i)
            if any_hit:
                idx.append(torch.zeros(n_r, dtype=torch.int32,
                                       device=o.device))
                hit.append(any_ok)
            else:
                idx.append(best_i.to(torch.int32))
                hit.append(best_t < BIG)
    if not idx:
        return (torch.zeros(0, dtype=torch.int32, device=o.device),
                torch.zeros(0, dtype=torch.bool, device=o.device))
    return torch.cat(idx), torch.cat(hit)


def bind(accel, geom):
    """The mxu select, which reads no table (nor the accelerator)."""
    return mt_select_mxu
