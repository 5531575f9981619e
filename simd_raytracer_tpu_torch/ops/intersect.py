"""Ray-triangle intersection: Moller-Trumbore over (rays x triangles).

Counterpart of `simd_raytracer_tpu.ops.intersect`.  Differentiability is
split in two, as there:

  * the select picks each ray's winning triangle (a discrete choice) and
    runs under `torch.no_grad()`;
  * `mt_refine` recomputes t, u, v for the winner in plain differentiable
    torch, so gradients reach the vertices through the winner's formulas.

Every select shares one contract,
`(o, d, v0, e1, e2, eps, cull, tri_mask, t_max, any_hit) -> (idx, hit)`:
`t_max` is an inclusive per-ray window and `any_hit` asks only whether any
accepted pair lies in it (then `idx` is zeros).  Ties on t go to the lowest
triangle index.  Every arithmetic step is its own torch op, so nothing is
fused into a multiply-add and the CUDA kernels, built without contraction,
reproduce the winners bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..models.scene import Geometry, Scene, TensorStruct, cross3, dot3

BIG = 3.4e38          # stand-in for numeric_limits<float>::max
IMAX = 2**31 - 1


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def mt_pairs(o_comp, d_comp, v0_comp, e1_comp, e2_comp, eps, cull):
    """Componentwise Moller-Trumbore over broadcastable operand grids.

    Each argument is an (x, y, z) tuple of tensors that broadcast together
    (rays as (R, 1) columns, triangles as (1, T) rows).  Returns (t, ok).
    Backface culling keeps det > eps, otherwise |det| > eps; then
    u in [0, 1], v >= 0, u + v <= 1, t > eps (kd_tree_simd.hpp:26-60)."""
    ox, oy, oz = o_comp
    dx, dy, dz = d_comp
    v0x, v0y, v0z = v0_comp
    e1x, e1y, e1z = e1_comp
    e2x, e2y, e2z = e2_comp

    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)
    det = e1x * px + e1y * py + e1z * pz
    ok = det > eps if cull else det.abs() > eps
    inv_det = torch.where(ok, det, 1.0).reciprocal()

    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)

    qx, qy, qz = _cross(tvx, tvy, tvz, e1x, e1y, e1z)
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)

    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ok & (t > eps)
    return t, ok


def _block(r: int) -> int:
    """Triangles per block: bounds each (R, block) temporary to ~4M."""
    return max(16, min(4096, (1 << 22) // max(r, 1)))


def _pair_blocks(o, d, v0, e1, e2, eps, cull, tri_mask, t_max):
    """Yield (start, t, ok) over triangle blocks, mask and window applied."""
    oc = (o[:, 0:1], o[:, 1:2], o[:, 2:3])
    dc = (d[:, 0:1], d[:, 1:2], d[:, 2:3])
    step = _block(o.shape[0])
    for s in range(0, v0.shape[0], step):
        rows = [(x[s:s + step, 0][None], x[s:s + step, 1][None],
                 x[s:s + step, 2][None]) for x in (v0, e1, e2)]
        t, ok = mt_pairs(oc, dc, *rows, eps, cull)
        if tri_mask is not None:
            ok = ok & tri_mask[None, s:s + step]
        if t_max is not None:
            ok = ok & (t <= t_max[:, None])
        yield s, t, ok


def closest_pairs(o, d, v0, e1, e2, eps, cull, tri_mask=None, t_max=None):
    """Lowest accepted (t, index) per ray -> (best_t, best_idx int64);
    BIG and 0 where nothing is accepted."""
    best_t = torch.full((o.shape[0],), BIG, dtype=o.dtype, device=o.device)
    best_i = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for s, t, ok in _pair_blocks(o, d, v0, e1, e2, eps, cull, tri_mask,
                                 t_max):
        t_m = torch.where(ok, t, BIG)
        blk_i = t_m.argmin(dim=1)          # first minimum: lowest index
        blk_t = t_m.gather(1, blk_i[:, None])[:, 0]
        upd = blk_t < best_t               # strict: earlier blocks win ties
        best_t = torch.where(upd, blk_t, best_t)
        best_i = torch.where(upd, blk_i + s, best_i)
    return best_t, best_i


def any_pair(o, d, v0, e1, e2, eps, cull, tri_mask=None, t_max=None):
    """(R,) bool: any accepted pair inside the window."""
    hit = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for _, _, ok in _pair_blocks(o, d, v0, e1, e2, eps, cull, tri_mask,
                                 t_max):
        hit = hit | ok.any(dim=1)
    return hit


def mt_select(o, d, v0, e1, e2, eps: float, cull: bool,
              tri_mask: Optional[torch.Tensor] = None,
              t_max: Optional[torch.Tensor] = None, any_hit: bool = False):
    """All-pairs Moller-Trumbore, blocked over triangles, in plain torch.
    Returns (idx (R,) int32, hit (R,) bool), as the JAX `mt_select`: the
    window applies before the argmin, so a ray with no hit inside it gets
    idx 0."""
    if any_hit:
        hit = any_pair(o, d, v0, e1, e2, eps, cull, tri_mask, t_max)
        return torch.zeros_like(hit, dtype=torch.int32), hit
    best_t, best_i = closest_pairs(o, d, v0, e1, e2, eps, cull, tri_mask,
                                   t_max)
    return best_i.to(torch.int32), best_t < BIG


def mt_refine(o, d, v0, e1, e2, eps: float = 1e-6):
    """Differentiable t, u, v for one (per-ray) triangle, without the
    accept tests (triangle.hpp:32-67).  The determinant is clamped at eps,
    as in the select, so a missed ray's record stays finite."""
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    inv_det = torch.where(det.abs() > eps, det,
                          torch.full_like(det, eps)).reciprocal()
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    return t, u, v


@dataclasses.dataclass
class HitRecord(TensorStruct):
    """Wavefront hit record (reference render/hit.hpp:9-21) plus the
    gathered material attributes shading reads."""

    mask: torch.Tensor       # (N,) bool, ray hit something
    idx: torch.Tensor        # (N,) int32 winning triangle
    t: torch.Tensor          # (N,)
    u: torch.Tensor          # (N,)
    v: torch.Tensor          # (N,)
    w: torch.Tensor          # (N,) barycentric 1 - u - v
    position: torch.Tensor   # (N, 3)
    hit_n: torch.Tensor      # (N, 3) unit smooth normal
    face_n: torch.Tensor     # (N, 3)
    uvs: torch.Tensor        # (N, 3, 2) corner UVs
    mat_tag: torch.Tensor    # (N,) int32
    albedo: torch.Tensor     # (N, 3)
    ior: torch.Tensor        # (N,)
    smooth: torch.Tensor     # (N,) bool
    tex: torch.Tensor        # (N,) int32
    mesh_idx: torch.Tensor   # (N,) int32


def make_select_fn(intersector: str, accel=None,
                   geom: Optional[Geometry] = None):
    """Resolve a RenderConfig.intersector name to a select function.

    "jnp" and "pallas" both resolve to the brute-force select, which runs
    the CUDA kernel on a GPU and its plain version on the CPU, bound to
    `geom`'s packed triangles when given; "sweep" binds the SweepData
    given as `accel`; "kdtree" the KdTree given as `accel` (the kd kernel
    on a GPU); "fast" is the division-free bilinear select, plain torch on
    every device (its JAX counterpart is jnp code, no kernel)."""
    if intersector in ("jnp", "pallas"):
        from .intersect_brute import mt_select_brute
        if geom is None:
            return mt_select_brute
        return functools.partial(mt_select_brute, tri_soa=geom.tri_soa)
    if intersector == "sweep":
        if accel is None:
            raise ValueError("intersector='sweep' needs an accel: build one "
                             "with accel.sweep.build_sweep_for_scene")
        from .intersect_sweep import make_sweep_select
        return make_sweep_select(accel)
    if intersector == "fast":
        from .intersect_fast import mt_select_fast
        return mt_select_fast
    if intersector == "kdtree":
        if accel is None:
            raise ValueError("intersector='kdtree' needs an accel: build one "
                             "with accel.build.build_kdtree_for_scene")
        return functools.partial(_kd_window_select, tree=accel)
    if intersector == "mxu":
        raise NotImplementedError(
            "intersector='mxu' is not ported (ROADMAP A14)")
    raise ValueError(intersector)


def _kd_window_select(o, d, v0, e1, e2, eps, cull, tri_mask=None,
                      t_max=None, any_hit=False, *, tree):
    """The kd select under the common contract, as the JAX package
    emulates it: the closest hit first; with a window, the winner's
    refined t decides `hit &= t <= t_max` (the window is not applied
    inside the walk); with any_hit, idx is zeros."""
    from .intersect_kd import kd_select_cuda
    idx, hit = kd_select_cuda(o, d, v0, e1, e2, eps, cull, tri_mask, tree)
    if t_max is not None:
        gidx = idx.long()
        t, _, _ = mt_refine(o, d, v0[gidx], e1[gidx], e2[gidx], eps)
        hit = hit & (t <= t_max)
    if any_hit:
        idx = torch.zeros_like(idx)
    return idx, hit


def trace(o: torch.Tensor, d: torch.Tensor, scene: Scene, geom: Geometry,
          eps: float, cull: bool, tri_mask: Optional[torch.Tensor] = None,
          intersector: str = "jnp", accel=None) -> HitRecord:
    """Closest-hit query for a ray wavefront: N rays in, N records out
    (mask False on a miss)."""
    mask = tri_mask if tri_mask is not None else geom.tri_valid
    select = make_select_fn(intersector, accel, geom)
    with torch.no_grad():
        idx, hit = select(o.detach(), d.detach(), geom.v0.detach(),
                          geom.e1.detach(), geom.e2.detach(), eps, cull, mask)
    gidx = idx.long()
    t, u, v = mt_refine(o, d, geom.v0[gidx], geom.e1[gidx], geom.e2[gidx],
                        eps)
    # A missed ray carries idx 0, whose refine can reach the determinant
    # clamp; pin misses to a harmless finite record (ops/intersect.py:250).
    t = torch.where(hit, t, 1.0)
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    w = 1.0 - u - v
    position = o + t[:, None] * d

    vn = geom.vn[gidx]
    n_interp = (u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2]
                + w[:, None] * vn[:, 0])
    sq = dot3(n_interp, n_interp).clamp_min(1e-18)
    hit_n = n_interp * torch.sqrt(sq).reciprocal()[:, None]

    mat = geom.tri_mat[gidx].long()
    return HitRecord(
        mask=hit, idx=idx, t=t, u=u, v=v, w=w, position=position,
        hit_n=hit_n, face_n=geom.face_n[gidx], uvs=geom.uv[gidx],
        mat_tag=scene.mat_tag[mat], albedo=scene.mat_albedo[mat],
        ior=scene.mat_ior[mat], smooth=scene.mat_smooth[mat],
        tex=scene.mat_tex[mat], mesh_idx=geom.tri_mesh[gidx])
