"""Block-sparse sweep select: the CUDA kernel `csrc/sweep_select.cu` and
its plain version.

Counterpart of `simd_raytracer_tpu.ops.intersect_sweep`, whose two Pallas
TPU kernels (`_kernel_resident` for soups up to 6 MB, `_kernel` streaming
larger ones) become one CUDA kernel: the soup stays in device memory and
each scheduled slice is staged in shared memory, so there is no size
switch.

Culling happens outside the kernel, in torch: `_tile_reach` bounds each
512-ray tile's origins and directions by boxes and proves by interval
arithmetic which slices no ray of the tile can reach; `_tile_schedule`
sorts the reachable slices of each tile front to back by their entry
bound.  The kernel walks that schedule and stops once the next slice's
entry bound exceeds the largest best t of its rays.  Closest hits merge on
(t, global id), so winners equal brute force; any-hit uses the
division-free numerator tests.

The kernel runs one block per GROUP rays (a quarter of a tile) and, when
a call's groups would not fill the card, `kernels.split` blocks per group,
each walking every K-th step of the schedule; blocks merge winners through
the packed keys of `ops/select_keys.py`.  Winners do not depend on the
split.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..accel.sweep import R_TILE, SLICE_SIZE, refit_sweep
from ..utils import profiling
from .intersect import BIG, IMAX, counted_select
from .select_keys import (check_eps, check_table, decode_any, decode_closest,
                          launch, seed_keys)

# Rays per block of the kernel (kGroup of csrc/sweep_select.cu).
GROUP = 128


def _tile_reach(o, d, tmax, aabb, r_tile: int):
    """Conservative (tiles, slices) reach matrix -> (reach int32, t_near).

    A slice is reachable from a tile unless interval arithmetic over the
    tile's origin box times its direction box proves that no ray enters
    the slice's AABB within [0, max t_max of the tile].  t_near is a lower
    bound on any ray's entry distance (0 where unconstrained): the sort
    key of the schedule and the proof behind its early exit."""
    p = o.shape[0] // r_tile
    o_t = o.reshape(p, r_tile, 3)
    d_t = d.reshape(p, r_tile, 3)
    o_lo, o_hi = o_t.amin(dim=1), o_t.amax(dim=1)          # (P, 3)
    d_lo, d_hi = d_t.amin(dim=1), d_t.amax(dim=1)
    tcap = tmax.reshape(p, r_tile).amax(dim=1)             # (P,)
    bmin, bmax = aabb[:, 0:3], aabb[:, 3:6]                # (S, 3)
    box_valid = (bmax >= bmin).all(dim=1)

    # 1/d over a sign-uniform interval is [1/d_hi, 1/d_lo]; the clamp
    # keeps 0 * inf from making a NaN that would cull a reachable slice.
    uniform = (d_lo > 0.0) | (d_hi < 0.0)
    inv_lo = torch.where(uniform, d_hi, 1.0).reciprocal().clamp(-BIG, BIG)
    inv_hi = torch.where(uniform, d_lo, 1.0).reciprocal().clamp(-BIG, BIG)

    na_lo = bmin[None] - o_hi[:, None]                     # (P, S, 3)
    na_hi = bmin[None] - o_lo[:, None]
    nb_lo = bmax[None] - o_hi[:, None]
    nb_hi = bmax[None] - o_lo[:, None]

    def prod_bounds(n_lo, n_hi, i_lo, i_hi):
        p1, p2 = n_lo * i_lo, n_lo * i_hi
        p3, p4 = n_hi * i_lo, n_hi * i_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    il, ih = inv_lo[:, None, :], inv_hi[:, None, :]
    ta_lo, ta_hi = prod_bounds(na_lo, na_hi, il, ih)
    tb_lo, tb_hi = prod_bounds(nb_lo, nb_hi, il, ih)
    near_lo = torch.minimum(ta_lo, tb_lo)
    far_hi = torch.maximum(ta_hi, tb_hi)
    unb = ~uniform[:, None, :]
    near_lo = torch.where(unb, -BIG, near_lo)
    far_hi = torch.where(unb, BIG, far_hi)
    t_near = near_lo.amax(dim=2).clamp_min(0.0)            # (P, S)
    t_far = far_hi.amin(dim=2)
    reach = (t_far >= t_near) & (t_near <= tcap[:, None]) & box_valid[None]
    return reach.to(torch.int32), t_near


def _tile_schedule(reach, t_near):
    """Per-tile front-to-back slice schedule:
      count (P, 1) int32  reachable slices per tile
      order (P, S) int32  slice ids, reachable first, ascending t_near
      tnear (P, S) float  t_near in that order (inf past count)
    The sort is stable: t_near has many exact ties (zeros)."""
    key = torch.where(reach > 0, t_near, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)
    tnear = key.gather(1, order)
    count = (reach > 0).sum(dim=1, dtype=torch.int32)[:, None]
    return count, order.to(torch.int32), tnear


def _mt_merge(o, d, tri, gid, mask, best_t, best_i, eps, cull, any_hit):
    """One slice of SL triangles against each tile's rays, merged into the
    running (best_t, best_i).  o, d (A, RT, 3); tri (A, 9, SL);
    gid, mask (A, SL); best_t, best_i (A, RT).  Math as mt_pairs."""
    ox, oy, oz = (o[..., k, None] for k in range(3))      # (A, RT, 1)
    dx, dy, dz = (d[..., k, None] for k in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri[:, k, None, :] for k in range(9))             # (A, 1, SL)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det > eps if cull else det.abs() > eps

    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u_num = tvx * px + tvy * py + tvz * pz
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v_num = dx * qx + dy * qy + dz * qz
    t_num = e2x * qx + e2y * qy + e2z * qz
    live = (mask > 0)[:, None, :]

    if any_hit:
        # Division-free accepts on the numerators; a decided ray parks at
        # best_t = -1, which fails every later window test.
        s = torch.where(det >= 0.0, 1.0, -1.0)
        adet = det * s
        us = u_num * s
        vs = v_num * s
        ts = t_num * s
        ok = ok & (us >= 0.0) & (us <= adet)
        ok = ok & (vs >= 0.0) & (us + vs <= adet)
        ok = ok & (ts > eps * adet)
        ok = ok & (ts <= best_t[..., None] * adet) & live
        dec = ok.any(dim=2) & (best_i == IMAX)
        return (torch.where(dec, -1.0, best_t),
                torch.where(dec, 0, best_i))

    inv_det = torch.where(ok, det, 1.0).reciprocal()
    u = u_num * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    v = v_num * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = t_num * inv_det
    ok = ok & (t > eps) & live

    t_m = torch.where(ok, t, BIG)
    blk_t = t_m.amin(dim=2)
    blk_i = torch.where(t_m == blk_t[..., None], gid[:, None, :],
                        IMAX).amin(dim=2)
    return lex_merge(blk_t, blk_i, best_t, best_i)


def lex_merge(blk_t, blk_i, best_t, best_i):
    """Lexicographic merge on (t, global id), gated on a real candidate
    (t < BIG); best_t seeded with t_max makes the window inclusive.  The
    kernels' packed-key atomicMin computes the same (ops/select_keys.py)."""
    upd = (((blk_t < best_t) | ((blk_t == best_t) & (blk_i < best_i)))
           & (blk_t < BIG))
    return torch.where(upd, blk_t, best_t), torch.where(upd, blk_i, best_i)


def sweep_reference_walk(count, order, tnear, o, d, tmax, tri_soa, ids,
                         mask, eps, cull, any_hit):
    """The plain version's walk -> its final (best_t, best_i, decided),
    each (P, R_TILE): the winner's t and id, or the window and IMAX where
    nothing won; (-1, 0) where an any-hit query decided the ray, and then
    `decided` holds the step that decided it (-1 elsewhere)."""
    p, n_steps = order.shape
    o_t = o.reshape(p, R_TILE, 3)
    d_t = d.reshape(p, R_TILE, 3)
    best_t = tmax.reshape(p, R_TILE).clone()
    best_i = torch.full((p, R_TILE), IMAX, dtype=torch.int32, device=o.device)
    decided = torch.full((p, R_TILE), -1, dtype=torch.int32, device=o.device)
    cnt = count.reshape(p)
    for j in range(n_steps):
        gate = (j < cnt) & (tnear[:, j] <= best_t.amax(dim=1))
        active = gate.nonzero()[:, 0]
        if active.numel() == 0:
            break
        # Groups of 64 tiles bound each (tiles, rays, lanes) temporary.
        for act in active.split(64):
            sl = order[act, j].long()
            bt, bi = _mt_merge(o_t[act], d_t[act], tri_soa[sl], ids[sl],
                               mask[sl], best_t[act], best_i[act], eps,
                               cull, any_hit)
            if any_hit:
                decided[act] = torch.where(bi != best_i[act], j,
                                           decided[act])
            best_t[act] = bt
            best_i[act] = bi
    return best_t, best_i, decided


def sweep_select_reference(count, order, tnear, o, d, tmax, tri_soa, ids,
                           mask, eps, cull, any_hit):
    """Plain torch version of the sweep kernel, step for step.

    Inputs as sweep_select.  Step j tests slice order[p, j] for every tile
    p with j < count[p] whose rays' largest best t still reaches
    tnear[p, j]; once that fails it fails for good (tnear ascends, best t
    only falls), which is where the kernel breaks its loop."""
    _, best_i, _ = sweep_reference_walk(count, order, tnear, o, d, tmax,
                                        tri_soa, ids, mask, eps, cull,
                                        any_hit)
    won = best_i != IMAX
    return torch.where(won, best_i, 0).reshape(-1), won.reshape(-1)


def sweep_select(count, order, tnear, o, d, tmax, tri_soa, ids, mask, eps,
                 cull, any_hit):
    """The sweep select over a prepared schedule: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    count (P, 1) int32, order (P, S) int32, tnear (P, S) float32 from
    _tile_reach/_tile_schedule; o, d (P*R_TILE, 3) and tmax (P*R_TILE,)
    float32; tri_soa (S, 9, SLICE_SIZE) float32; ids, mask
    (S, SLICE_SIZE) int32.  Returns (idx (P*R_TILE,) int32, hit bool).
    eps must be >= 0 on every device (the key merge needs t >= 0)."""
    check_eps(eps)
    if not o.is_cuda:
        return sweep_select_reference(count, order, tnear, o, d, tmax,
                                      tri_soa, ids, mask, eps, cull, any_hit)
    p, s = order.shape
    rp = p * R_TILE
    for name, x, shape, dtype in (
            ("count", count, (p, 1), torch.int32),
            ("order", order, (p, s), torch.int32),
            ("tnear", tnear, (p, s), torch.float32),
            ("o", o, (rp, 3), torch.float32),
            ("d", d, (rp, 3), torch.float32),
            ("tmax", tmax, (rp,), torch.float32),
            ("tri_soa", tri_soa, (s, 9, SLICE_SIZE), torch.float32),
            ("ids", ids, (s, SLICE_SIZE), torch.int32),
            ("mask", mask, (s, SLICE_SIZE), torch.int32)):
        check_table(name, x, shape, dtype, o.device)
    for name, x in (("tri_soa", tri_soa), ("ids", ids), ("mask", mask)):
        if x.data_ptr() % 16:           # staged with 16-byte cp.async
            raise ValueError(f"{name}: needs a 16-byte aligned start")
    keys = seed_keys(tmax)
    launch("sweep", o, d, (), None, None, None,
           lambda o32, d32, _, __: (
               count.data_ptr(), order.data_ptr(), tnear.data_ptr(),
               o32.data_ptr(), d32.data_ptr(), tri_soa.data_ptr(),
               ids.data_ptr(), mask.data_ptr(), p, s,
               kernels.split(p * (R_TILE // GROUP), s,
                             kernels.sm_count(o.device.index or 0)),
               float(eps), int(bool(cull)), int(bool(any_hit)),
               keys.data_ptr()))
    return decode_any(keys) if any_hit else decode_closest(keys)


def sweep_work_pairs(count, order, tnear, mask, tmax, best_t,
                     decided) -> int:
    """(ray, triangle) pairs a front-to-back walk cannot skip, counted per
    ray: the live lanes (mask > 0) of every scheduled slice whose entry
    bound is at most the ray's own final best t; for a ray an any-hit
    query decided, those within its window up to the deciding step.  A
    ray with an empty window (t_max <= 0, as the padding rays have)
    needs none.  count, order, tnear, mask and tmax as sweep_select;
    best_t and decided as sweep_reference_walk returns them."""
    p, s = tnear.shape
    steps = torch.arange(s, device=tnear.device)
    live = (mask > 0).sum(dim=1)[order.long()]                 # (P, S)
    live = torch.where(steps[None] < count.reshape(p, 1), live, 0)
    prefix = torch.nn.functional.pad(live.cumsum(dim=1), (1, 0))
    tm = tmax.reshape(p, R_TILE)
    dec = decided.reshape(p, R_TILE).long()
    reach = torch.where(dec >= 0, tm, best_t.reshape(p, R_TILE))
    # tnear ascends along each row, so the slices a ray needs are a prefix.
    n = torch.searchsorted(tnear.contiguous(), reach.contiguous(),
                           right=True)
    n = torch.minimum(n, count.reshape(p, 1).long())
    n = torch.where(dec >= 0, torch.minimum(n, dec + 1), n)
    pairs = torch.where(tm > 0.0, prefix.gather(1, n), 0)
    return int(pairs.sum())


def prepare_sweep(sweep, o, d, tri_mask=None, t_max=None):
    """Pad the rays to whole tiles and build their schedule.

    Returns the argument tuple of sweep_select (without eps, cull,
    any_hit).  Padded rays get t_max = 0, so they never raise a tile's
    largest best t and block its early exit."""
    rt = sweep.r_tile
    r = o.shape[0]
    ids = sweep.tri_ids
    mask = ids >= 0
    if tri_mask is not None:
        mask = mask & tri_mask[ids.clamp_min(0).long()]
    rp = -(-r // rt) * rt
    o32 = o.float()
    d32 = d.float()
    tm = (torch.full((r,), BIG, dtype=torch.float32, device=o.device)
          if t_max is None else t_max.float().reshape(-1))
    if rp != r:
        o32 = torch.cat([o32, o32.new_zeros(rp - r, 3)])
        d32 = torch.cat([d32, d32.new_ones(rp - r, 3)])
        tm = torch.cat([tm, tm.new_zeros(rp - r)])
    reach, t_near = _tile_reach(o32, d32, tm, sweep.aabb, rt)
    count, order, tnear = _tile_schedule(reach, t_near)
    return (count, order, tnear.contiguous(), o32.contiguous(),
            d32.contiguous(), tm.contiguous(), sweep.tri_soa.contiguous(),
            ids.contiguous(), mask.to(torch.int32).contiguous())


def make_sweep_select(sweep):
    """Bind SweepData into the common select signature.  v0/e1/e2 are
    ignored: the slices hold their triangles.  While tracing, each call
    counts its tiles times slices and the reachable pairs of them (a read
    of the schedule on the host)."""

    @counted_select
    def select(o, d, v0, e1, e2, eps, cull, tri_mask=None, t_max=None,
               any_hit=False):
        r = o.shape[0]
        args = prepare_sweep(sweep, o, d, tri_mask, t_max)
        if profiling.tracing():
            profiling.count("sweep.tiles_x_slices", args[1].numel())
            profiling.count("sweep.reached", int(args[0].sum()))
        idx, hit = sweep_select(*args, eps, cull, any_hit)
        return idx[:r], hit[:r]

    return select


def bind(sweep, geom):
    """The sweep select on `sweep` (SweepData), whose slices hold their
    triangles.  `geom` is read only where `sweep.refit` asks for the
    slices refitted to its vertices: once a binding, span `refit`, with
    counters `sweep.refit.calls` and `sweep.refit.slices`."""
    if sweep is None:
        raise ValueError("intersector='sweep' needs an accel: build one "
                         "with accel.sweep.build_sweep_for_scene")
    if sweep.refit:
        if geom is None:
            raise ValueError("a refitted sweep needs the geometry of the "
                             "frame or step")
        with profiling.span("refit"):
            sweep = refit_sweep(sweep, geom.vertices, geom.tri_vidx)
        profiling.count("sweep.refit.calls")
        profiling.count("sweep.refit.slices", sweep.num_slices)
    return make_sweep_select(sweep)
