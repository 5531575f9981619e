"""kd-tree traversal with per-ray stacks: the plain torch version.

Counterpart of `simd_raytracer_tpu.accel.traverse.kd_select` (jnp code,
no Pallas kernel), step for step.  Every ray walks the tree with its own
stack of node ids (reference kd_tree_simd.hpp:188-228): each step pops one
node per ray, slab-tests its box, prunes it when the running winner is
closer than the box (`t_near <= best_t` visits, inclusive), pushes the
children of an inner node near child last (so it pops first), and tests a
leaf's triangles in 64-wide slices, merging on (t, triangle id).  Rays are
independent, so running them in lockstep changes no winner; each step
works only on the rays that sit at a leaf and only on the slices their
leaves fill, which changes cost, not values.

On CUDA tensors the render path runs the kernel `csrc/kd_select.cu`
(ops/intersect_kd.py), which walks the same per-ray sequence in one thread
per ray and gives the same winners.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.intersect import BIG, IMAX, mt_pairs
from .build import KdTree

MAX_STACK_SLOTS = 64   # a deeper tree raises, never clamps
LEAF_SLICE = 64        # triangles tested per ray per slice of a leaf


def _slab(o, inv_d, bmin, bmax):
    """Ray-AABB slab test (aabb3.hpp:74-90) -> (t_near clamped at 0, hit).
    A NaN from 0 * inf (an origin on the slab plane of an axis-parallel
    ray) counts as spanning the axis."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    lo = torch.where(torch.isnan(lo), -BIG, lo)
    hi = torch.where(torch.isnan(hi), BIG, hi)
    t_near = lo.amax(dim=-1).clamp_min(0.0)
    t_far = hi.amin(dim=-1)
    return t_near, t_far >= t_near


def check_depth(tree: KdTree) -> int:
    """Stack slots a walk of `tree` needs (depth + 2: the live path plus
    the two-slot push); ValueError above MAX_STACK_SLOTS."""
    slots = int(tree.depth) + 2
    if slots > MAX_STACK_SLOTS:
        raise ValueError(
            f"kd-tree depth {tree.depth} needs {slots} stack slots "
            f"(> cap {MAX_STACK_SLOTS}); build with a smaller max_depth")
    return slots


def _live_lanes(tree: KdTree, tri_mask: Optional[torch.Tensor]):
    """(L,) count of the lanes of each leaf a ray tests: ids >= 0 that the
    mask keeps."""
    live = tree.leaf_tris >= 0
    if tri_mask is not None:
        live = live & tri_mask[tree.leaf_tris.clamp_min(0).long()]
    return live.sum(dim=1)


def _kd_walk(o, d, v0, e1, e2, eps, cull, tri_mask, tree: KdTree):
    """The walk -> (best_t, best_i, pairs): each ray's closest accepted
    (t, id) (BIG and IMAX where none) and the live leaf lanes tested."""
    dev = o.device
    r = o.shape[0]
    rows = torch.arange(r, device=dev)
    inv_d = 1.0 / d
    slots = check_depth(tree)

    stack = torch.zeros((r, slots), dtype=torch.long, device=dev)
    sp = torch.ones(r, dtype=torch.long, device=dev)
    best_t = torch.full((r,), BIG, dtype=o.dtype, device=dev)
    best_i = torch.full((r,), IMAX, dtype=torch.long, device=dev)
    leaf_tris = tree.leaf_tris.long()
    leaf_len = (leaf_tris >= 0).sum(dim=1)
    live_lanes = _live_lanes(tree, tri_mask)
    node_min, node_max = tree.node_min.to(o.dtype), tree.node_max.to(o.dtype)
    child0, child1 = tree.child0.long(), tree.child1.long()
    leaf_id = tree.leaf_id.long()
    pairs = 0

    while bool((sp > 0).any()):
        active = sp > 0
        top = (sp - 1).clamp_min(0)
        node = stack[rows, top]
        sp = torch.where(active, sp - 1, sp)

        t_near, box_hit = _slab(o, inv_d, node_min[node], node_max[node])
        # Prune when the running winner is closer than the box
        # (kd_tree_simd.hpp:203-205).
        visit = active & box_hit & (t_near <= best_t)
        c0 = child0[node]
        is_leaf = c0 < 0

        at = (visit & is_leaf).nonzero()[:, 0]
        if at.numel():
            lid = leaf_id[node[at]]
            pairs += int(live_lanes[lid].sum())
            bt, bi = best_t[at], best_i[at]
            oa, da = o[at], d[at]
            oc = (oa[:, 0:1], oa[:, 1:2], oa[:, 2:3])
            dc = (da[:, 0:1], da[:, 1:2], da[:, 2:3])
            n_slices = -(-int(leaf_len[lid].max()) // LEAF_SLICE)
            for s in range(n_slices):
                tris = leaf_tris[lid, s * LEAF_SLICE:(s + 1) * LEAF_SLICE]
                tidx = tris.clamp_min(0)
                lv0, le1, le2 = v0[tidx], e1[tidx], e2[tidx]
                t, ok = mt_pairs(oc, dc, lv0.unbind(-1), le1.unbind(-1),
                                 le2.unbind(-1), eps, cull)
                ok = ok & (tris >= 0)
                if tri_mask is not None:
                    ok = ok & tri_mask[tidx]
                t_m = torch.where(ok, t, BIG)
                leaf_t = t_m.amin(dim=1)
                leaf_i = torch.where(t_m == leaf_t[:, None], tidx,
                                     IMAX).amin(dim=1)
                upd = (leaf_t < bt) | ((leaf_t == bt) & (leaf_i < bi))
                bt = torch.where(upd, leaf_t, bt)
                bi = torch.where(upd, leaf_i, bi)
            best_t[at], best_i[at] = bt, bi

        # Push the children of visited inner nodes, the child on the ray's
        # side of the split plane last so that it pops first.  The split
        # axis is where child0's box max differs from the node's.
        push = visit & ~is_leaf
        c0s = c0.clamp_min(0)
        axis = (node_max[c0s] != node_max[node]).int().argmax(dim=1)
        near_first = d.gather(1, axis[:, None])[:, 0] >= 0.0
        c1 = child1[node]
        first = torch.where(near_first, c0, c1)
        second = torch.where(near_first, c1, c0)
        stack[rows, top] = torch.where(push, second, stack[rows, top])
        stack[rows, top + 1] = torch.where(push, first, stack[rows, top + 1])
        sp = torch.where(push, sp + 2, sp)

    return best_t, best_i, pairs


def kd_select(o, d, v0, e1, e2, eps: float, cull: bool,
              tri_mask: Optional[torch.Tensor], tree: KdTree):
    """kd-tree closest hit, a drop-in for ops.intersect.mt_select without
    a window -> (idx (R,) int32, hit (R,) bool): the brute-force winner
    (same pair tests, lowest id on exact t ties), idx 0 on a miss."""
    best_t, best_i, _ = _kd_walk(o, d, v0, e1, e2, eps, cull, tri_mask, tree)
    hit = best_t < BIG
    return torch.where(hit, best_i, 0).to(torch.int32), hit


def kd_work_pairs(o, d, v0, e1, e2, eps: float, cull: bool,
                  tri_mask: Optional[torch.Tensor], tree: KdTree) -> int:
    """(ray, triangle) pairs the walk tests: over every ray and every leaf
    it visits, that leaf's live lanes (id >= 0, kept by the mask).  The
    work behind the kd kernel's bound."""
    return _kd_walk(o, d, v0, e1, e2, eps, cull, tri_mask, tree)[2]
