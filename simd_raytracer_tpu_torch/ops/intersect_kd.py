"""kd-tree select: the CUDA kernel `csrc/kd_select.cu` and its wrapper.

The plain version is `accel/traverse.py::kd_select` (a port of the JAX
package's jnp `kd_select`, which has no Pallas kernel).  The kernel walks
each ray's stack as the plain walk does and tests the leaves it reaches
against a leaf-packed soup staged in shared memory (`pack_kd`), giving the
same (idx, hit): the closest accepted triangle, lowest id on exact t ties,
idx 0 on a miss.  It reads the node records from device memory, so it
walks a tree of any size the stack allows.  It takes no window:
`kd_window_select` emulates t_max and any-hit around it, as the JAX
package does, and `bind` binds it to the pack of a tree and a frame's
geometry, refitting the tree's boxes to that geometry first where the
tree is marked `refit`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..accel.build import KdTree, refit_kdtree
from ..accel.traverse import check_depth, kd_select
from ..models.scene import TensorStruct
from ..utils import profiling
from .intersect import counted_select, mt_refine
from .select_keys import check_table, launch

# Triangles per staged tile: kTile of csrc/kd_select.cu.
KD_TILE = 128
# (rays per block, lanes per ray) shapes the kernel is instantiated for,
# and the one the wrapper launches, chosen on the H100 with
# `chip_smoke.py --kd-shapes` (PERF.md); the library refuses any other
# shape (cudaErrorInvalidValue).
KD_SHAPES = ((4, 8), (8, 4), (8, 8), (16, 2), (16, 4), (16, 8), (32, 4),
             (32, 8), (64, 8), (128, 1))
KD_SHAPE = (16, 8)


@dataclasses.dataclass
class KdPack(TensorStruct):
    """The kd kernel's inputs built from a tree and its triangles: node
    records, and every leaf's triangles contiguous in leaf order, padded
    to whole tiles of KD_TILE."""

    box: torch.Tensor        # (N, 6) float32 node box min, max
    link: torch.Tensor       # (N, 4) int32 child0, child1, leaf_id, 0
    tri: torch.Tensor        # (tiles, 9, KD_TILE) float32 v0 e1 e2 rows
    ids: torch.Tensor        # (tiles, KD_TILE) int32 triangle id, -1 pad
    leaf_tile: torch.Tensor  # (L,) int32 first tile of each leaf
    leaf_len: torch.Tensor   # (L,) int32 references of each leaf
    num_tris: int = 0        # T of the soup the ids index


@profiling.spanned("pack")
def pack_kd(tree: KdTree, v0, e1, e2) -> KdPack:
    """Pack `tree` and the (T, 3) triangle rows v0, e1, e2 for the kernel,
    on the tree's device.  Leaf l's references (the ids >= 0 of its
    leaf_tris row) fill tiles leaf_tile[l] .. in row order; the rest of its
    last tile carries id -1 and zeros.  Counted in `build.pack` (the
    render path builds one per frame or step)."""
    dev = tree.leaf_tris.device
    box = torch.cat([tree.node_min, tree.node_max], dim=1).float()
    link = torch.stack([tree.child0, tree.child1, tree.leaf_id,
                        torch.zeros_like(tree.child0)], dim=1).to(torch.int32)
    rows = tree.leaf_tris.long()
    lens = (rows >= 0).sum(dim=1)
    tiles = (lens + KD_TILE - 1) // KD_TILE
    first = torch.cumsum(tiles, 0) - tiles
    n_tiles = int(tiles.sum())
    used = rows >= 0
    slot = first[:, None] * KD_TILE + torch.cumsum(used.long(), 1) - 1
    ids = torch.full((n_tiles * KD_TILE,), -1, dtype=torch.long, device=dev)
    ids[slot[used]] = rows[used]
    soup = torch.cat([v0, e1, e2], dim=1).detach().to(device=dev,
                                                      dtype=torch.float32)
    tri = torch.where((ids >= 0)[:, None], soup[ids.clamp_min(0)], 0.0)
    profiling.count("build.pack")
    return KdPack(
        box=box.contiguous(), link=link.contiguous(),
        tri=tri.reshape(n_tiles, KD_TILE, 9).transpose(1, 2).contiguous(),
        ids=ids.reshape(n_tiles, KD_TILE).to(torch.int32),
        leaf_tile=first.to(torch.int32), leaf_len=lens.to(torch.int32),
        num_tris=int(v0.shape[0]))


def kd_select_cuda(o, d, v0, e1, e2, eps: float, cull: bool,
                   tri_mask: Optional[torch.Tensor], tree: KdTree,
                   pack: Optional[KdPack] = None,
                   counter: Optional[torch.Tensor] = None):
    """The kd select: the CUDA kernel for CUDA tensors, the plain version
    (accel/traverse.py::kd_select) for CPU tensors -> (idx (R,) int32,
    hit (R,) bool).  On CUDA the rays, triangles and tree must share the
    rays' device; the tree's depth must fit the 64-slot stack.

    pack: pack_kd(tree, v0, e1, e2), built here when None.  counter: an
    int64 (3,) tensor on the rays' device that the kernel adds to:
    triangles staged, pair slots its leaf rounds run (staged live
    triangles x the block's rays) and pair tests run.  The launch shape is
    KD_SHAPE."""
    if not o.is_cuda:
        return kd_select(o, d, v0, e1, e2, eps, cull, tri_mask, tree)
    check_depth(tree)
    r, t = o.shape[0], v0.shape[0]
    for name in ("node_min", "node_max", "child0", "child1", "leaf_id",
                 "leaf_tris"):
        x = getattr(tree, name)
        if x.device != o.device:
            raise ValueError(f"tree.{name} is on {x.device}, the rays on "
                             f"{o.device}: move the tree with .to(device)")
    if pack is None:
        pack = pack_kd(tree, v0, e1, e2)
    check_table("pack.box", pack.box, (tree.num_nodes, 6), torch.float32,
                o.device)
    if pack.num_tris != t:
        raise ValueError(f"the pack holds {pack.num_tris} triangles, the "
                         f"call {t}")
    if counter is not None and (counter.dtype != torch.int64 or
                                counter.shape != (3,) or
                                counter.device != o.device):
        raise ValueError("counter: expected an int64 (3,) tensor on "
                         f"{o.device}")
    if tri_mask is None:
        tri_mask = torch.ones(t, dtype=torch.int32, device=o.device)
    idx = torch.zeros(r, dtype=torch.int32, device=o.device)
    hit = torch.zeros(r, dtype=torch.bool, device=o.device)
    launch("kd", o, d, (v0, e1, e2), tri_mask, None, torch.int32,
           lambda o32, d32, mask, _: (
               o32.data_ptr(), d32.data_ptr(), pack.tri.data_ptr(),
               pack.ids.data_ptr(), mask.data_ptr(),
               pack.leaf_tile.data_ptr(), pack.leaf_len.data_ptr(),
               pack.box.data_ptr(), pack.link.data_ptr(), r, *KD_SHAPE,
               float(eps), int(bool(cull)), idx.data_ptr(), hit.data_ptr(),
               None if counter is None else counter.data_ptr()))
    return idx, hit


@counted_select
def kd_window_select(o, d, v0, e1, e2, eps, cull, tri_mask=None,
                     t_max=None, any_hit=False, *, tree, pack=None):
    """The kd select under the common contract, as the JAX package
    emulates it: the closest hit first; with a window, the winner's
    refined t decides `hit &= t <= t_max` (the window is not applied
    inside the walk); with any_hit, idx is zeros.  pack: the kernel's
    packed tree and triangles (`bind` makes it), None to pack here.
    While tracing, the kernel adds its work to the record's kd counter."""
    idx, hit = kd_select_cuda(o, d, v0, e1, e2, eps, cull, tri_mask, tree,
                              pack, counter=profiling.kd_counter(o.device))
    if t_max is not None:
        gidx = idx.long()
        t, _, _ = mt_refine(o, d, v0[gidx], e1[gidx], e2[gidx], eps)
        hit = hit & (t <= t_max)
    if any_hit:
        idx = torch.zeros_like(idx)
    return idx, hit


def bind(tree: KdTree, geom):
    """The kd select on `tree`, bound to pack_kd of the tree and `geom`'s
    triangles when geom is given.  Where `tree.refit` asks for it, the
    tree's boxes are first refitted to geom's vertices: once a binding,
    span `refit`, with counters `kd.refit.calls` and `kd.refit.nodes`."""
    if tree is None:
        raise ValueError("intersector='kdtree' needs an accel: build one "
                         "with accel.build.build_kdtree_for_scene")
    if tree.refit:
        if geom is None:
            raise ValueError("a refitted kd tree needs the geometry of the "
                             "frame or step")
        with profiling.span("refit"):
            tree = refit_kdtree(tree, geom.vertices, geom.tri_vidx)
        profiling.count("kd.refit.calls")
        profiling.count("kd.refit.nodes", tree.num_nodes)
    pack = None if geom is None else pack_kd(tree, geom.v0, geom.e1,
                                             geom.e2)
    return functools.partial(kd_window_select, tree=tree, pack=pack)
