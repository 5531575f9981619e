"""Host-side kd-tree construction (NumPy), handed over as CPU tensors.

Counterpart of `simd_raytracer_tpu.accel.build`, with the same topology
array for array (reference kd_tree_simd.hpp:146-185):

  * root AABB = union of the valid triangles' AABBs,
  * midpoint split cycling axis = depth % 3, skipping degenerate axes by
    advancing to (axis + 1) % 3 (aabb3.hpp:43-60),
  * a triangle whose AABB touches both half-boxes (inclusive overlap) is
    duplicated into both children (kd_tree_simd.hpp:160-170),
  * leaf when depth == max_depth or count <= max_leaf,
  * nodes in preorder; leaf triangle lists as rows of one (L, CAP) int32
    matrix, -1 padded, CAP a multiple of 8.

The C++ builder in `native/kdtree.cpp` (bound by `..native`) gives the same
arrays; this NumPy version is its fallback and its oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.scene import TensorStruct

DEFAULT_MAX_DEPTH = 8     # kd_tree_simd.hpp:65
DEFAULT_MAX_LEAF = 64     # kd_tree_simd.hpp:66
KDTREE_FIELDS = ("node_min", "node_max", "child0", "child1", "leaf_id",
                 "leaf_tris")


@dataclasses.dataclass
class KdTree(TensorStruct):
    """Flattened kd-tree: N nodes, L leaves, CAP = the largest leaf padded
    to a multiple of 8."""

    node_min: torch.Tensor    # (N, 3) float32
    node_max: torch.Tensor    # (N, 3) float32
    child0: torch.Tensor      # (N,) int32, -1 for leaves
    child1: torch.Tensor      # (N,) int32, -1 for leaves
    leaf_id: torch.Tensor     # (N,) int32 row of leaf_tris, -1 for inner
    leaf_tris: torch.Tensor   # (L, CAP) int32 triangle ids, -1 padding
    # The built tree's depth (root = 0): traversal sizes its per-ray stack
    # from it and refuses a tree too deep for that stack.
    depth: int = DEFAULT_MAX_DEPTH

    @property
    def num_nodes(self) -> int:
        return int(self.child0.shape[0])

    @property
    def leaf_cap(self) -> int:
        return int(self.leaf_tris.shape[1])


def tree_depth(child0: np.ndarray, child1: np.ndarray) -> int:
    """Depth of the flattened tree (root = depth 0), level by level."""
    c0 = np.asarray(child0)
    c1 = np.asarray(child1)
    depth = 0
    frontier = np.array([0], np.int32) if len(c0) else np.array([], np.int32)
    while True:
        kids = np.concatenate([c0[frontier], c1[frontier]])
        kids = kids[kids >= 0]
        if len(kids) == 0:
            return depth
        depth += 1
        frontier = kids


def kdtree_from_arrays(arrays, device="cpu") -> KdTree:
    """KdTree from NumPy arrays named like its fields (for instance a JAX
    KdTree's fields through np.asarray); depth from the topology."""
    fields = {name: torch.from_numpy(np.array(arrays[name])).to(device)
              for name in KDTREE_FIELDS}
    for name in ("node_min", "node_max"):
        fields[name] = fields[name].float()
    for name in ("child0", "child1", "leaf_id", "leaf_tris"):
        fields[name] = fields[name].to(torch.int32)
    return KdTree(**fields, depth=tree_depth(np.asarray(arrays["child0"]),
                                             np.asarray(arrays["child1"])))


def _split_box(bmin: np.ndarray, bmax: np.ndarray, axis: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Midpoint split with degenerate-axis skip (aabb3.hpp:43-60) ->
    (b0_max, b1_min, mid, axis used), or None when every axis is
    degenerate (a forced leaf)."""
    for k in range(3):
        ax = (axis + k) % 3
        if bmax[ax] - bmin[ax] > 0.0:
            mid = 0.5 * (bmin[ax] + bmax[ax])
            b0_max = bmax.copy()
            b0_max[ax] = mid
            b1_min = bmin.copy()
            b1_min[ax] = mid
            return b0_max, b1_min, mid, ax
    return None


def build_kdtree(tri_min: np.ndarray, tri_max: np.ndarray,
                 valid: Optional[np.ndarray] = None,
                 max_depth: int = DEFAULT_MAX_DEPTH,
                 max_leaf: int = DEFAULT_MAX_LEAF) -> KdTree:
    """Build the flattened kd-tree over (T, 3) triangle AABBs in NumPy;
    triangles where `valid` is False (padding) are left out."""
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    t = len(tri_min)
    ids_all = (np.flatnonzero(np.asarray(valid)) if valid is not None
               else np.arange(t)).astype(np.int32)

    if len(ids_all):
        root_min = tri_min[ids_all].min(axis=0)
        root_max = tri_max[ids_all].max(axis=0)
    else:
        root_min = np.zeros(3, np.float32)
        root_max = np.zeros(3, np.float32)

    node_min, node_max = [], []
    child0, child1, leaf_id = [], [], []
    leaves: list = []

    def add_node(bmin, bmax):
        node_min.append(bmin)
        node_max.append(bmax)
        child0.append(-1)
        child1.append(-1)
        leaf_id.append(-1)
        return len(child0) - 1

    def rec(ids: np.ndarray, bmin: np.ndarray, bmax: np.ndarray,
            depth: int) -> int:
        me = add_node(bmin, bmax)
        split = None
        if depth < max_depth and len(ids) > max_leaf:
            split = _split_box(bmin, bmax, depth % 3)
        if split is None:
            leaf_id[me] = len(leaves)
            leaves.append(ids)
            return me
        b0_max, b1_min, mid, ax = split
        # Inclusive AABB overlap (aabb3.hpp:68-72): a triangle touching
        # the split plane goes to both children.
        in0 = tri_min[ids, ax] <= mid
        in1 = tri_max[ids, ax] >= mid
        child0[me] = rec(ids[in0], bmin, b0_max, depth + 1)
        child1[me] = rec(ids[in1], b1_min, bmax, depth + 1)
        return me

    rec(ids_all, root_min, root_max, 0)

    cap = max(8, -(-max((len(l) for l in leaves), default=1) // 8) * 8)
    leaf_tris = np.full((max(1, len(leaves)), cap), -1, np.int32)
    for i, l in enumerate(leaves):
        leaf_tris[i, :len(l)] = l

    return kdtree_from_arrays(dict(
        node_min=np.stack(node_min), node_max=np.stack(node_max),
        child0=np.array(child0, np.int32), child1=np.array(child1, np.int32),
        leaf_id=np.array(leaf_id, np.int32), leaf_tris=leaf_tris))


def triangle_aabbs(vertices: np.ndarray, tri_vidx: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle AABBs (scene/primitive/triangle.hpp:26-30)."""
    corners = np.asarray(vertices)[np.asarray(tri_vidx)]      # (T, 3, 3)
    return corners.min(axis=1), corners.max(axis=1)


def scene_aabbs(scene) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A Scene's float32 triangle AABBs and validity, on the host."""
    vertices = scene.vertices.detach().cpu().numpy().astype(np.float32)
    tri_min, tri_max = triangle_aabbs(vertices, scene.tri_vidx.cpu().numpy())
    return tri_min, tri_max, scene.tri_valid.cpu().numpy()


def build_kdtree_for_scene(scene, max_depth: int = DEFAULT_MAX_DEPTH,
                           max_leaf: int = DEFAULT_MAX_LEAF,
                           use_native: Optional[bool] = None) -> KdTree:
    """Build the kd-tree over a Scene's triangles, on the host -> CPU
    tensors (move them with `.to(device)`).

    The topology follows the current vertices and is not differentiable;
    the reference likewise builds once per run (src/main.cpp:41).
    use_native: True forces the C++ builder (raising where it cannot be
    built), False the NumPy one; None takes the C++ builder when its
    library builds and NumPy otherwise.  Both give the same arrays."""
    tri_min, tri_max, valid = scene_aabbs(scene)
    if use_native is None or use_native:
        from ..native import native_build_kdtree
        tree = native_build_kdtree(tri_min, tri_max, valid, max_depth,
                                   max_leaf, required=bool(use_native))
        if tree is not None:
            return tree
    return build_kdtree(tri_min, tri_max, valid, max_depth, max_leaf)
