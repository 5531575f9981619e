"""Sweep acceleration data: the triangle soup cut into dense slices.

Counterpart of `simd_raytracer_tpu.accel.sweep`.  Slices of SLICE_SIZE
triangles come either from the valid triangles sorted along a 30-bit
Morton curve of their centroids ("morton", disjoint) or from the leaves of
a deeper kd build ("kdleaf": a triangle touching a split plane sits in
several slices; the selects merge on (t, global id), so a duplicate
changes no winner).  Each slice is a (9, SLICE_SIZE) SoA packet (v0, e1,
e2 rows) with a tight AABB over its members.  The sweep select
(ops/intersect_sweep.py) tests a ray tile only against the slices its
interval boxes can reach, front to back.  Built in NumPy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.scene import TensorStruct
from .build import build_kdtree, scene_aabbs

# Triangles per slice and rays per tile: the JAX package's defaults, and
# the only shapes the CUDA sweep kernel is built for.
SLICE_SIZE = 256
R_TILE = 512


@dataclasses.dataclass
class SweepData(TensorStruct):
    """S slices of SLICE_SIZE triangles each."""

    tri_soa: torch.Tensor   # (S, 9, slice) float32: v0xyz, e1xyz, e2xyz
    aabb: torch.Tensor      # (S, 8) float32: min xyz, max xyz, 2 pad
    tri_ids: torch.Tensor   # (S, slice) int32 global triangle ids, -1 pad
    r_tile: int = R_TILE    # rays per tile of the sweep select

    @property
    def num_slices(self) -> int:
        return int(self.tri_ids.shape[0])


def _morton_order(tri_min: np.ndarray, tri_max: np.ndarray,
                  ids: np.ndarray) -> np.ndarray:
    """Sort triangle ids along a 30-bit Morton curve of their centroids."""
    if len(ids) == 0:
        return ids
    c = 0.5 * (tri_min[ids] + tri_max[ids])
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-30)
    q = np.minimum((1023.0 * (c - lo) / span), 1023.0).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return ids[np.argsort(code, kind="stable")]


def build_sweep_for_scene(scene, partition: str = "morton",
                          max_depth: int = 12,
                          max_leaf: int = 128) -> SweepData:
    """Pack the scene's valid triangles into slices.

    "morton": exactly ceil(T / SLICE_SIZE) disjoint slices along the
    Morton curve.  "kdleaf": each leaf of a kd build with `max_depth` and
    `max_leaf` (JAX's defaults) cut into slices of SLICE_SIZE.  An empty
    slice gets an inverted box (min > max) that the reach test culls.
    Returns CPU tensors; move them with `.to(device)`."""
    tri_min, tri_max, valid = scene_aabbs(scene)
    vertices = scene.vertices.detach().cpu().numpy().astype(np.float32)
    tri_vidx = scene.tri_vidx.cpu().numpy()

    if partition == "morton":
        order = _morton_order(tri_min, tri_max,
                              np.flatnonzero(valid).astype(np.int32))
        slices = [order[s:s + SLICE_SIZE]
                  for s in range(0, len(order), SLICE_SIZE)]
    elif partition == "kdleaf":
        tree = build_kdtree(tri_min, tri_max, valid, max_depth, max_leaf)
        slices = []
        for row in tree.leaf_tris.numpy():
            tris = row[row >= 0]
            slices += [tris[s:s + SLICE_SIZE]
                       for s in range(0, len(tris), SLICE_SIZE)]
    else:
        raise ValueError(f"unknown partition {partition!r}")
    if not slices:
        slices.append(np.zeros(0, np.int32))

    s_count = len(slices)
    tri_ids = np.full((s_count, SLICE_SIZE), -1, np.int32)
    tri_soa = np.zeros((s_count, 9, SLICE_SIZE), np.float32)
    aabb = np.zeros((s_count, 8), np.float32)

    corners = vertices[tri_vidx]
    v0 = corners[:, 0]
    e1 = corners[:, 1] - corners[:, 0]
    e2 = corners[:, 2] - corners[:, 0]
    soa_all = np.concatenate([v0.T, e1.T, e2.T], axis=0)   # (9, T)

    for i, tris in enumerate(slices):
        n = len(tris)
        if n == 0:
            aabb[i, 0:3] = 1.0
            aabb[i, 3:6] = -1.0
            continue
        tri_ids[i, :n] = tris
        tri_soa[i, :, :n] = soa_all[:, tris]
        aabb[i, 0:3] = tri_min[tris].min(axis=0)
        aabb[i, 3:6] = tri_max[tris].max(axis=0)

    return SweepData(tri_soa=torch.from_numpy(tri_soa),
                     aabb=torch.from_numpy(aabb),
                     tri_ids=torch.from_numpy(tri_ids))
