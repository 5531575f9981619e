"""kd-tree select: the CUDA kernel `csrc/kd_select.cu` and its wrapper.

The plain version is `accel/traverse.py::kd_select` (a port of the JAX
package's jnp `kd_select`, which has no Pallas kernel).  The kernel walks
each ray's stack in its own thread and gives the same (idx, hit): the
closest accepted triangle, lowest id on exact t ties, idx 0 on a miss.
It takes no window: `ops/intersect.py::make_select_fn("kdtree")` emulates
t_max and any-hit around it, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..accel.build import KdTree
from ..accel.traverse import check_depth, kd_select

# Kernel launches made by kd_select_cuda on CUDA tensors.
LAUNCHES = 0
# Dynamic shared memory a block may take on Hopper (232,448 bytes), and
# what the kernel stages per node (6 floats of box, 4 ints of links).
SMEM_LIMIT = 232448
NODE_BYTES = 40


def _pack_nodes(tree: KdTree):
    """The kernel's node records: (N, 6) float32 box min and max, and
    (N, 4) int32 child0, child1, leaf_id and a zero pad."""
    box = torch.cat([tree.node_min, tree.node_max], dim=1).float()
    link = torch.stack([tree.child0, tree.child1, tree.leaf_id,
                        torch.zeros_like(tree.child0)], dim=1).to(torch.int32)
    return box.contiguous(), link.contiguous()


def kd_select_cuda(o, d, v0, e1, e2, eps: float, cull: bool,
                   tri_mask: Optional[torch.Tensor], tree: KdTree):
    """The kd select: the CUDA kernel for CUDA tensors, the plain version
    (accel/traverse.py::kd_select) for CPU tensors -> (idx (R,) int32,
    hit (R,) bool).  On CUDA the rays, triangles and tree must share the
    rays' device; the tree's depth must fit the 64-slot stack."""
    if not o.is_cuda:
        return kd_select(o, d, v0, e1, e2, eps, cull, tri_mask, tree)
    global LAUNCHES
    check_depth(tree)
    r, t = o.shape[0], v0.shape[0]
    for name, x, rows in (("o", o, r), ("d", d, r), ("v0", v0, t),
                          ("e1", e1, t), ("e2", e2, t)):
        if x.device != o.device or tuple(x.shape) != (rows, 3):
            raise ValueError(f"{name}: expected ({rows}, 3) on {o.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    for name in ("node_min", "node_max", "child0", "child1", "leaf_id",
                 "leaf_tris"):
        x = getattr(tree, name)
        if x.device != o.device:
            raise ValueError(f"tree.{name} is on {x.device}, the rays on "
                             f"{o.device}: move the tree with .to(device)")
    leaf_tris = tree.leaf_tris
    if leaf_tris.dtype != torch.int32 or not leaf_tris.is_contiguous():
        raise ValueError("tree.leaf_tris: expected contiguous int32, got "
                         f"{leaf_tris.dtype}")
    n_nodes = tree.num_nodes
    if n_nodes * NODE_BYTES > SMEM_LIMIT:
        raise ValueError(f"kd-tree of {n_nodes} nodes does not fit the "
                         f"kernel's shared memory ({SMEM_LIMIT} bytes)")
    o32 = o.float().contiguous()
    d32 = d.float().contiguous()
    tri = torch.cat([v0, e1, e2], dim=1).float().contiguous()     # (T, 9)
    mask = (torch.ones(t, dtype=torch.int32, device=o.device)
            if tri_mask is None else
            tri_mask.to(device=o.device, dtype=torch.int32).contiguous())
    if mask.shape != (t,):
        raise ValueError(f"tri_mask {tuple(mask.shape)} does not match T={t}")
    box, link = _pack_nodes(tree)
    idx = torch.zeros(r, dtype=torch.int32, device=o.device)
    hit = torch.zeros(r, dtype=torch.bool, device=o.device)
    if r:
        rc = kernels.library().srt_kd_select(
            o32.data_ptr(), d32.data_ptr(), tri.data_ptr(), mask.data_ptr(),
            box.data_ptr(), link.data_ptr(), tree.leaf_tris.data_ptr(),
            r, n_nodes, tree.leaf_cap, float(eps), int(bool(cull)),
            idx.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
        kernels.check(rc, "kd_select")
        LAUNCHES += 1
    return idx, hit
