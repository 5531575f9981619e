"""Row gathers of differentiable tables, with a deterministic backward.

`gather_rows(table, idx)` is `table[idx]`, bit for bit.  Where autograd
will want the table's gradient (grad mode on and `table.requires_grad`),
the gather is a `GatherRows` node whose backward adds each row's
gradients as a segmented sum: the kernel `csrc/gather_grad.cu` on CUDA
tensors, its plain version `row_sums_reference` on CPU tensors, both in
one fixed order, so the same input gives the same bits on every run.
Otherwise it is the plain `table[idx]` and adds no node to the graph.

PyTorch's own backward of `table[idx]` (index_put_ with accumulate) walks
each row's duplicates on one thread.  The render's gathers read a few rows
very often (every missed slot reads triangle 0, every untextured material
texture 0), so that walk is serial in up to a whole wavefront.  Here the
sorted entries are cut into pieces of PIECE: a piece's segments are summed
by a segmented scan (Hillis-Steele, offsets 1, 2, ..., PIECE / 2), and a
row over several pieces adds its pieces' partials on LANES lanes (lane l
takes pieces l, l + LANES, ... in order) folded by a tree (offsets 16, 8,
4, 2, 1).  Sums keep the table's dtype.  The backward reads nothing back
to the host.

Indices must lie in [0, rows): negative ones, which `table[idx]` would
wrap, are not summed back.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from .. import kernels
from ..utils import profiling

PIECE = 256    # sorted entries a block of pass 1 sums (kPiece of the kernel)
LANES = 32     # a warp: the lanes of pass 2


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` for an integer `idx` of any shape: (*idx.shape,
    *table.shape[1:]).  Through GatherRows where autograd will want the
    table's gradient, plain indexing otherwise."""
    if torch.is_grad_enabled() and table.requires_grad:
        return GatherRows.apply(table, idx)
    return table[idx]


class GatherRows(torch.autograd.Function):
    """table[idx] whose backward is `row_sums` over the table's rows, each
    row flattened to a width (a (T, 3, 3) table has width 9)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        shape = ctx.table_shape
        n = idx.numel()
        if profiling.tracing():
            profiling.count("gather.backward.calls")
            profiling.count("gather.backward.rows", n)
            profiling.count("gather.backward.pieces", -(-n // PIECE))
        out = row_sums(idx.reshape(n), grad.reshape(n, math.prod(shape[1:])),
                       shape[0])
        return out.reshape(shape), None


def row_sums(idx: torch.Tensor, values: torch.Tensor, n_rows: int,
             launches: str = "gather.launches") -> torch.Tensor:
    """(n_rows, W): row r is the sum of values[i] (values (N, W)) over the
    entries with idx[i] == r (idx (N,) integer, in [0, n_rows)), zero where
    there is none.  The kernel for CUDA tensors, its two launches counted
    under `launches`; the plain version for CPU tensors."""
    if not values.is_cuda:
        return row_sums_reference(idx, values, n_rows)
    n, width = values.shape
    if values.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"row_sums: float32 or float64 values, got "
                         f"{values.dtype}")
    if idx.device != values.device or idx.shape != (n,):
        raise ValueError(f"row_sums: idx must be ({n},) on {values.device}, "
                         f"got {tuple(idx.shape)} on {idx.device}")
    out = torch.empty((n_rows, width), dtype=values.dtype,
                      device=values.device)
    if n == 0 or width == 0 or n_rows == 0:
        return out.zero_()
    rows, perm = torch.sort(idx.long(), stable=True)
    vals = values.contiguous()
    partial = torch.empty_like(vals)
    rc = kernels.library().srt_gather_grad(
        rows.data_ptr(), perm.data_ptr(), vals.data_ptr(), n, width, n_rows,
        int(vals.dtype == torch.float64), partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream)
    kernels.check(rc, "gather_grad")
    profiling.count(launches, 2)
    return out


def row_sums_reference(idx: torch.Tensor, values: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Plain torch version of the kernel, making its adds in its order."""
    n, width = values.shape
    out = values.new_zeros((n_rows, width))
    if n == 0 or width == 0:
        return out
    rows, perm = torch.sort(idx.long(), stable=True)

    # Pass 1: a segmented inclusive scan over each piece of PIECE sorted
    # entries; padding carries row -1 and zeros, after every real entry.
    pieces = -(-n // PIECE)
    pad = pieces * PIECE - n
    r = torch.cat([rows, rows.new_full((pad,), -1)]).view(pieces, PIECE)
    v = torch.cat([values[perm], values.new_zeros((pad, width))]).view(
        pieces, PIECE, width)
    o = 1
    while o < PIECE:
        same = (r[:, o:] == r[:, :-o])[..., None]
        tail = v[:, o:]
        v = torch.cat([v[:, :o], torch.where(same, tail + v[:, :-o], tail)],
                      dim=1)
        o *= 2
    v = v.reshape(-1, width)[:n]

    # Each segment's sum sits at its last entry in the piece: the partials,
    # in (row, piece) order.
    pos = torch.arange(n, device=rows.device)
    last = (pos % PIECE == PIECE - 1) | (pos == n - 1)
    last[:-1] |= rows[1:] != rows[:-1]
    ends = last.nonzero()[:, 0]
    part, prow = v[ends], rows[ends]
    counts = torch.bincount(prow, minlength=n_rows)
    rank = torch.arange(len(ends), device=rows.device) - (
        torch.cumsum(counts, 0) - counts)[prow]

    # Pass 2: a row in one piece takes its partial as it is.
    one = counts[prow] == 1
    out[prow[one]] = part[one]
    multi = (counts > 1).nonzero()[:, 0]
    if multi.numel():
        # A row over several pieces: lane l adds pieces l, l + LANES, ...
        # from +0 (absent pieces are +0, which leaves a sum that never is
        # -0 unchanged), then the lanes fold as the kernel's shuffle tree.
        slot = torch.full((n_rows,), -1, dtype=torch.long, device=rows.device)
        slot[multi] = torch.arange(multi.numel(), device=rows.device)
        rounds = -(-int(counts.max()) // LANES)
        lanes = values.new_zeros((multi.numel(), rounds, LANES, width))
        many = ~one
        k = rank[many]
        lanes[slot[prow[many]], k // LANES, k % LANES] = part[many]
        acc = values.new_zeros((multi.numel(), LANES, width))
        for j in range(rounds):
            acc = acc + lanes[:, j]
        step = LANES // 2
        while step:
            acc = torch.cat([acc[:, :step] + acc[:, step:2 * step],
                             acc[:, step:]], dim=1)
            step //= 2
        out[multi] = acc[:, 0]
    return out
