"""Ray-triangle intersection: Moller-Trumbore over (rays x triangles).

Counterpart of `simd_raytracer_tpu.ops.intersect`.  Differentiability is
split in two, as there:

  * the select picks each ray's winning triangle (a discrete choice) and
    runs under `torch.no_grad()`;
  * the record recomputes t, u, v for the winner (`mt_refine`), so
    gradients reach the vertices through the winner's formulas, and
    gathers the winner's normals, UVs and material.  On CPU tensors it is
    plain differentiable torch (`record_reference`).  On CUDA tensors,
    which must be float32, it is one launch of csrc/trace.cu
    (`record_fused`), bit for bit the plain version's, and where a
    gradient is wanted one autograd node (`_RecordGrad`) whose backward is
    one more launch and two deterministic segmented sums
    (`ops/gather.py::row_sums`), the plain version's gradients up to
    rounding.  While tracing, counters `trace.fused.calls`,
    `trace.fused.rows`, `trace.fused.grad_calls` and `trace.plain.calls`
    say which path ran, `trace.launches` counts the forward's launches,
    and `trace.backward.calls` and `trace.backward.launches` the
    backward's.

Every select shares one contract,
`(o, d, v0, e1, e2, eps, cull, tri_mask, t_max, any_hit) -> (idx, hit)`:
`t_max` is an inclusive per-ray window and `any_hit` asks only whether any
accepted pair lies in it (then `idx` is zeros).  Ties on t go to the lowest
triangle index.  Every arithmetic step is its own torch op, so nothing is
fused into a multiply-add and the CUDA kernels, built without contraction,
reproduce the winners bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import kernels
from ..kernels import data_ptr
from ..models.scene import Geometry, Scene, TensorStruct, cross3, dot3
from ..utils import profiling
from .gather import gather_rows, row_sums

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


def counted_select(fn):
    """Decorator of a select under the common contract: while tracing,
    each call is span `select` (wrapper included) and adds to the
    `select.calls` and `select.rays` counters."""
    @functools.wraps(fn)
    def select(o, *args, **kwargs):
        if not profiling.tracing():
            return fn(o, *args, **kwargs)
        with profiling.span("select"):
            profiling.count("select.calls")
            profiling.count("select.rays", o.shape[0])
            return fn(o, *args, **kwargs)
    return select


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


# RenderConfig.intersector -> the module whose `bind(accel, geom)` builds
# the tables that backend's select reads and binds the select to them.
BACKENDS = {"jnp": "intersect_brute", "pallas": "intersect_brute",
            "fast": "intersect_fast", "mxu": "intersect_mxu",
            "kdtree": "intersect_kd", "sweep": "intersect_sweep"}


def make_select_fn(intersector: str, accel=None,
                   geom: Optional[Geometry] = None):
    """Resolve a RenderConfig.intersector name to a select function.

    "jnp" and "pallas" resolve to the brute-force select, "fast" to the
    division-free bilinear one, "mxu" to its numerators as matrix
    products, "kdtree" and "sweep" to the walks of the KdTree or SweepData
    given as `accel`.  The backend's `bind` builds the tables its select
    reads from `geom`'s triangles (without a geom, each call builds them)
    and the bound select is kept on `geom` for the accel object: the
    selects of a frame or train step share their Geometry object, so they
    share one binding.  A Geometry made by .to(), .map() or .replace()
    starts with none."""
    if geom is None:
        return _bind(intersector, accel, None)
    key = (intersector, id(accel))
    entry = geom.selects.get(key)
    if entry is None:
        # The entry holds `accel`, so no other object takes its id while
        # the entry lives.
        entry = geom.selects[key] = (accel, _bind(intersector, accel, geom))
    return entry[1]


def _bind(intersector: str, accel, geom: Optional[Geometry]):
    if intersector not in BACKENDS:
        raise ValueError(intersector)
    backend = importlib.import_module(f"{__package__}.{BACKENDS[intersector]}")
    with torch.no_grad():               # the tables are constants
        return backend.bind(accel, geom)


@profiling.spanned("trace")
def trace(o: torch.Tensor, d: torch.Tensor, scene: Scene, geom: Geometry,
          eps: float, cull: bool, tri_mask: Optional[torch.Tensor] = None,
          intersector: str = "jnp", accel=None) -> HitRecord:
    """Closest-hit query for a ray wavefront: N rays in, N records out
    (mask False on a miss).  The select, then the record: `record_fused`
    on CUDA tensors, which must be float32, `record_reference` on CPU
    tensors, the same values either way."""
    fused = record_applies(o)
    mask = tri_mask if tri_mask is not None else geom.tri_valid
    select = make_select_fn(intersector, accel, geom)
    with torch.no_grad():
        idx, hit = select(o.detach(), d.detach(), geom.v0.detach(),
                          geom.e1.detach(), geom.e2.detach(), eps, cull, mask)
    if fused:
        if profiling.tracing():
            profiling.count("trace.fused.calls")
            profiling.count("trace.fused.rows", o.shape[0])
        return record_fused(o, d, idx, hit, scene, geom, eps)
    if profiling.tracing():
        profiling.count("trace.plain.calls")
    return record_reference(o, d, idx, hit, scene, geom, eps)


def record_applies(o: torch.Tensor) -> bool:
    """Whether `trace` makes the record with csrc/trace.cu: on CUDA
    tensors, which the kernels take in float32 only (another dtype there
    is refused)."""
    if not o.is_cuda:
        return False
    if o.dtype != torch.float32:
        raise ValueError(f"trace: CUDA tensors must be float32 (the dtype "
                         f"of csrc/trace.cu), got {o.dtype}")
    return True


def record_reference(o, d, idx, hit, scene: Scene, geom: Geometry,
                     eps: float) -> HitRecord:
    """The record of the select's winners `idx` and flags `hit` in plain
    torch ops, which autograd differentiates on the CPU: the plain version
    of `record_fused`."""
    # The tables' gathers go through gather_rows: in training their
    # backward is a deterministic segmented sum (ops/gather.py), where
    # every missed slot's idx 0 makes one long run of duplicates.
    gidx = idx.long()
    t, u, v = mt_refine(o, d, gather_rows(geom.v0, gidx),
                        gather_rows(geom.e1, gidx),
                        gather_rows(geom.e2, gidx), eps)
    # A missed ray carries idx 0, whose refine can reach the determinant
    # clamp; pin misses to a harmless finite record (ops/intersect.py:250).
    t = torch.where(hit, t, 1.0)
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    w = 1.0 - u - v
    position = o + t[:, None] * d

    vn = gather_rows(geom.vn, gidx)
    n_interp = (u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2]
                + w[:, None] * vn[:, 0])
    sq = dot3(n_interp, n_interp).clamp_min(1e-18)
    hit_n = n_interp * torch.sqrt(sq).reciprocal()[:, None]

    mat = geom.tri_mat[gidx].long()
    return HitRecord(
        mask=hit, idx=idx, t=t, u=u, v=v, w=w, position=position,
        hit_n=hit_n, face_n=gather_rows(geom.face_n, gidx),
        uvs=gather_rows(geom.uv, gidx), mat_tag=scene.mat_tag[mat],
        albedo=gather_rows(scene.mat_albedo, mat),
        ior=gather_rows(scene.mat_ior, mat), smooth=scene.mat_smooth[mat],
        tex=scene.mat_tex[mat], mesh_idx=geom.tri_mesh[gidx])


# The record's float fields, which autograd may differentiate, in the
# order `_RecordGrad` returns them; then its integer and bool fields.
_GRAD_FIELDS = ("t", "u", "v", "w", "position", "hit_n", "face_n", "uvs",
                "albedo", "ior")
_INT_FIELDS = ("mat_tag", "smooth", "tex", "mesh_idx")
# The trailing shape of each float field (a scalar a ray where not listed).
_FIELD_SHAPES = {"position": (3,), "hit_n": (3,), "face_n": (3,),
                 "uvs": (3, 2), "albedo": (3,)}
# The tables a record reads that autograd may differentiate, after o and d
# (`_grad_tables`), and the width of each in a ray's row of triangle-table
# gradients (csrc/trace.cu's tri_grad: 27) or material-table gradients
# (mat_grad: 4).
_TRI_TABLES = (("v0", 3), ("e1", 3), ("e2", 3), ("vn", 9), ("face_n", 3),
               ("uv", 6))
_MAT_TABLES = (("mat_albedo", 3), ("mat_ior", 1))
_TRI_WIDTH = sum(width for _, width in _TRI_TABLES)
_MAT_WIDTH = sum(width for _, width in _MAT_TABLES)


def _grad_tables(scene: Scene, geom: Geometry) -> list:
    return ([getattr(geom, k) for k, _ in _TRI_TABLES]
            + [getattr(scene, k) for k, _ in _MAT_TABLES])


class _Record(NamedTuple):
    """What a fused record takes besides the tensors autograd may
    differentiate: the select's result, the integer and bool tables, and
    the determinant's clamp."""
    idx: torch.Tensor
    hit: torch.Tensor
    tri_mat: torch.Tensor
    tri_mesh: torch.Tensor
    mat_tag: torch.Tensor
    mat_smooth: torch.Tensor
    mat_tex: torch.Tensor
    eps: float


def record_fused(o, d, idx, hit, scene: Scene, geom: Geometry,
                 eps: float) -> HitRecord:
    """`record_reference` through csrc/trace.cu, float32 CUDA tensors: one
    launch, equal to the plain version bit for bit.  Where a gradient is
    wanted (grad mode on, and o, d or a table of `_grad_tables` requires
    grad) the launch runs as the autograd node `_RecordGrad`."""
    rec = _Record(idx, hit, geom.tri_mat, geom.tri_mesh, scene.mat_tag,
                  scene.mat_smooth, scene.mat_tex, eps)
    inputs = [o, d, *_grad_tables(scene, geom)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        profiling.count("trace.fused.grad_calls")
        out = _RecordGrad.apply(rec, *inputs)
    else:
        out = _record(rec, *inputs)
    return HitRecord(mask=hit, idx=idx,
                     **dict(zip(_GRAD_FIELDS + _INT_FIELDS, out)))


# The pointer fields of RecordArgs (csrc/trace.cu), in its order: the
# inputs, then the outputs.
_RECORD_INPUTS = ("o", "d", "idx", "hit", "v0", "e1", "e2", "vn",
                  "tri_face_n", "tri_uv", "tri_mat", "tri_mesh", "mat_tag",
                  "mat_albedo", "mat_ior", "mat_smooth", "mat_tex")
_RECORD_OUTPUTS = _GRAD_FIELDS + ("tag", "smooth", "tex", "mesh_idx")
# The dtype of each output that is not float32.
_OUTPUT_DTYPES = {"tag": torch.int32, "smooth": torch.bool,
                  "tex": torch.int32, "mesh_idx": torch.int32}


class RecordArgs(ctypes.Structure):
    """csrc/trace.cu's RecordArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p)
                 for name in _RECORD_INPUTS + _RECORD_OUTPUTS]
                + [("n", ctypes.c_int64), ("eps", ctypes.c_float)])


class RecordGradArgs(ctypes.Structure):
    """csrc/trace.cu's RecordGradArgs, field for field."""
    _fields_ = ([("f", RecordArgs)]
                + [(f"g_{name}", ctypes.c_void_p) for name in _GRAD_FIELDS]
                + [(name, ctypes.c_void_p) for name in (
                    "g_o", "g_d", "tri_grad", "mat_grad", "mat_key")])


def _record_args(rec: _Record, inputs, **outputs) -> RecordArgs:
    """The RecordArgs of a call (its rays and tables `inputs`, in
    `_RecordGrad`'s order, checked) with the output pointers given, null
    where not given."""
    o, d, v0, e1, e2, vn, face_n, uv, albedo, ior = inputs
    n, n_tri, n_mat = o.shape[0], v0.shape[0], albedo.shape[0]
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    tri3 = (n_tri, 3)
    return RecordArgs(
        o=data_ptr(o, f32, (n, 3), dev), d=data_ptr(d, f32, (n, 3), dev),
        idx=data_ptr(rec.idx, i32, (n,), dev),
        hit=data_ptr(rec.hit, torch.bool, (n,), dev),
        v0=data_ptr(v0, f32, tri3, dev), e1=data_ptr(e1, f32, tri3, dev),
        e2=data_ptr(e2, f32, tri3, dev),
        vn=data_ptr(vn, f32, (n_tri, 3, 3), dev),
        tri_face_n=data_ptr(face_n, f32, tri3, dev),
        tri_uv=data_ptr(uv, f32, (n_tri, 3, 2), dev),
        tri_mat=data_ptr(rec.tri_mat, i32, (n_tri,), dev),
        tri_mesh=data_ptr(rec.tri_mesh, i32, (n_tri,), dev),
        mat_tag=data_ptr(rec.mat_tag, i32, (n_mat,), dev),
        mat_albedo=data_ptr(albedo, f32, (n_mat, 3), dev),
        mat_ior=data_ptr(ior, f32, (n_mat,), dev),
        mat_smooth=data_ptr(rec.mat_smooth, torch.bool, (n_mat,), dev),
        mat_tex=data_ptr(rec.mat_tex, i32, (n_mat,), dev),
        # eps as torch rounds a Python number to compare a float32 tensor.
        n=n, eps=np.float32(rec.eps),
        **{name: t.data_ptr() for name, t in outputs.items()})


def _record(rec: _Record, *inputs) -> list:
    """trace_record, where there is a ray: the record's fields in
    `_GRAD_FIELDS` then `_INT_FIELDS` order."""
    o = inputs[0]
    inputs = [t.contiguous() for t in inputs]
    n, dev = o.shape[0], o.device
    out = {name: torch.empty((n, *_FIELD_SHAPES.get(name, ())),
                             dtype=_OUTPUT_DTYPES.get(name, torch.float32),
                             device=dev)
           for name in _RECORD_OUTPUTS}
    if n:
        args = _record_args(rec, inputs, **out)
        kernels.check(kernels.library().srt_trace_record(
            ctypes.byref(args), kernels.stream(dev)), "trace_record")
        profiling.count("trace.launches")
    return list(out.values())


class _RecordGrad(torch.autograd.Function):
    """`_record` as an autograd node over o, d and `_grad_tables`.  The
    forward is the kernel; the backward is `_record_grad`
    (csrc/trace.cu's trace_record_grad and two segmented sums)."""

    @staticmethod
    def forward(ctx, rec: _Record, *inputs):
        ctx.rec = rec
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        out = _record(rec, *inputs)
        ctx.mark_non_differentiable(*out[len(_GRAD_FIELDS):])
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *_record_grad(ctx.rec, ctx.saved_tensors,
                                    grads[:len(_GRAD_FIELDS)],
                                    ctx.needs_input_grad[1:]))


def _record_grad(rec: _Record, inputs, grads, wanted) -> list:
    """The backward of `_record` through csrc/trace.cu: from the gradients
    of the record's float fields (None where none came) to those of o, d
    and `_grad_tables`, None where `wanted` is False.

    trace_record_grad writes each ray's gradients of o and d and its rows
    of triangle-table and material-table gradients; `row_sums` adds the
    rows by the winner's triangle and by its material in a fixed order."""
    o = inputs[0]
    n, dev = o.shape[0], o.device
    profiling.count("trace.backward.calls")
    if n == 0 or all(g is None for g in grads):
        return [None] * len(wanted)
    f32 = torch.float32
    n_tri, n_mat = inputs[2].shape[0], inputs[2 + len(_TRI_TABLES)].shape[0]
    want_tri = any(wanted[2:2 + len(_TRI_TABLES)])
    want_mat = any(wanted[2 + len(_TRI_TABLES):])
    bufs = {}
    for name, g in zip(_GRAD_FIELDS, grads):
        if g is not None:
            bufs[f"g_{name}"] = g = g.contiguous()
            data_ptr(g, f32, (n, *_FIELD_SHAPES.get(name, ())), dev)
    for name, want in (("g_o", wanted[0]), ("g_d", wanted[1])):
        if want:
            bufs[name] = torch.empty((n, 3), dtype=f32, device=dev)
    if want_tri:
        bufs["tri_grad"] = torch.empty((n, _TRI_WIDTH), dtype=f32,
                                       device=dev)
    if want_mat:
        bufs["mat_grad"] = torch.empty((n, _MAT_WIDTH), dtype=f32,
                                       device=dev)
        bufs["mat_key"] = torch.empty(n, dtype=torch.int64, device=dev)
    # The contiguous inputs stay referenced until the launch is enqueued.
    contiguous = [t.contiguous() for t in inputs]
    args = RecordGradArgs(f=_record_args(rec, contiguous),
                          **{key: t.data_ptr() for key, t in bufs.items()})
    kernels.check(kernels.library().srt_trace_record_grad(
        ctypes.byref(args), kernels.stream(dev)), "trace_record_grad")
    profiling.count("trace.backward.launches")
    result = [bufs.get("g_o"), bufs.get("g_d")]
    for key, idx, n_rows, tables in (
            ("tri_grad", rec.idx, n_tri, _TRI_TABLES),
            ("mat_grad", bufs.get("mat_key"), n_mat, _MAT_TABLES)):
        if key not in bufs:
            result += [None] * len(tables)
            continue
        sums = row_sums(idx, bufs[key], n_rows,
                        launches="trace.backward.launches")
        col = 0
        for (_, width), table in zip(tables, inputs[len(result):]):
            result.append(sums[:, col:col + width].reshape(table.shape))
            col += width
    return [g if want else None for g, want in zip(result, wanted)]

