"""PyTorch port: the hit record of `ops/intersect.py::trace`, on the CPU.

`trace` makes its record with csrc/trace.cu (`record_fused`) on CUDA
tensors, which must be float32, and with the plain torch version
`record_reference` on CPU tensors.  Where a gradient is wanted the launch
runs as the autograd node `_RecordGrad`, whose backward is the kernel
`trace_record_grad` and two segmented sums.  Here the kernels, built for
the CPU by `cuda_on_cpu`, are held to the plain version: the record bit
for bit (glibc's sqrtf and IEEE division round as torch's CPU kernels do,
and nothing contracts), every gradient by the float64 yardstick
(`yardstick.gradient_gaps`); the choice of path is pinned for the device
and the dtype, and the counters are read.  The kernels are held against
the plain version on the card in tests/test_torch_cuda.py."""

import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.models.scene import build_scene
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import intersect as I
from simd_raytracer_tpu_torch.utils import profiling
import cuda_on_cpu
from torch_scenes import SeededUniforms, bitmap_scene_kwargs, mixed_doc
from yardstick import (EPS, RECORD_LEAVES, gradient_gaps, record_case,
                       record_grads)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    """The mixed scene (untextured materials, glass, a mirror) and the
    four-texture scene (albedo, edges, checker, bitmap)."""
    return {"mixed": T.parse_scene_dict(mixed_doc(12, 16, g=8, subdiv=2)),
            "textured": build_scene(**bitmap_scene_kwargs(32, 32))}


@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    return cuda_on_cpu.build(str(tmp_path_factory.mktemp("record_cpu")))


@pytest.fixture
def cpu_kernels(monkeypatch, cpu_library):
    """The kernels' CPU build as `kernels.library()`, launched on CPU
    tensors (no stream)."""
    monkeypatch.setattr(kernels, "library", lambda: cpu_library)
    monkeypatch.setattr(kernels, "stream", lambda device: None)


def same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def assert_same_record(got, ref):
    for field in ("mask", "idx", *I._GRAD_FIELDS, *I._INT_FIELDS):
        assert same_bits(getattr(got, field), getattr(ref, field)), field


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["mixed", "textured"])
def test_record_kernel_is_the_plain_record(scenes, cpu_kernels, name, cull):
    """Hits and misses (idx 0), rays at the determinant clamp flagged as
    hits and as misses, textured and untextured materials: every field of
    the kernel's record is the plain version's, bit for bit."""
    scene = scenes[name]
    geom, o, d, idx, hit = record_case(scene, cull, seed=len(name))
    assert 0 < int(hit.sum()) < len(hit)
    with torch.no_grad():
        det = I.dot3(geom.e1[idx.long()],
                     torch.cross(d, geom.e2[idx.long()], dim=1))
    assert int((det.abs() <= EPS).sum()) >= 8
    if name == "textured":
        assert bool((scene.mat_tex[geom.tri_mat[idx.long()].long()] > 0)
                    .any())
    with profiling.recording() as rec:
        got = I.record_fused(o, d, idx, hit, scene, geom, EPS)
    assert rec.counts["trace.launches"] == 1
    assert rec.counts["trace.fused.grad_calls"] == 0
    assert_same_record(got, I.record_reference(o, d, idx, hit, scene, geom,
                                               EPS))


def test_record_kernel_with_no_ray(scenes, cpu_kernels):
    """A call of no rays launches nothing and returns empty fields of the
    plain version's dtypes and shapes."""
    scene = scenes["textured"]
    geom, o, d, idx, hit = record_case(scene, True)
    with profiling.recording() as rec:
        got = I.record_fused(o[:0], d[:0], idx[:0], hit[:0], scene, geom, EPS)
    assert rec.counts["trace.launches"] == 0
    assert_same_record(got, I.record_reference(o[:0], d[:0], idx[:0],
                                               hit[:0], scene, geom, EPS))


@pytest.mark.parametrize("drop", [(), ("t", "hit_n", "uvs", "ior"),
                                  ("u", "v", "w", "position", "face_n",
                                   "albedo")],
                         ids=["all", "some", "others"])
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["mixed", "textured"])
def test_record_node_gradients_are_the_plain_versions(
        scenes, cpu_kernels, name, cull, drop):
    """`_RecordGrad`'s backward, trace_record_grad and the segmented sums,
    gives o, d and every table the plain version's gradient within the
    float64 yardstick (hits, misses, rays at the determinant clamp, and
    fields that reach no loss, whose gradients come to the backward as
    None), every leaf the plain version reaches gets a gradient (zeros
    where it does not), and the forward's values pass through the node
    unchanged."""
    assert RECORD_LEAVES == ("o", "d", *(k for k, _ in I._TRI_TABLES),
                             *(k for k, _ in I._MAT_TABLES))
    scene = scenes[name]
    geom, o, d, idx, hit = record_case(scene, cull, seed=3 + cull)
    ref = I.record_reference(o, d, idx, hit, scene, geom, EPS)
    gen = torch.Generator().manual_seed(len(drop))
    outs = [None if k in drop else
            torch.randn(getattr(ref, k).shape, generator=gen)
            for k in I._GRAD_FIELDS]
    args = (scene, geom, o, d, idx, hit)
    with profiling.recording() as rec:
        got_rec, got = record_grads(I.record_fused, *args, outs)
    assert rec.counts["trace.fused.grad_calls"] == 1
    assert rec.counts["trace.backward.calls"] == 1
    plain_rec, plain = record_grads(I.record_reference, *args, outs)
    _, exact = record_grads(I.record_reference, *args, outs, torch.float64)
    assert_same_record(got_rec, plain_rec)
    for leaf, g, g_p in zip(RECORD_LEAVES, got, plain):
        # The node writes a table's whole row, so a table the loss does
        # not reach through the given fields gets zeros, not None.
        assert g is not None or g_p is None, leaf
        assert g_p is not None or not bool(g.any()), leaf
        assert g is None or bool(torch.isfinite(g).all()), leaf
    assert sum(g is not None for g in got) >= 8
    for leaf, (gap, allowed) in zip(RECORD_LEAVES, gradient_gaps(got, plain,
                                                          exact)):
        assert gap <= allowed, (leaf, gap, allowed)


def test_record_backward_with_no_gradient_launches_nothing(scenes,
                                                           cpu_kernels):
    """A backward of no incoming gradient, or of no ray, launches nothing
    and gives every input None."""
    scene = scenes["textured"]
    geom, o, d, idx, hit = record_case(scene, False)
    inputs = [o, d, *I._grad_tables(scene, geom)]
    rec = I._Record(idx, hit, geom.tri_mat, geom.tri_mesh, scene.mat_tag,
                    scene.mat_smooth, scene.mat_tex, EPS)
    wanted = (True,) * len(inputs)
    none = [None] * len(I._GRAD_FIELDS)
    with profiling.recording() as counts:
        assert I._record_grad(rec, inputs, none, wanted) == [None] * 10
        empty = rec._replace(idx=idx[:0], hit=hit[:0])
        grads = [torch.ones(0)] * len(I._GRAD_FIELDS)
        assert I._record_grad(empty, [o[:0], d[:0], *inputs[2:]], grads,
                              wanted) == [None] * 10
    assert counts.counts["trace.backward.calls"] == 2
    assert counts.counts["trace.backward.launches"] == 0


def test_record_node_refuses_an_input_changed_in_place(scenes, cpu_kernels):
    """The backward reads the call's inputs as they were at the forward:
    one changed in place in between is refused by autograd's version
    check, not differentiated at its new values."""
    scene = scenes["textured"]
    geom, o, d, idx, hit = record_case(scene, False)
    o = o.clone().requires_grad_()
    albedo = scene.mat_albedo.clone().requires_grad_()
    record = I.record_fused(o, d, idx, hit, scene.replace(mat_albedo=albedo),
                            geom, EPS)
    loss = record.position.sum() + record.albedo.sum()
    with torch.no_grad():
        albedo.mul_(0.5)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        torch.autograd.grad(loss, [o, albedo])


class CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself on CUDA: pins `record_applies`'s
    choice without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case", ["cpu", "cpu_float64", "cuda",
                                  "cuda_float64"])
def test_record_applies_by_device_and_dtype(case):
    """The kernels make the record of float32 CUDA rays; CPU rays of any
    dtype take the plain version; CUDA rays of another dtype are
    refused, not traced by another path."""
    o = torch.zeros((4, 3), dtype=torch.float64 if "64" in case
                    else torch.float32)
    if case.startswith("cuda"):
        o = torch.Tensor._make_subclass(CudaLooking, o)
    if case == "cuda_float64":
        with pytest.raises(ValueError, match="float32"):
            I.record_applies(o)
        return
    assert I.record_applies(o) is (case == "cuda")


def sgd_step(scene, cfg, n):
    params, skeleton = G.split_params(scene)
    target = torch.full((n, 3), 0.1, dtype=scene.vertices.dtype)
    return G.loss_and_grad(params, skeleton, cfg, torch.arange(n), target,
                           SeededUniforms(8, 0))


@pytest.mark.parametrize("mode,gi", [("roulette", 1), ("split", 0)])
def test_sgd_step_through_the_fused_record_has_the_plain_gradients(
        scenes, monkeypatch, cpu_kernels, mode, gi):
    """A whole SGD step with every trace call's record made by the
    kernels' CPU build: each call goes through `_RecordGrad` and its
    backward, none through a `GatherRows` node (the step's gather
    backward calls fall by the plain record's), the loss is
    the plain step's bit for bit, the same parameters get a gradient, and
    every parameter's gradient is within the float64 yardstick of a
    plain step's."""
    scene = scenes["mixed"]
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode=mode, intersector="jnp",
                         diffuse_reflection_ray_count=gi)
    n = 12 * 16 * 2
    with profiling.recording() as plain_rec:
        loss_p, grads_p = sgd_step(scene, cfg, n)
    _, grads_64 = sgd_step(scene.map(lambda t: t.double()
                                     if t.is_floating_point() else t), cfg, n)
    with monkeypatch.context() as patch:
        patch.setattr(I, "gather_rows", lambda table, idx: table[idx])
        with profiling.recording() as untraced:
            sgd_step(scene, cfg, n)
    monkeypatch.setattr(I, "record_applies", lambda o: True)
    with profiling.recording() as rec:
        loss, grads = sgd_step(scene, cfg, n)
    calls = rec.spans["trace"][0]
    assert calls == plain_rec.spans["trace"][0] > 0
    assert plain_rec.counts["trace.plain.calls"] == calls
    assert rec.counts["trace.plain.calls"] == 0
    assert rec.counts["trace.fused.calls"] == calls
    assert rec.counts["trace.launches"] == calls
    # The cutoff's record, of which only the mask is read, is made
    # outside autograd; every other call's goes through the node.
    grad_calls = rec.counts["trace.fused.grad_calls"]
    assert grad_calls == calls - 1
    assert rec.counts["trace.backward.calls"] == grad_calls
    assert rec.counts["trace.backward.launches"] == grad_calls
    # No gather's backward comes from trace: the fused step makes those of
    # a plain step whose record gathers by plain indexing.
    assert (rec.counts["gather.backward.calls"]
            == untraced.counts["gather.backward.calls"]
            < plain_rec.counts["gather.backward.calls"])
    assert torch.equal(loss, loss_p)
    names = G.DIFF_PARAM_NAMES
    for k in names:
        assert bool(grads[k].any()) == bool(grads_p[k].any()), k
    for k, (gap, allowed) in zip(names, gradient_gaps(
            [grads[k] for k in names], [grads_p[k] for k in names],
            [grads_64[k] for k in names])):
        assert gap <= allowed, (k, gap, allowed)


def test_cpu_frames_trace_through_the_plain_record(scenes, monkeypatch):
    """A CPU frame makes every record with the plain version, counted as
    `trace.plain.calls`, and never asks for the kernel library; off, no
    counter moves."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernels, "library", refuse)
    cfg = T.RenderConfig(max_ray_depth=2, bounce_mode="split",
                         diffuse_reflection_ray_count=1, chunk_size=64)
    scene = scenes["mixed"]
    with profiling.recording() as rec:
        img = T.render_frame(scene, cfg, device="cpu")
    assert bool(torch.isfinite(img).all())
    calls = rec.spans["trace"][0]
    assert calls > 0 and rec.counts["trace.plain.calls"] == calls
    for name in ("trace.fused.calls", "trace.fused.rows",
                 "trace.fused.grad_calls", "trace.launches",
                 "trace.backward.calls"):
        assert rec.counts[name] == 0, name
    before = profiling.record()["counts"].get("trace.plain.calls", 0)
    T.render_frame(scene.replace(height=4, width=4), cfg, device="cpu")
    assert profiling.record()["counts"].get("trace.plain.calls", 0) == before
