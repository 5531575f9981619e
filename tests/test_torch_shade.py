"""PyTorch port: which path `ops/shade.py::shade` takes, on the CPU.

`shade` runs the kernels of csrc/shade.cu (`shade_fused`) on CUDA
tensors, which must be float32, and the plain torch version
`shade_reference` on CPU tensors.  Where a gradient is wanted the kernels'
last launch runs as an autograd node whose backward is csrc/shade_grad.cu
from the call's own rows, occlusion and factor.  Here the CPU path is held
to the plain version bit for bit, the choice is pinned for the device, the
dtype and the gradient, the node's backward (the shading kernels built for
the CPU by `cuda_on_cpu`; its forward stood in for by the plain version)
is held to the plain version's gradients by the float64 yardstick
(`yardstick.gradient_gaps`), and the counters are read.  The kernels are
held against the plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import shade as S
from simd_raytracer_tpu_torch.ops.intersect import HitRecord
from simd_raytracer_tpu_torch.utils import profiling
import cuda_on_cpu
from simd_raytracer_tpu_torch.models.scene import build_scene
from torch_scenes import (SeededUniforms, bitmap_scene_kwargs, mixed_doc,
                          shade_rows)
from yardstick import gradient_gaps, leaf_grads, shade_grads, shade_loss

torch.set_num_threads(2)

EXTRA = ("d_in", "weight", "rnd_coin", "rnd_gi")


@pytest.fixture(scope="module")
def small():
    return T.parse_scene_dict(mixed_doc(12, 16, g=8, subdiv=2))


@pytest.fixture(scope="module")
def textured():
    """The four-texture scene (albedo, edges, checker, bitmap)."""
    return build_scene(**bitmap_scene_kwargs(32, 32))


@pytest.fixture(scope="module")
def cpu_library(tmp_path_factory):
    return cuda_on_cpu.build(str(tmp_path_factory.mktemp("shade_cpu")))


@pytest.fixture
def cpu_kernels(monkeypatch, cpu_library):
    """The shading kernels' CPU build as `kernels.library()`, launched on
    CPU tensors (no stream)."""
    monkeypatch.setattr(kernels, "library", lambda: cpu_library)
    monkeypatch.setattr(kernels, "stream", lambda device: None)


def assert_near_plain(got, plain, exact, names=None):
    """Each leaf's gradient within the float64 yardstick."""
    for i, (gap, allowed) in enumerate(gradient_gaps(got, plain, exact)):
        assert gap <= allowed, (names[i] if names else i, gap, allowed)


def call_args(scene, n, gi, roulette, seed=0, dtype=torch.float32):
    """(hit, d_in, weight, rnd_coin, rnd_gi) of `shade_rows` as CPU
    tensors, floats in `dtype`."""
    rows = shade_rows(n, seed, int(scene.tex_tag.shape[0]), gi,
                      scene.vertices.min(0).values.numpy(),
                      scene.vertices.max(0).values.numpy())
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    t = {k: v.to(dtype) if v.is_floating_point() else v for k, v in t.items()}
    d_in, weight, coin, rnd_gi = (t.pop(k) for k in EXTRA)
    return (HitRecord(**t), d_in, weight, coin if roulette else None,
            rnd_gi if gi > 0 else None)


class CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself on CUDA: pins `fused_applies`'s
    and `wants_grad`'s choice without a card."""

    @property
    def is_cuda(self):
        return True


def cuda_looking(t):
    return torch.Tensor._make_subclass(CudaLooking, t, t.requires_grad)


@pytest.mark.parametrize("mode", ["split", "roulette"])
@pytest.mark.parametrize("gi", [0, 2])
def test_cpu_shade_is_the_plain_version(small, mode, gi):
    """On CPU tensors `shade` is `shade_reference`, bit for bit, and never
    loads the kernel library."""
    geom = T.derive_geometry(small)
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=gi,
                         intersector="jnp")
    hit, d_in, weight, coin, rnd_gi = call_args(small, 300, gi,
                                                mode == "roulette")
    args = (small, geom, hit, d_in, weight, cfg, None, coin, rnd_gi)
    got = S.shade(*args)
    ref = S.shade_reference(*args)
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["cpu", "cpu_float64", "cuda_float64",
                                  "cuda_grad_wanted", "cuda_grad_off",
                                  "cuda_no_grad_input", "cuda_table_grad"])
def test_fused_applies_by_device_dtype_and_gradient(small, case):
    """The kernels run on every CUDA call and refuse a dtype other than
    float32 there; the call goes through the autograd node where a
    gradient is wanted: grad mode on, and some input of the call (the hit
    record, d_in, weight, the uniforms, the scene's texture and light
    tables) requires grad."""
    dtype = torch.float64 if "float64" in case else torch.float32
    scene = small.map(lambda t: t.to(dtype) if t.is_floating_point()
                      else t)
    hit, d_in, weight, coin, rnd_gi = call_args(scene, 50, 1, True,
                                                dtype=dtype)
    if case.startswith("cuda"):
        weight = cuda_looking(weight)
    if case in ("cuda_grad_wanted", "cuda_grad_off"):
        hit = hit.replace(albedo=hit.albedo.requires_grad_())
    if case == "cuda_table_grad":
        scene = scene.replace(atlas=scene.atlas.clone().requires_grad_())
    if case == "cuda_float64":
        with pytest.raises(ValueError, match="float32"):
            S.fused_applies(weight)
        return
    assert S.fused_applies(weight) is case.startswith("cuda")
    grad = case in ("cuda_grad_wanted", "cuda_table_grad")
    with torch.set_grad_enabled(case != "cuda_grad_off"):
        assert S.wants_grad(scene, hit, d_in, weight, coin, rnd_gi) is grad


def plain_bounce(call):
    """The kernels' `_bounce` stood in for by the plain version from the
    call's own occlusion, without gradients."""
    with torch.no_grad():
        return S.shade_reference(*call[:9], lights=(call.need, call.occ))


def plain_factor(scene, geom, hit, cfg, need, occ):
    """The summed light factor of every row as the plain version makes it
    (zero where a row needs no light), or None where no row does."""
    if not need.numel():
        return None
    with torch.no_grad():
        return torch.zeros_like(hit.u).index_put(
            (need,), S.direct_light_factor(
                scene, geom, hit.map(lambda a: a[need]), cfg, None, occ))


def node_case(scene, mode, gi, lights, n, lit=True):
    """A shade call's arguments over `shade_rows` on `scene` with `lights`
    random lights, its `need`, a random light-major occlusion, and random
    gradients for contrib and the children's origins, directions and
    weights; with lit False no row is diffuse or textured."""
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=gi,
                         intersector="jnp")
    gen = torch.Generator().manual_seed(lights)
    scene = scene.replace(
        light_pos=torch.rand((lights, 3), generator=gen) * 4 - 2,
        light_intensity=torch.rand(lights, generator=gen) * 50 + 10)
    hit, d_in, weight, coin, rnd_gi = call_args(scene, n, gi,
                                                mode == "roulette", seed=gi)
    if not lit:
        hit = hit.replace(mat_tag=torch.from_numpy(
            np.random.default_rng(gi).integers(1, 4, n).astype(np.int32)))
    need = S.need_rows(hit, weight)
    occ = torch.rand(lights * need.numel(), generator=gen) < 0.3
    k = cfg.child_slots
    outs = [torch.randn(shape, generator=gen)
            for shape in ((n, 3), (n * k, 3), (n * k, 3), (n * k,))]
    return (scene, hit, d_in, weight, coin, rnd_gi), cfg, need, occ, outs


def node_fn(need, occ):
    """A shade function that runs `_BounceGrad` on its arguments with the
    given `need` and occlusion."""
    def node(sc, geom, h, d_in, weight, cfg, accel, coin, rnd_gi):
        call = S._Call(sc, geom, h, d_in, weight, cfg, accel, coin, rnd_gi,
                       need, occ if need.numel() else None,
                       plain_factor(sc, geom, h, cfg, need, occ))
        contrib, *children = S._BounceGrad.apply(call, *S._grad_inputs(
            sc, h, d_in, weight, coin, rnd_gi))
        return contrib, children

    return node


def node_args(case, geom):
    """`shade`'s arguments of a `node_case`."""
    (scene, hit, d_in, weight, coin, rnd_gi), cfg = case[:2]
    return scene, geom, hit, d_in, weight, cfg, None, coin, rnd_gi


def run_node(case, geom, through_node, dtype=torch.float32):
    """(values, gradients of every `_grad_inputs` leaf, None where it has
    none or is not a float) of one shade call: through `_BounceGrad`, or
    the plain version differentiated by autograd, in `dtype`."""
    _, _, need, occ, outs = case

    def plain(*args):
        return S.shade_reference(*args, lights=(need, occ))

    return shade_grads(node_fn(need, occ) if through_node else plain,
                       node_args(case, geom), outs, dtype)


def test_bounce_node_refuses_an_input_changed_in_place(
        textured, monkeypatch, cpu_kernels):
    """The backward reads the call's inputs as they were at the forward:
    one changed in place in between is refused by autograd's version
    check, not differentiated at its new values."""
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    geom = T.derive_geometry(textured)
    case = node_case(textured, "roulette", 1, 1, 50)
    _, loss, leaves = shade_loss(node_fn(*case[2:4]), node_args(case, geom),
                                 case[4])
    with torch.no_grad():
        leaves[S._GRAD_HIT.index("albedo")].mul_(0.5)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        leaf_grads(loss, leaves)


GRAD_NAMES = (*S._GRAD_HIT, "d_in", "weight", "rnd_coin", "rnd_gi",
              *S._GRAD_SCENE)


@pytest.mark.parametrize("mode,gi,lights", [("split", 0, 1),
                                            ("split", 2, 3),
                                            ("roulette", 1, 1),
                                            ("roulette", 3, 3),
                                            ("split", 1, 2),
                                            ("roulette", 0, 2),
                                            ("roulette", 2, 2)])
def test_bounce_node_gradients_are_the_plain_versions(
        textured, monkeypatch, cpu_kernels, mode, gi, lights):
    """`_BounceGrad`'s backward, csrc/shade_grad.cu from the call's own
    `need`, `occ` and factor, gives every input the plain version's
    gradient within the float64 yardstick (every material tag, every
    texture kind, TIR, misses and dead rows), the same inputs get a
    gradient, and the forward's values pass through unchanged."""
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    geom = T.derive_geometry(textured)
    case = node_case(textured, mode, gi, lights, 400)
    (vals, grads), (vals_p, grads_p) = (run_node(case, geom, True),
                                        run_node(case, geom, False))
    _, grads_64 = run_node(case, geom, False, torch.float64)
    for a, b in zip(vals, vals_p):
        assert torch.equal(a, b)
    assert sum(g is not None for g in grads_p) >= 10
    for g, g_p in zip(grads, grads_p):
        assert (g is None) == (g_p is None)
    assert_near_plain(grads, grads_p, grads_64, GRAD_NAMES)


@pytest.mark.parametrize("case", ["lit", "unlit", "empty"])
def test_bounce_node_backward_counts_its_launches(
        textured, monkeypatch, cpu_kernels, case):
    """One backward call, its rows, and its own launches on the CPU
    build: shade_bounce_grad, and shade_lights_grad where a row needs
    light (the tables' segmented sums launch only on the card); none for
    no row, where every gradient is None.  The gradients stay within the
    yardstick where no row needs light."""
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    geom = T.derive_geometry(textured)
    n = 0 if case == "empty" else 300
    c = node_case(textured, "split", 1, 2, n, lit=case != "unlit")
    with profiling.recording() as rec:
        _, grads = run_node(c, geom, True)
    need = c[2].numel()
    assert (need > 0) is (case == "lit")
    assert rec.counts["shade.backward.calls"] == 1
    assert rec.counts["shade.backward.rows"] == n
    assert rec.counts["shade.backward.launches"] == (
        {"lit": 2, "unlit": 1, "empty": 0}[case])
    assert rec.counts["shade.launches"] == 0
    if case == "empty":
        assert all(g is None for g in grads)
        return
    _, grads_p = run_node(c, geom, False)
    _, grads_64 = run_node(c, geom, False, torch.float64)
    assert_near_plain(grads, grads_p, grads_64, GRAD_NAMES)


def test_bounce_node_backward_recomputes_no_torch_shading(
        textured, monkeypatch, cpu_kernels):
    """The node's backward runs the kernels alone: with the plain version
    and nested autograd refused once the forward is done, the gradients
    still come, and match the node's own in an unrestricted run."""
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    geom = T.derive_geometry(textured)
    case = node_case(textured, "roulette", 1, 1, 200)
    _, want = run_node(case, geom, True)
    real_bounce = S._bounce

    def forward_then_refuse(call):
        out = real_bounce(call)

        def refuse(*args, **kwargs):
            raise AssertionError("the backward recomputed the plain shading")

        monkeypatch.setattr(S, "shade_reference", refuse)
        return out

    monkeypatch.setattr(S, "_bounce", forward_then_refuse)
    _, got = run_node(case, geom, True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def plain_shadow(scene, geom, hit, cfg, accel, need):
    """The kernels' `_shadow` stood in for by the plain version's own
    shadow rays, occlusion query and light factor: (occ, factor)."""
    if not need.numel():
        return None, None
    seen, query = [], S.occluded

    def keep(*args):
        seen.append(query(*args))
        return seen[-1]

    with torch.no_grad():
        S.occluded = keep
        try:
            S.direct_light_factor(scene, geom, hit.map(lambda a: a[need]),
                                  cfg, accel)
        finally:
            S.occluded = query
    return seen[0], plain_factor(scene, geom, hit, cfg, need, seen[0])


@pytest.mark.parametrize("mode,gi", [("roulette", 1), ("split", 1),
                                     ("split", 0)])
def test_sgd_step_through_the_fused_path_has_the_plain_gradients(
        small, monkeypatch, cpu_kernels, mode, gi):
    """A whole SGD step with every shade call taken by `shade_fused` (its
    forward kernel stages stood in for by the plain version, its backward
    the kernels' CPU build): each call goes through the autograd node and
    its backward, the loss is the plain version's bit for bit, the same
    parameters get a gradient, and every parameter's gradient is within
    the float64 yardstick of a plain step's."""
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode=mode, intersector="jnp",
                         diffuse_reflection_ray_count=gi)
    n = 12 * 16 * 2

    def step(scene):
        params, skeleton = G.split_params(scene)
        target = torch.full((n, 3), 0.1, dtype=scene.vertices.dtype)
        return G.loss_and_grad(params, skeleton, cfg, torch.arange(n),
                               target, SeededUniforms(8, 0))

    loss_p, grads_p = step(small)
    _, grads_64 = step(small.map(lambda t: t.double()
                                 if t.is_floating_point() else t))
    monkeypatch.setattr(S, "fused_applies", lambda weight: True)
    monkeypatch.setattr(S, "_shadow", plain_shadow)
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    with profiling.recording() as rec:
        loss, grads = step(small)
    calls = rec.spans["shade"][0]
    assert rec.counts["shade.fused.grad_calls"] == calls > 0
    assert rec.counts["shade.backward.calls"] == calls
    assert rec.counts["shade.plain.calls"] == 0
    assert torch.equal(loss, loss_p)
    names = G.DIFF_PARAM_NAMES
    for k in names:
        assert bool(grads[k].any()) == bool(grads_p[k].any()), k
    assert_near_plain([grads[k] for k in names], [grads_p[k] for k in names],
                      [grads_64[k] for k in names], names)


def test_cpu_frames_and_steps_never_load_the_kernel_library(small,
                                                            monkeypatch):
    """A CPU frame and a CPU SGD step shade through the plain version:
    the kernel library (nvcc, ctypes) is never asked for."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernels, "library", refuse)
    cfg = T.RenderConfig(max_ray_depth=2, bounce_mode="roulette",
                         diffuse_reflection_ray_count=1)
    img = T.render_frame(small, cfg, device="cpu")
    assert bool(torch.isfinite(img).all())
    params, skeleton = G.split_params(small)
    n = 12 * 16
    loss, _ = G.loss_and_grad(params, skeleton, cfg, torch.arange(n),
                              torch.full((n, 3), 0.1), SeededUniforms(8, 0))
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("path", ["frame", "train"])
def test_counters_under_recording_on_the_cpu(small, path):
    """While tracing, every CPU shade call counts `shade.plain.calls`, and
    the fused counters read 0; off, nothing is counted."""
    cfg = T.RenderConfig(max_ray_depth=3, bounce_mode="split",
                         diffuse_reflection_ray_count=1, chunk_size=64)
    with profiling.recording() as rec:
        if path == "frame":
            T.render_frame(small, cfg, device="cpu")
        else:
            params, skeleton = G.split_params(small)
            n = 12 * 16
            G.loss_and_grad(params, skeleton, cfg, torch.arange(n),
                            torch.full((n, 3), 0.1), SeededUniforms(8, 0))
    calls = rec.spans["shade"][0]
    assert calls > 0
    assert rec.counts["shade.plain.calls"] == calls
    assert rec.counts["shade.fused.calls"] == 0
    assert rec.counts["shade.fused.rows"] == 0
    assert rec.counts["shade.launches"] == 0
    assert rec.counts["shade.backward.calls"] == 0
    before = profiling.record()["counts"].get("shade.plain.calls", 0)
    T.render_frame(small.replace(height=4, width=4), cfg, device="cpu")
    assert profiling.record()["counts"].get("shade.plain.calls",
                                            0) == before


def test_shade_rows_cover_every_tag_and_texture(small):
    """The random calls the kernel tests draw reach every material tag,
    every texture of the scene, negative and out-of-range UVs, misses and
    dead rays."""
    rows = shade_rows(2000, 1, 4, 2, np.zeros(3), np.ones(3))
    assert set(rows["mat_tag"].tolist()) == {0, 1, 2, 3, 4}
    assert set(rows["tex"].tolist()) == {0, 1, 2, 3}
    assert rows["uvs"].min() < -1 and rows["uvs"].max() > 2
    assert 0 < rows["mask"].sum() < 2000
    assert (rows["weight"] == 0).any()
    assert rows["rnd_gi"].shape == (2000, 2, 2)
