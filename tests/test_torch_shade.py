"""PyTorch port: which path `ops/shade.py::shade` takes, on the CPU.

`shade` runs the kernels of csrc/shade.cu (`shade_fused`) on CUDA
tensors, which must be float32, and the plain torch version
`shade_reference` on CPU tensors.  Where a gradient is wanted the kernels'
last two launches run as an autograd node whose backward differentiates
the plain version recomputed from the call's own occlusion.  Here the CPU
path is held to the plain version bit for bit, the choice is pinned for
the device, the dtype and the gradient, the node's backward is held to
the plain version's gradients (its forward stood in for by the plain
version), and the counters are read.  The kernels are held against the
plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import shade as S
from simd_raytracer_tpu_torch.ops.intersect import HitRecord
from simd_raytracer_tpu_torch.utils import profiling
from torch_scenes import SeededUniforms, mixed_doc, shade_rows

torch.set_num_threads(2)

EXTRA = ("d_in", "weight", "rnd_coin", "rnd_gi")


@pytest.fixture(scope="module")
def small():
    return T.parse_scene_dict(mixed_doc(12, 16, g=8, subdiv=2))


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


@pytest.mark.parametrize("mode,gi,lights", [("split", 0, 1),
                                            ("split", 2, 3),
                                            ("roulette", 1, 1),
                                            ("roulette", 3, 3)])
def test_bounce_node_gradients_are_the_plain_versions(small, monkeypatch,
                                                      mode, gi, lights):
    """`_BounceGrad`'s backward, which recomputes the plain version from
    the call's `need` and `occ` and differentiates it, gives every input
    the plain version's gradient bit for bit, and the forward's values
    pass through unchanged."""
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=gi,
                         intersector="jnp")
    geom = T.derive_geometry(small)
    gen = torch.Generator().manual_seed(lights)
    scene = small.replace(
        light_pos=torch.rand((lights, 3), generator=gen) * 4 - 2,
        light_intensity=torch.rand(lights, generator=gen) * 50 + 10)
    hit, d_in, weight, coin, rnd_gi = call_args(scene, 400, gi,
                                                mode == "roulette", seed=gi)
    need = S.need_rows(hit, weight)
    occ = torch.rand(lights * need.numel(), generator=gen) < 0.3
    outs = torch.randn((400, 3), generator=gen), torch.randn(
        (400 * cfg.child_slots, 3), generator=gen)

    def run(through_node):
        inputs = [None if t is None or t.dtype == torch.bool else
                  t.detach().clone().requires_grad_()
                  for t in S._grad_inputs(scene, hit, d_in, weight, coin,
                                          rnd_gi)]
        nh = len(S._GRAD_HIT)
        h = hit.replace(**dict(zip(S._GRAD_HIT, inputs[:nh])))
        sc = scene.replace(**dict(zip(S._GRAD_SCENE, inputs[nh + 4:])))
        args = (sc, geom, h, *inputs[nh:nh + 2], cfg, None,
                *inputs[nh + 2:nh + 4])
        if through_node:
            call = S._Call(*args, need, occ, None)
            contrib, *children = S._BounceGrad.apply(call, *inputs)
        else:
            contrib, children = S.shade_reference(*args, lights=(need, occ))
        loss = ((contrib * outs[0]).sum() + (children[0] * outs[1]).sum()
                + (children[1] * outs[1]).sum() + children[2].sum())
        got = torch.autograd.grad(loss, [t for t in inputs if t is not None],
                                  allow_unused=True)
        return [contrib, *children], got

    (vals, grads), (vals_p, grads_p) = run(True), run(False)
    for a, b in zip(vals, vals_p):
        assert torch.equal(a, b)
    assert sum(g is not None for g in grads_p) >= 10
    for g, g_p in zip(grads, grads_p):
        assert (g is None) == (g_p is None)
        if g is not None:
            assert torch.equal(g, g_p)


def plain_shadow(scene, geom, hit, cfg, accel, need):
    """The kernels' `_shadow` stood in for by the plain version's own
    shadow rays and occlusion query: (occ, None)."""
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
    return seen[0], None


@pytest.mark.parametrize("mode,gi", [("roulette", 1), ("split", 1),
                                     ("split", 0)])
def test_sgd_step_through_the_fused_path_has_the_plain_gradients(
        small, monkeypatch, mode, gi):
    """A whole SGD step with every shade call taken by `shade_fused` (its
    two kernel stages stood in for by the plain version): each call goes
    through the autograd node, and the loss and every parameter's
    gradient are the plain version's bit for bit."""
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode=mode, intersector="jnp",
                         diffuse_reflection_ray_count=gi)
    n = 12 * 16 * 2

    def step():
        params, skeleton = G.split_params(small)
        return G.loss_and_grad(params, skeleton, cfg, torch.arange(n),
                               torch.full((n, 3), 0.1), SeededUniforms(8, 0))

    loss_p, grads_p = step()
    monkeypatch.setattr(S, "fused_applies", lambda weight: True)
    monkeypatch.setattr(S, "_shadow", plain_shadow)
    monkeypatch.setattr(S, "_bounce", plain_bounce)
    with profiling.recording() as rec:
        loss, grads = step()
    assert rec.counts["shade.fused.grad_calls"] == rec.spans["shade"][0] > 0
    assert rec.counts["shade.plain.calls"] == 0
    assert torch.equal(loss, loss_p)
    for k in G.DIFF_PARAM_NAMES:
        assert torch.equal(grads[k], grads_p[k]), k


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
