"""PyTorch port: the sweep refitted to each frame's or step's vertices
(RenderConfig.accel_refit, accel/sweep.py::refit_sweep, bound in
ops/intersect_sweep.py::bind), held against the build and against the
brute-force select on the moved triangles, in plain torch on the CPU.

The frozen sweep, JAX's route, keeps its parity tests in
tests/test_torch_grad.py."""

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch.accel.sweep import (build_sweep_for_scene,
                                                  refit_sweep)
from simd_raytracer_tpu_torch.models.scene import derive_geometry
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops.intersect import make_select_fn
from simd_raytracer_tpu_torch.ops.render import build_accel, render_chunk
from simd_raytracer_tpu_torch.utils import profiling
from torch_scenes import SeededUniforms, mixed_doc

torch.set_num_threads(2)

H, W = 12, 16
EPS = 1e-6


@pytest.fixture(scope="module")
def scene():
    """The float32 mixed scene: every material kind, 896 triangle slots
    in 4 Morton slices."""
    return T.parse_scene_dict(mixed_doc(H, W, g=8, subdiv=2))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _moved(scene, seed=0):
    """The scene with seeded noise on every vertex and the vertices right
    of x = 0 moved by (0.7, 0.3, -0.4): the slices there leave their
    built boxes."""
    rng = np.random.default_rng(seed)
    v = scene.vertices
    shift = torch.where(v[:, :1] > 0.0, torch.tensor([0.7, 0.3, -0.4]),
                        torch.zeros(3))
    noise = torch.from_numpy(rng.normal(0.0, 0.02, v.shape).astype(
        np.float32))
    return scene.replace(vertices=v + shift + noise)


def _rays(scene, n=1536, seed=1):
    """Rays from the camera and from random points inside the room."""
    rng = np.random.default_rng(seed)
    lo = scene.vertices.amin(dim=0).numpy()
    hi = scene.vertices.amax(dim=0).numpy()
    o = np.concatenate([
        np.tile(scene.cam_pos.numpy(), (n // 2, 1)),
        rng.uniform(lo, hi, (n - n // 2, 3))]).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 1.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.5, 6.0, n).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)


@pytest.mark.parametrize("partition", ["morton", "kdleaf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refit_at_the_built_vertices_gives_the_build(scene, dtype,
                                                     partition):
    """At the vertices the build read, the refit's tables are the build's,
    bit for bit: the corners are cast to float32 before the edges."""
    s = scene.map(lambda t: t.to(dtype) if t.is_floating_point() else t)
    built = build_sweep_for_scene(s, partition=partition)
    got = refit_sweep(built, s.vertices, s.tri_vidx)
    assert torch.equal(_bits(got.tri_soa), _bits(built.tri_soa))
    assert torch.equal(_bits(got.aabb), _bits(built.aabb))
    assert torch.equal(got.tri_ids, built.tri_ids)
    assert got.tri_soa.dtype == torch.float32


def test_refit_of_moved_vertices_gives_their_build(scene):
    """On moved vertices the refit keeps the build's members and gets the
    tables a build on those vertices would give them; some slices leave
    the boxes they were built with."""
    built = build_sweep_for_scene(scene)
    moved = _moved(scene)
    got = refit_sweep(built, moved.vertices, moved.tri_vidx)
    assert torch.equal(got.tri_ids, built.tri_ids)
    corners = moved.vertices[moved.tri_vidx.long()]
    ids = built.tri_ids.long()
    for s in range(built.num_slices):
        members = ids[s][ids[s] >= 0]
        c = corners[members]
        assert torch.equal(got.aabb[s, 0:3], c.amin(dim=(0, 1)))
        assert torch.equal(got.aabb[s, 3:6], c.amax(dim=(0, 1)))
        n = members.numel()
        assert torch.equal(got.tri_soa[s, 0:3, :n], c[:, 0].T)
        assert torch.equal(got.tri_soa[s, 3:6, :n], (c[:, 1] - c[:, 0]).T)
        assert not got.tri_soa[s, :, n:].any()
    outside = ((got.aabb[:, 0:3] < built.aabb[:, 0:3])
               | (got.aabb[:, 3:6] > built.aabb[:, 3:6])).any(dim=1)
    assert outside.all()


def test_an_empty_slice_keeps_its_inverted_box(scene):
    built = build_sweep_for_scene(scene)
    empty = built.replace(
        tri_ids=torch.cat([built.tri_ids, torch.full_like(
            built.tri_ids[:1], -1)]),
        tri_soa=torch.cat([built.tri_soa, torch.zeros_like(
            built.tri_soa[:1])]),
        aabb=torch.cat([built.aabb, torch.tensor(
            [[1.0, 1.0, 1.0, -1.0, -1.0, -1.0, 0.0, 0.0]])]))
    got = refit_sweep(empty, scene.vertices, scene.tri_vidx)
    assert torch.equal(got.aabb[-1], empty.aabb[-1])
    assert not got.tri_soa[-1].any()


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_refitted_sweep_winners_equal_brute_force_on_moved_vertices(
        scene, any_hit, windowed):
    """The select bound on the moved geometry: the refitted sweep's
    winners and hit flags are the brute-force select's on the moved
    triangles; the frozen sweep's are not."""
    built = build_sweep_for_scene(scene)
    g = derive_geometry(_moved(scene))
    o, d, tmax = _rays(scene)
    args = (o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid,
            tmax if windowed else None, any_hit)
    want_i, want_h = make_select_fn("jnp", geom=g)(*args)
    got_i, got_h = make_select_fn("sweep", built.replace(refit=True),
                                  g)(*args)
    assert torch.equal(got_h, want_h)
    if not any_hit:
        assert torch.equal(got_i[got_h], want_i[want_h])
    assert 0.1 < float(want_h.float().mean()) < 0.95
    frozen_i, frozen_h = make_select_fn("sweep", built, g)(*args)
    assert not (torch.equal(frozen_h, want_h)
                and torch.equal(frozen_i[frozen_h], want_i[want_h]))


def _steps(scene, lr, **render):
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=H * W * 2,
                         bounce_mode="roulette", samples_per_pixel=2,
                         diffuse_reflection_ray_count=1, **render)
    params, skeleton = G.split_params(scene)
    n = H * W * 2
    return G.train_steps(params, skeleton, cfg,
                         torch.arange(n, dtype=torch.int32),
                         torch.full((n, 3), 0.1),
                         lambda i: SeededUniforms(5, i), lr=lr, n_steps=3,
                         accel=build_accel(scene, cfg))


def test_train_steps_through_the_refitted_sweep_equal_brute_force(scene):
    """Three SGD steps at a large rate: through the refitted sweep the
    losses and parameters are the brute-force route's; through the frozen
    sweep they are not, so the test sees the refit."""
    want_p, want_l = _steps(scene, 0.2)
    got_p, got_l = _steps(scene, 0.2, intersector="sweep", accel_refit=True)
    frozen_p, frozen_l = _steps(scene, 0.2, intersector="sweep")
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-6)
    for k in G.DIFF_PARAM_NAMES:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert not np.allclose(frozen_l.numpy(), want_l.numpy(), rtol=1e-3)
    assert not np.allclose(frozen_p["vertices"].numpy(),
                           want_p["vertices"].numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("intersector", ["jnp", "pallas", "fast", "mxu"])
def test_accel_refit_with_another_intersector_is_refused(intersector):
    with pytest.raises(ValueError, match="refit"):
        T.RenderConfig(accel_refit=True, intersector=intersector)


def test_accel_refit_refuses_an_accel_not_marked_for_it(scene):
    """accel_refit with a sweep that is not marked to be refitted (one
    built without the configuration) is refused, not run frozen."""
    cfg = T.RenderConfig(intersector="sweep", accel_refit=True,
                         max_ray_depth=1, chunk_size=32)
    assert build_accel(scene, cfg).refit
    assert not build_accel(scene, T.RenderConfig(intersector="sweep")).refit
    with pytest.raises(ValueError, match="accel_refit"):
        render_chunk(scene, derive_geometry(scene), cfg,
                     torch.arange(32, dtype=torch.int32),
                     SeededUniforms(0, 0), build_sweep_for_scene(scene))
    with pytest.raises(ValueError, match="geometry"):
        make_select_fn("sweep", build_accel(scene, cfg))


def _bind_and_select(scene):
    g = derive_geometry(_moved(scene))
    o, d, _ = _rays(scene, n=700)
    select = make_select_fn("sweep", build_sweep_for_scene(scene).replace(
        refit=True), g)
    select(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid)
    select(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, None, True)


def test_refit_records_its_span_and_counters_while_recording(scene):
    """One refit a binding (span `refit`, `sweep.refit.calls` and
    `.slices`); each select counts 2 tiles x 4 slices and the pairs the
    reach test kept.  Outside recording() nothing is recorded."""
    profiling.reset()
    _bind_and_select(scene)
    assert profiling.record() == {"spans": {}, "counts": {}}
    with profiling.recording() as rec:
        _bind_and_select(scene)
    data = rec.read()
    assert data["spans"]["refit"]["calls"] == 1
    counts = data["counts"]
    assert counts["sweep.refit.calls"] == 1
    assert counts["sweep.refit.slices"] == 4
    assert counts["sweep.tiles_x_slices"] == 2 * (2 * 4)
    assert 0 < counts["sweep.reached"] <= counts["sweep.tiles_x_slices"]
    profiling.reset()
