"""PyTorch port on a CUDA device: each hand-written kernel against its plain
torch version on the same CUDA tensors, and small renders, gradients and
march occlusion on CUDA against the same on the CPU.

Every test carries the `cuda` marker and skips without a card.  On a GPU
machine, from the repository root:

    python -m pytest tests/test_torch_cuda.py

This file imports no JAX; where JAX is not installed, add `--noconftest`
(tests/conftest.py imports it).
"""

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.accel.build import build_kdtree_for_scene
from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
from simd_raytracer_tpu_torch.accel.traverse import kd_select
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import (intersect_brute, intersect_kd,
                                          intersect_sweep)
from simd_raytracer_tpu_torch.ops.intersect import make_select_fn
from simd_raytracer_tpu_torch.ops.shade import occluded
from torch_scenes import SeededUniforms, mixed_doc

pytestmark = pytest.mark.cuda

EPS = 1e-6
DEV = "cuda"


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = T.parse_scene_dict(mixed_doc(48, 48, g=16, subdiv=2)).to(DEV)
    return s, T.derive_geometry(s), build_sweep_for_scene(s).to(DEV)


def rays(scene_cam, n, seed):
    """Random rays around the camera with per-ray windows in [0, 25]."""
    rng = np.random.default_rng(seed)
    o = np.asarray(scene_cam.cpu(), np.float32) + rng.normal(
        scale=2.0, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.0, 25.0, n)
    return tuple(torch.tensor(x, dtype=torch.float32, device=DEV)
                 for x in (o, d, tmax))


def assert_equal(got, ref):
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_mt_select_kernel_matches_plain(scene, cull, masked, windowed,
                                        any_hit):
    s, g, _ = scene
    o, d, tmax = rays(s.cam_pos, 3000, seed=1)
    mask = g.tri_valid & ~g.tri_transmissive if masked else g.tri_valid
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, mask,
            tmax if windowed else None, any_hit)
    before = intersect_brute.LAUNCHES
    got = intersect_brute.mt_select_brute(*args)
    assert intersect_brute.LAUNCHES == before + 1
    assert_equal(got, intersect_brute.mt_select_reference(*args))
    assert 0 < int(got[1].sum()) < len(o)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_kernel_matches_plain(scene, cull, windowed, any_hit):
    s, g, sweep = scene
    o, d, tmax = rays(s.cam_pos, 3000, seed=2)
    solid = g.tri_valid & ~g.tri_transmissive
    args = intersect_sweep.prepare_sweep(
        sweep, o, d, solid, tmax if windowed else None) + (EPS, cull, any_hit)
    before = intersect_sweep.LAUNCHES
    got = intersect_sweep.sweep_select(*args)
    assert intersect_sweep.LAUNCHES == before + 1
    assert_equal(got, intersect_sweep.sweep_select_reference(*args))
    if not any_hit:
        # Closest hits equal the brute-force kernel's where the window
        # holds one (beyond it the brute force keeps the winner as idx).
        n = len(o)
        brute = intersect_brute.mt_select_brute(
            o, d, g.v0, g.e1, g.e2, EPS, cull, solid,
            tmax if windowed else None)
        assert torch.equal(got[1][:n], brute[1])
        assert torch.equal(got[0][:n][brute[1]], brute[0][brute[1]])


def incoherent(scene_cam, n, seed, windowed):
    o, d, tmax = rays(scene_cam, n, seed)
    return o, d, (tmax if windowed else None)


@pytest.mark.parametrize("n_rays", [300, 1400, None],
                         ids=["1-tile", "3-tile", "unsplit"])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_split_and_unsplit_match_plain(scene, n_rays, windowed,
                                             any_hit):
    """Incoherent rays: 1- and 3-tile calls split every group's schedule
    over several blocks; a call of BLOCKS_PER_SM groups per SM fills the
    card unsplit."""
    s, g, sweep = scene
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    unsplit = n_rays is None
    if unsplit:
        n_rays = kernels.BLOCKS_PER_SM * n_sms * intersect_sweep.GROUP
    o, d, tmax = incoherent(s.cam_pos, n_rays, 10 + n_rays, windowed)
    solid = g.tri_valid & ~g.tri_transmissive
    args = intersect_sweep.prepare_sweep(sweep, o, d, solid, tmax)
    k = intersect_sweep.sweep_split(args[1].shape[0], sweep.num_slices,
                                    n_sms)
    assert (k == 1) == unsplit
    got = intersect_sweep.sweep_select(*args, EPS, False, any_hit)
    assert_equal(got, intersect_sweep.sweep_select_reference(
        *args, EPS, False, any_hit))
    n = len(o)
    assert 0 < int(got[1][:n].sum()) < n
    if not any_hit:
        brute = intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, EPS,
                                                False, solid, tmax)
        assert torch.equal(got[1][:n], brute[1])
        assert torch.equal(got[0][:n][brute[1]], brute[0][brute[1]])


@pytest.mark.parametrize("n_tris", [1000, 1283], ids=["1000", "1283"])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_mt_select_triangle_split_matches_plain(scene, n_tris, windowed,
                                                any_hit):
    """Triangle counts that are not a multiple of the 256-triangle tile,
    split over several blocks per 128 rays."""
    s, g, _ = scene
    o, d, tmax = incoherent(s.cam_pos, 2500, 20 + n_tris, windowed)
    n_valid = int(g.tri_valid.sum())
    pick = torch.arange(n_tris, device=DEV) % n_valid
    v0, e1, e2 = g.v0[pick], g.e1[pick], g.e2[pick]
    mask = torch.arange(n_tris, device=DEV) % 7 != 3
    assert intersect_brute.k1_split(
        len(o), n_tris,
        torch.cuda.get_device_properties(0).multi_processor_count) > 1
    args = (o, d, v0, e1, e2, EPS, False, mask, tmax, any_hit)
    got = intersect_brute.mt_select_brute(*args)
    assert_equal(got, intersect_brute.mt_select_reference(*args))
    assert 0 < int(got[1].sum()) < len(o)


@pytest.mark.parametrize("n_tris", [1, 600])
def test_mt_select_writes_no_key_past_the_last_ray(scene, n_tris):
    """1,030 rays (the last 128-ray block holds 6) leave from near the
    origin along +z through stacked triangles that the block's idle
    threads would hit too, were they to test the origin along +z.  The
    keys are the head of a larger buffer whose tail must stay as it was."""
    from simd_raytracer_tpu_torch.models.scene import pack_triangles
    from simd_raytracer_tpu_torch.ops.intersect import BIG
    from simd_raytracer_tpu_torch.ops.select_keys import (decode_any,
                                                          decode_closest,
                                                          seed_keys)
    n = 1030
    rng = np.random.default_rng(7)
    o = torch.zeros(n, 3, device=DEV)
    o[:, :2] = torch.tensor(rng.uniform(-0.2, 0.2, (n, 2)), device=DEV)
    d = torch.tensor([0.0, 0.0, 1.0], device=DEV).expand(n, 3).contiguous()
    z = 5.0 + 0.01 * torch.arange(n_tris, device=DEV, dtype=torch.float32)
    v0 = torch.stack([torch.full_like(z, -1.0), torch.full_like(z, -1.0), z],
                     dim=1)
    e1 = torch.tensor([3.0, 0.0, 0.0], device=DEV).expand(n_tris, 3)
    e2 = torch.tensor([0.0, 3.0, 0.0], device=DEV).expand(n_tris, 3)
    tri = pack_triangles(v0, e1, e2)
    mask = torch.ones(n_tris, dtype=torch.int32, device=DEV)
    tmax = torch.full((n,), BIG, device=DEV)
    split = intersect_brute.k1_split(
        n, n_tris, torch.cuda.get_device_properties(0).multi_processor_count)
    canary = torch.iinfo(torch.int64).max
    for any_hit in (False, True):
        buf = torch.full((n + 512,), canary, dtype=torch.int64, device=DEV)
        buf[:n] = seed_keys(tmax)
        rc = kernels.library().srt_mt_select(
            o.data_ptr(), d.data_ptr(), tmax.data_ptr(), tri.data_ptr(),
            mask.data_ptr(), n, n_tris, split, EPS, 0, int(any_hit),
            buf.data_ptr(), torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "mt_select")
        torch.cuda.synchronize()
        assert bool((buf[n:] == canary).all())
        got = decode_any(buf[:n]) if any_hit else decode_closest(buf[:n])
        ref = intersect_brute.mt_select_reference(o, d, v0, e1, e2, EPS,
                                                  False, any_hit=any_hit)
        assert_equal(got, ref)
        assert bool(got[1].all())


ROULETTE_SWEEP = dict(samples_per_pixel=2, bounce_mode="roulette",
                      intersector="sweep")


@pytest.mark.parametrize("kw", [
    dict(),
    ROULETTE_SWEEP,
    dict(diffuse_reflection_ray_count=1),
    dict(diffuse_reflection_ray_count=2),
    dict(diffuse_reflection_ray_count=1, **ROULETTE_SWEEP),
    dict(diffuse_reflection_ray_count=2, **ROULETTE_SWEEP),
    dict(occlusion_mode="march", intersector="sweep"),
], ids=["split-jnp", "roulette-sweep", "gi1-split-jnp", "gi2-split-jnp",
        "gi1-roulette-sweep", "gi2-roulette-sweep", "march-split-sweep"])
def test_render_on_cuda_matches_cpu(scene, kw):
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=1024, **kw)
    uniforms = lambda c: SeededUniforms(3, c)   # noqa: E731
    before = intersect_brute.LAUNCHES + intersect_sweep.LAUNCHES
    gpu = T.render_frame(s, cfg, device=DEV, uniforms=uniforms)
    assert intersect_brute.LAUNCHES + intersect_sweep.LAUNCHES > before
    cpu = T.render_frame(s, cfg, device="cpu", uniforms=uniforms)
    assert gpu.is_cuda and torch.isfinite(gpu).all()
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_select_bound_to_packed_triangles(scene, any_hit):
    """The render path's brute-force select reads Geometry.tri_soa and
    gives what packing on the call gives."""
    s, g, _ = scene
    o, d, tmax = rays(s.cam_pos, 2000, seed=4)
    select = make_select_fn("jnp", geom=g)
    before = intersect_brute.LAUNCHES
    got = select(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax,
                 any_hit)
    assert intersect_brute.LAUNCHES == before + 1
    assert_equal(got, intersect_brute.mt_select_brute(
        o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax, any_hit))


def test_wrappers_reject_bad_input(scene):
    s, g, sweep = scene
    o, d, _ = rays(s.cam_pos, 64, seed=3)
    with pytest.raises(ValueError):
        intersect_brute.mt_select_brute(o, d[:10], g.v0, g.e1, g.e2, EPS,
                                        True)
    with pytest.raises(ValueError):
        intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, EPS, True,
                                        tri_soa=g.tri_soa[:, 1:])
    with pytest.raises(ValueError, match="eps"):   # the key merge needs t >= 0
        intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, -EPS, True)
    args = list(intersect_sweep.prepare_sweep(sweep, o, d))
    with pytest.raises(ValueError, match="eps"):
        intersect_sweep.sweep_select(*args, -EPS, True, False)
    args[3] = args[3].double()
    with pytest.raises(ValueError):
        intersect_sweep.sweep_select(*args, EPS, True, False)


def test_gradients_on_cuda_match_cpu(scene):
    """float32, roulette + sweep + GI.  The gathers' backward sums terms
    that cancel and adds with atomics on CUDA, so gradients agree to
    1e-3 * max|g| + 1e-6 plus twice the CPU's own float32 error against
    float64, not bitwise."""
    s, _, sweep = scene
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode="roulette", intersector="sweep",
                         diffuse_reflection_ray_count=1)
    n = 48 * 48 * 2
    ids = torch.arange(n)
    f64 = s.map(lambda t: t.double() if t.is_floating_point() else t)
    out = {}
    for name, sc, dev in ((DEV, s, DEV), ("cpu", s, "cpu"),
                          ("cpu64", f64, "cpu")):
        params, skeleton = G.split_params(sc.to(dev))
        before = intersect_sweep.LAUNCHES
        out[name] = G.loss_and_grad(
            params, skeleton, cfg, ids.to(dev),
            torch.full((n, 3), 0.1, dtype=sc.vertices.dtype, device=dev),
            SeededUniforms(8, 0), sweep.to(dev))
        assert (intersect_sweep.LAUNCHES > before) == (dev == DEV)
    (lg, gg), (lc, gc), (_, g64) = out[DEV], out["cpu"], out["cpu64"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for k in G.DIFF_PARAM_NAMES:
        g, c = gg[k].cpu(), gc[k]
        f32_err = float((c.double() - g64[k]).abs().max())
        assert torch.isfinite(g).all(), k
        assert (float((g - c).abs().max())
                <= 1e-3 * float(c.abs().max()) + 1e-6 + 2 * f32_err), k


@pytest.mark.parametrize("intersector", ["jnp", "sweep", "fast"])
def test_march_on_cuda_matches_cpu(scene, intersector):
    s, g, sweep = scene
    rng = np.random.default_rng(5)
    center = np.array([-2.2, -0.6, -7.0])    # the glass sphere
    o = center + rng.normal(scale=2.5, size=(2000, 3))
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = center + rng.normal(scale=0.8, size=(2000, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.5, 12.0, 2000)
    o, d, tmax = (torch.tensor(x, dtype=torch.float32) for x in (o, d, tmax))
    cfg = T.RenderConfig(occlusion_mode="march", intersector=intersector)
    acc = sweep if intersector == "sweep" else None
    sc = s.to("cpu")
    cpu = occluded(o, d, tmax, sc, T.derive_geometry(sc), cfg,
                   None if acc is None else acc.to("cpu"))
    gpu = occluded(o.to(DEV), d.to(DEV), tmax.to(DEV), s, g, cfg, acc)
    assert torch.equal(gpu.cpu(), cpu) and 0 < int(cpu.sum()) < len(cpu)


@pytest.fixture(scope="module")
def kdtree(scene):
    s, _, _ = scene
    return build_kdtree_for_scene(s).to(DEV)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_kd_select_kernel_matches_plain(scene, kdtree, cull, masked):
    """The kd kernel against the plain walk on the same CUDA tensors, and
    against the brute-force kernel's winners."""
    s, g, _ = scene
    o, d, _ = rays(s.cam_pos, 3000, seed=11)
    mask = g.tri_valid & ~g.tri_transmissive if masked else g.tri_valid
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, mask, kdtree)
    before = intersect_kd.LAUNCHES
    got = intersect_kd.kd_select_cuda(*args)
    assert intersect_kd.LAUNCHES == before + 1
    assert_equal(got, kd_select(*args))
    assert 0 < int(got[1].sum()) < len(o)
    brute = intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, EPS,
                                            cull, mask)
    assert torch.equal(got[1], brute[1])
    assert torch.equal(got[0][got[1]], brute[0][brute[1]])


@pytest.mark.parametrize("any_hit", [False, True])
def test_kd_window_select_on_cuda_matches_cpu(scene, kdtree, any_hit):
    """make_select_fn("kdtree") with a t_max window: the kernel's winner
    refined on the card gives the CPU's answer."""
    s, g, _ = scene
    o, d, tmax = rays(s.cam_pos, 2000, seed=12)
    sel = make_select_fn("kdtree", kdtree)
    got = sel(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax,
              any_hit)
    sc = s.to("cpu")
    gc = T.derive_geometry(sc)
    ref = make_select_fn("kdtree", kdtree.to("cpu"))(
        o.cpu(), d.cpu(), gc.v0, gc.e1, gc.e2, EPS, False, gc.tri_valid,
        tmax.cpu(), any_hit)
    assert torch.equal(got[1].cpu(), ref[1])
    assert torch.equal(got[0].cpu(), ref[0])


def test_kdtree_and_kdleaf_renders_on_cuda_match_cpu(scene):
    """A bucket-scheduled kdtree render and a kdleaf sweep render on CUDA
    against the same on the CPU."""
    from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
    s, _, _ = scene
    uniforms = lambda c: SeededUniforms(4, c)   # noqa: E731
    for cfg, accel, sched in (
            (T.RenderConfig(max_ray_depth=3, chunk_size=1024,
                            intersector="kdtree"), None,
             SchedulingType.BUCKET_TILES),
            (T.RenderConfig(max_ray_depth=3, chunk_size=1024,
                            samples_per_pixel=2, bounce_mode="roulette",
                            intersector="sweep"),
             build_sweep_for_scene(s, partition="kdleaf"), None)):
        before = intersect_kd.LAUNCHES + intersect_sweep.LAUNCHES
        gpu = T.render_frame(s, cfg, device=DEV, accel=accel,
                             uniforms=uniforms, scheduling=sched)
        assert intersect_kd.LAUNCHES + intersect_sweep.LAUNCHES > before
        cpu = T.render_frame(s, cfg, device="cpu", accel=accel,
                             uniforms=uniforms, scheduling=sched)
        torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)


def test_kd_wrapper_rejects_bad_input(scene, kdtree):
    s, g, _ = scene
    o, d, _ = rays(s.cam_pos, 64, seed=13)
    with pytest.raises(ValueError):
        intersect_kd.kd_select_cuda(o, d[:10], g.v0, g.e1, g.e2, EPS, True,
                                    None, kdtree)
    with pytest.raises(ValueError, match="to\\(device\\)"):
        intersect_kd.kd_select_cuda(o, d, g.v0, g.e1, g.e2, EPS, True, None,
                                    kdtree.to("cpu"))
    with pytest.raises(ValueError, match="stack"):
        intersect_kd.kd_select_cuda(o, d, g.v0, g.e1, g.e2, EPS, True, None,
                                    kdtree.replace(depth=63))
