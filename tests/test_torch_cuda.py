"""PyTorch port on a CUDA device: each hand-written kernel against its plain
torch version on the same CUDA tensors, and small renders, gradients and
march occlusion on CUDA against the same on the CPU (the mxu select, a
torch.matmul, against the CPU too).

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
from simd_raytracer_tpu_torch.accel.build import (build_kdtree_for_scene,
                                                  refit_kdtree)
from simd_raytracer_tpu_torch.accel.sweep import R_TILE, build_sweep_for_scene
from simd_raytracer_tpu_torch.accel.traverse import kd_select, kd_work_pairs
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import (intersect_brute, intersect_fast,
                                          intersect_kd, intersect_mxu,
                                          intersect_sweep)
from simd_raytracer_tpu_torch.ops.intersect import make_select_fn
from simd_raytracer_tpu_torch.ops.render import build_accel
from simd_raytracer_tpu_torch.ops.shade import occluded
from simd_raytracer_tpu_torch.utils import profiling
from torch_scenes import (SeededUniforms, bitmap_scene_kwargs, grid_doc,
                          mixed_doc, shade_rows)
from yardstick import (RECORD_LEAVES, gradient_gaps, record_case,
                       record_grads, shade_grads)

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
    with profiling.recording() as rec:
        got = intersect_brute.mt_select_brute(*args)
    assert rec.counts["select.launches.brute"] == 1
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
    with profiling.recording() as rec:
        got = intersect_sweep.sweep_select(*args)
    assert rec.counts["select.launches.sweep"] == 1
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
    k = kernels.split(args[1].shape[0] * (R_TILE // intersect_sweep.GROUP),
                      sweep.num_slices, n_sms)
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
    assert kernels.split(
        -(-len(o) // intersect_brute.RAY_BLOCK),
        -(-n_tris // intersect_brute.TRI_TILE),
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
    split = kernels.split(
        -(-n // intersect_brute.RAY_BLOCK),
        -(-n_tris // intersect_brute.TRI_TILE),
        torch.cuda.get_device_properties(0).multi_processor_count)
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
    with profiling.recording() as rec:
        gpu = T.render_frame(s, cfg, device=DEV, uniforms=uniforms)
    assert (rec.counts["select.launches.brute"]
            + rec.counts["select.launches.sweep"]) > 0
    cpu = T.render_frame(s, cfg, device="cpu", uniforms=uniforms)
    assert gpu.is_cuda and torch.isfinite(gpu).all()
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_select_bound_to_packed_triangles(scene, any_hit):
    """The render path's brute-force select reads the triangles its
    binding packed and gives what packing on the call gives."""
    s, g, _ = scene
    o, d, tmax = rays(s.cam_pos, 2000, seed=4)
    select = make_select_fn("jnp", geom=g)
    with profiling.recording() as rec:
        got = select(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax,
                     any_hit)
    assert rec.counts["select.launches.brute"] == 1
    assert_equal(got, intersect_brute.mt_select_brute(
        o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax, any_hit))


def test_wrappers_reject_bad_input(scene):
    s, g, sweep = scene
    o, d, _ = rays(s.cam_pos, 64, seed=3)
    with pytest.raises(ValueError):
        intersect_brute.mt_select_brute(o, d[:10], g.v0, g.e1, g.e2, EPS,
                                        True)
    with pytest.raises(ValueError):
        intersect_brute.mt_select_brute(
            o, d, g.v0, g.e1, g.e2, EPS, True,
            tri_soa=make_select_fn("jnp", geom=g).keywords["tri_soa"][:, 1:])
    with pytest.raises(ValueError, match="eps"):   # the key merge needs t >= 0
        intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, -EPS, True)
    args = list(intersect_sweep.prepare_sweep(sweep, o, d))
    with pytest.raises(ValueError, match="eps"):
        intersect_sweep.sweep_select(*args, -EPS, True, False)
    args[3] = args[3].double()
    with pytest.raises(ValueError):
        intersect_sweep.sweep_select(*args, EPS, True, False)
    fast = intersect_fast.mt_select_fast
    with pytest.raises(ValueError, match="eps"):
        fast(o, d, g.v0, g.e1, g.e2, -EPS, True)
    with pytest.raises(ValueError, match="eps"):
        make_select_fn("fast", geom=g)(o, d, g.v0, g.e1, g.e2, -EPS, True,
                                       any_hit=True)
    with pytest.raises(ValueError):
        fast(o, d[:10], g.v0, g.e1, g.e2, EPS, True)
    with pytest.raises(ValueError):
        fast(o, d, g.v0, g.e1, g.e2, EPS, True, t_max=o[:10, 0])
    with pytest.raises(ValueError, match="table"):
        fast(o, d, g.v0.clone(), g.e1, g.e2, EPS, True,
             table=make_select_fn("fast", geom=g).keywords["table"])


def test_gradients_on_cuda_match_cpu(scene):
    """float32, roulette + sweep + GI.  The forward rounds differently on
    the two devices in its last bits, and the gathers' backward sums terms
    that cancel, which magnifies those bits, so gradients agree to
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
        with profiling.recording() as rec:
            out[name] = G.loss_and_grad(
                params, skeleton, cfg, ids.to(dev),
                torch.full((n, 3), 0.1, dtype=sc.vertices.dtype, device=dev),
                SeededUniforms(8, 0), sweep.to(dev))
        assert (rec.counts["select.launches.sweep"] > 0) == (dev == DEV)
    (lg, gg), (lc, gc), (_, g64) = out[DEV], out["cpu"], out["cpu64"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for k in G.DIFF_PARAM_NAMES:
        g, c = gg[k].cpu(), gc[k]
        f32_err = float((c.double() - g64[k]).abs().max())
        assert torch.isfinite(g).all(), k
        assert (float((g - c).abs().max())
                <= 1e-3 * float(c.abs().max()) + 1e-6 + 2 * f32_err), k


@pytest.mark.parametrize("intersector", ["jnp", "sweep", "fast", "mxu"])
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
    with profiling.recording() as rec:
        got = intersect_kd.kd_select_cuda(*args)
    assert rec.counts["select.launches.kd"] == 1
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
        with profiling.recording() as rec:
            gpu = T.render_frame(s, cfg, device=DEV, accel=accel,
                                 uniforms=uniforms, scheduling=sched)
        assert (rec.counts["select.launches.kd"]
                + rec.counts["select.launches.sweep"]) > 0
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


def camera_rays(s, shuffled, seed=15):
    """Primary rays of every pixel of `s` in bucket-tile order (coherent
    neighbours in each block of the kd kernel), or in a seeded random
    order."""
    from simd_raytracer_tpu_torch.models.camera import primary_rays
    from simd_raytracer_tpu_torch.parallel.tiles import (SchedulingType,
                                                         make_schedule,
                                                         tile_ray_ids)
    tiles = make_schedule(SchedulingType.BUCKET_TILES, s.height, s.width,
                          bucket=16)
    pix = torch.from_numpy(np.concatenate(
        [tile_ray_ids(t, s.width, 1) for t in tiles])).long()
    if shuffled:
        pix = pix[torch.from_numpy(np.random.default_rng(seed).permutation(
            len(pix)))]
    pix = pix.to(DEV)
    half = torch.full(pix.shape, 0.5, device=DEV)
    return primary_rays(s, 90.0, pix % s.width, pix // s.width, half, half)


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["coherent", "shuffled"])
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_kd_kernel_on_camera_rays_matches_plain(scene, kdtree, shuffled, cull,
                                                masked):
    """Coherent camera rays (bucket order) and the same rays shuffled: the
    kd kernel equals the plain walk, and its counter's pair tests equal
    the walk's pair count, the pair slots its leaf rounds ran at least
    that."""
    s, g, _ = scene
    o, d = camera_rays(s, shuffled)
    mask = g.tri_valid & ~g.tri_transmissive if masked else g.tri_valid
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, mask, kdtree)
    counter = torch.zeros(3, dtype=torch.int64, device=DEV)
    got = intersect_kd.kd_select_cuda(*args, counter=counter)
    assert_equal(got, kd_select(*args))
    assert 0 < int(got[1].sum()) < len(o)
    staged, slots, tested = counter.tolist()
    assert tested == kd_work_pairs(*args)
    assert 0 < tested <= slots and staged > 0


@pytest.mark.parametrize("shape", intersect_kd.KD_SHAPES,
                         ids=lambda sh: f"r{sh[0]}-g{sh[1]}")
def test_kd_kernel_shapes_match_plain(scene, kdtree, shape, monkeypatch):
    """Every instantiated (rays per block, lanes per ray) shape, on
    incoherent rays whose count leaves a partial last block."""
    s, g, _ = scene
    o, d, _ = rays(s.cam_pos, 1001, seed=16)
    args = (o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, kdtree)
    monkeypatch.setattr(intersect_kd, "KD_SHAPE", shape)
    assert_equal(intersect_kd.kd_select_cuda(*args), kd_select(*args))


def test_kd_kernel_near_tie_grid_matches_plain():
    """The flat grid of tests/test_torch_kdtree.py::
    test_kd_select_near_tie_on_shared_edges on the card: rays aimed at
    shared vertices and diagonals, max_leaf 4; the kernel equals the
    plain walk on every ray, the outer-edge ones included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    doc, verts, tris = grid_doc()
    s = T.parse_scene_dict(doc).to(DEV)
    g = T.derive_geometry(s)
    tree = build_kdtree_for_scene(s, 8, 4).to(DEV)
    targets = np.concatenate([verts, 0.5 * (verts[tris[:, 0]]
                                            + verts[tris[:, 2]])])
    rng = np.random.default_rng(2)
    o = rng.normal(scale=0.3, size=(len(targets), 3)).astype(np.float32)
    o[:, 2] = 0.0
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(DEV), torch.from_numpy(d).to(DEV)
    for cull in (True, False):
        args = (o, d, g.v0, g.e1, g.e2, EPS, cull, g.tri_valid, tree)
        got = intersect_kd.kd_select_cuda(*args)
        assert_equal(got, kd_select(*args))
        assert int(got[1].sum()) > 150


@pytest.fixture(scope="module")
def deep_tree():
    """The 106,510-triangle scene (64 x 64 camera) with its depth-14
    kd-tree (5,735 nodes, more than a block's shared memory could hold
    beside the staging tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = T.parse_scene_dict(mixed_doc(64, 64))
    tree = build_kdtree_for_scene(s, max_depth=14).to(DEV)
    s = s.to(DEV)
    return s, T.derive_geometry(s), tree


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["coherent", "shuffled"])
@pytest.mark.parametrize("cull", [True, False])
def test_kd_kernel_on_a_tree_larger_than_shared_memory(deep_tree, shuffled,
                                                       cull):
    """The depth-14 tree of the full scene (its node table larger than
    shared memory): the kernel equals the plain walk, its counter's pair
    tests the walk's pair count."""
    s, g, tree = deep_tree
    assert tree.num_nodes > 5555
    o, d = camera_rays(s, shuffled)
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, g.tri_valid, tree)
    counter = torch.zeros(3, dtype=torch.int64, device=DEV)
    got = intersect_kd.kd_select_cuda(*args, counter=counter)
    assert_equal(got, kd_select(*args))
    assert 0 < int(got[1].sum()) < len(o)
    assert counter.tolist()[2] == kd_work_pairs(*args)


def moved_mirror(s):
    """The scene with its mirror sphere (mesh 2 of mixed_doc) moved up,
    left and toward the camera, out of the leaf cells that list it."""
    vid = s.tri_vidx[s.tri_mesh == 2].long().unique()
    v = s.vertices.clone()
    v[vid] += torch.tensor([-1.5, 1.5, 3.0], device=v.device)
    return s.replace(vertices=v)


@pytest.mark.parametrize("cull", [True, False])
def test_kd_kernel_on_a_refitted_tree_matches_plain_and_brute(scene, kdtree,
                                                              cull):
    """After the mirror sphere moves: the refit on the card gives the
    CPU's boxes, the kd kernel on them equals the plain walk and the
    brute-force kernel, and on the build's boxes it loses winners."""
    s, _, _ = scene
    m = moved_mirror(s)
    g = T.derive_geometry(m)
    tree = refit_kdtree(kdtree, m.vertices, m.tri_vidx)
    on_cpu = refit_kdtree(kdtree.to("cpu"), m.vertices.cpu(),
                          m.tri_vidx.cpu())
    assert torch.equal(tree.node_min.cpu(), on_cpu.node_min)
    assert torch.equal(tree.node_max.cpu(), on_cpu.node_max)
    o, d, _ = rays(s.cam_pos, 3000, seed=14)
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, g.tri_valid)
    got = intersect_kd.kd_select_cuda(*args, tree)
    assert_equal(got, kd_select(*args, tree))
    brute = intersect_brute.mt_select_brute(*args)
    assert torch.equal(got[1], brute[1])
    assert torch.equal(got[0][got[1]], brute[0][brute[1]])
    frozen = intersect_kd.kd_select_cuda(*args, kdtree)
    assert not (torch.equal(frozen[1], brute[1])
                and torch.equal(frozen[0][frozen[1]], brute[0][brute[1]]))


@pytest.mark.parametrize("intersector", ["sweep", "kdtree"])
def test_cuda_renders_are_bitwise_reproducible(scene, intersector):
    """Two CUDA renders of one frame at spp 4 (roulette, depth 3) are
    bitwise equal: the fold-back sums a pixel's samples in a fixed
    order."""
    s, _, _ = scene
    cfg = T.RenderConfig(samples_per_pixel=4, max_ray_depth=3,
                         bounce_mode="roulette", chunk_size=1000,
                         intersector=intersector)
    a = T.render_frame(s, cfg, device=DEV)
    b = T.render_frame(s, cfg, device=DEV)
    assert torch.isfinite(a).all() and torch.equal(a, b)


# ---- the fast select kernel and the mxu select -----------------------------

@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_fast_kernel_matches_plain(scene, cull, masked, windowed, any_hit):
    """The render path's select (bound to the geometry's table) against
    the plain version on the same table, and against the kernel with a
    table built on the call: equal bit for bit."""
    s, g, _ = scene
    o, d, tmax = rays(s.cam_pos, 3000, seed=21)
    mask = g.tri_valid & ~g.tri_transmissive if masked else g.tri_valid
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, mask,
            tmax if windowed else None, any_hit)
    select = make_select_fn("fast", geom=g)
    assert select.keywords["table"].soa.dtype == torch.float32
    with profiling.recording() as rec:
        got = select(*args)
    assert rec.counts["select.launches.fast"] == 1
    assert_equal(got, intersect_fast.mt_select_fast_reference(
        *args, table=select.keywords["table"]))
    assert_equal(intersect_fast.mt_select_fast(*args), got)
    assert 0 < int(got[1].sum()) < len(o)


@pytest.mark.parametrize("n_rays,n_tris", [(1001, None), (0, None),
                                           (700, 100), (2500, 1283)],
                         ids=["1001-rays", "0-rays", "100-tris", "1283-tris"])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_fast_kernel_odd_shapes_match_plain(scene, n_rays, n_tris, windowed,
                                            any_hit):
    """Ray counts that leave a partial last block (or none at all), fewer
    triangles than one FAST_TILE tile, and a triangle count that is not a
    multiple of the tile, split over several blocks per ray block."""
    s, g, _ = scene
    o, d, tmax = incoherent(s.cam_pos, max(n_rays, 1), 30 + n_rays, windowed)
    o, d = o[:n_rays], d[:n_rays]
    tmax = None if tmax is None else tmax[:n_rays]
    v0, e1, e2, mask = g.v0, g.e1, g.e2, g.tri_valid
    if n_tris is not None:
        n_valid = int(g.tri_valid.sum())
        pick = (torch.arange(n_tris, device=DEV) * max(1, n_valid // n_tris)
                % n_valid)
        v0, e1, e2 = g.v0[pick], g.e1[pick], g.e2[pick]
        mask = torch.arange(n_tris, device=DEV) % 7 != 3
    args = (o, d, v0, e1, e2, EPS, False, mask, tmax, any_hit)
    with profiling.recording() as rec:
        got = intersect_fast.mt_select_fast(*args)
    assert rec.counts["select.launches.fast"] == (n_rays > 0)
    assert got[0].shape == (n_rays,)
    assert_equal(got, intersect_fast.mt_select_fast_reference(*args))
    if n_rays:
        assert 0 < int(got[1].sum()) < n_rays


def test_fast_kernel_near_tie_grid_matches_plain():
    """The flat grid with shared edges and vertices of tests/
    test_torch_kdtree.py::test_kd_select_near_tie_on_shared_edges: rays
    aimed exactly at grid points and diagonals, where several triangles
    accept at one t; the lowest index must win in the kernel as in the
    plain version, with and without a window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    doc, verts, tris = grid_doc()
    s = T.parse_scene_dict(doc).to(DEV)
    g = T.derive_geometry(s)
    targets = np.concatenate([verts, 0.5 * (verts[tris[:, 0]]
                                            + verts[tris[:, 2]])])
    rng = np.random.default_rng(2)
    o = rng.normal(scale=0.3, size=(len(targets), 3)).astype(np.float32)
    o[:, 2] = 0.0
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(DEV), torch.from_numpy(d).to(DEV)
    tmax = torch.full((len(o),), 50.0, device=DEV)
    for cull in (True, False):
        for t_max in (None, tmax):
            args = (o, d, g.v0, g.e1, g.e2, EPS, cull, g.tri_valid, t_max)
            got = intersect_fast.mt_select_fast(*args)
            assert_equal(got, intersect_fast.mt_select_fast_reference(*args))
            assert int(got[1].sum()) > 150


def fast_exact(args, split_over=1):
    """The fast kernel on `args` against the plain version, bit for bit;
    the call's split must exceed `split_over` - 1."""
    r, t = args[0].shape[0], args[2].shape[0]
    block = intersect_fast.FAST_THREADS * intersect_fast.FAST_WIDTH
    assert kernels.split(-(-r // block), -(-t // intersect_fast.FAST_TILE),
                         kernels.sm_count(0)) >= split_over
    with profiling.recording() as rec:
        got = intersect_fast.mt_select_fast(*args)
    assert rec.counts["select.launches.fast"] == (r > 0)
    assert_equal(got, intersect_fast.mt_select_fast_reference(*args))
    return got


@pytest.mark.parametrize("edge", ["1", "block-1", "block+1"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_fast_kernel_ray_counts_at_the_block_edge(scene, edge, any_hit):
    """1 ray and one ray either side of a block of FAST_THREADS *
    FAST_WIDTH rays (a thread's last rays past the call's end), windowed."""
    s, g, _ = scene
    block = intersect_fast.FAST_THREADS * intersect_fast.FAST_WIDTH
    n = {"1": 1, "block-1": block - 1, "block+1": block + 1}[edge]
    o, d, tmax = incoherent(s.cam_pos, max(n, 64), 40 + n, True)
    args = (o[:n], d[:n], g.v0, g.e1, g.e2, EPS, False, g.tri_valid,
            tmax[:n], any_hit)
    got = fast_exact(args)
    if n > 1:
        assert 0 < int(got[1].sum()) < n


def tie_triangles(g, n_tris, copies):
    """n_tris of the scene's valid triangles, with the constants of its
    largest one (which appears nowhere else) at every index of `copies`:
    exact t ties -> (v0, e1, e2, its centroid, its unit normal)."""
    valid = g.tri_valid.nonzero()[:, 0]
    area = torch.linalg.cross(g.e1[valid], g.e2[valid]).norm(dim=1)
    src = int(valid[area.argmax()])
    pool = valid[valid != src]
    pick = pool[torch.arange(n_tris, device=DEV) % len(pool)]
    v0, e1, e2 = (x[pick].clone() for x in (g.v0, g.e1, g.e2))
    for i in copies:
        v0[i], e1[i], e2[i] = g.v0[src], g.e1[src], g.e2[src]
    n = torch.linalg.cross(g.e1[src], g.e2[src])
    centroid = g.v0[src] + (g.e1[src] + g.e2[src]) / 3.0
    return v0, e1, e2, centroid.cpu().numpy(), (n / n.norm()).cpu().numpy()


def aimed_rays(centroid, normal, n, seed):
    """n rays from points half a unit off a triangle's front face (its
    normal's side, so culling keeps it), each aimed at its centroid."""
    rng = np.random.default_rng(seed)
    o = (centroid + 0.5 * normal
         + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    d = centroid - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(DEV),
            torch.from_numpy(d.astype(np.float32)).to(DEV))


TILE = intersect_fast.FAST_TILE


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("windowed", [False, True])
def test_fast_kernel_ties_across_compacted_tiles_and_split_blocks(
        scene, cull, windowed):
    """One triangle's constants repeated at the last live index of tile 0,
    at the first live index of tile 1 (its first 40 triangles masked) and
    in the last tile, which another block of the split takes: every ray
    aimed at it ties exactly on the three, and the lowest index wins, in
    the kernel as in the plain version."""
    s, g, _ = scene
    n_tris = 8 * TILE + 37
    first, second, last = TILE - 1, TILE + 40, 8 * TILE + 20
    v0, e1, e2, centroid, normal = tie_triangles(g, n_tris,
                                                 (first, second, last))
    mask = torch.ones(n_tris, dtype=torch.bool, device=DEV)
    mask[TILE:second] = False
    o, d = aimed_rays(centroid, normal, 300, 50)
    tmax = torch.full((300,), 100.0, device=DEV) if windowed else None
    args = (o, d, v0, e1, e2, EPS, cull, mask, tmax, False)
    idx, hit = fast_exact(args, split_over=2)
    assert int((hit & (idx == first)).sum()) > 250
    assert not bool(((idx == second) | (idx == last)).any())


@pytest.mark.parametrize("kind", ["whole-tiles", "one-live", "glass"])
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_fast_kernel_masks_that_empty_tiles(scene, kind, windowed, any_hit):
    """Masks the compaction must honour: four whole tiles masked out; a
    single live triangle, at the last index of a tile; the glass-only mask
    of the march's second probe (ops/shade.py::occluded)."""
    s, g, _ = scene
    if kind == "glass":
        v0, e1, e2 = g.v0, g.e1, g.e2
        mask = g.tri_valid & g.tri_transmissive
        o, d, tmax = incoherent(s.cam_pos, 3000, 60, windowed)
    else:
        n_tris = 8 * TILE
        lone = 3 * TILE - 1
        v0, e1, e2, centroid, normal = tie_triangles(g, n_tris, (lone,))
        mask = torch.ones(n_tris, dtype=torch.bool, device=DEV)
        if kind == "whole-tiles":
            mask[2 * TILE:6 * TILE] = False
            o, d, tmax = incoherent(s.cam_pos, 3000, 61, windowed)
        else:
            mask[:] = False
            mask[lone] = True
            o, d = aimed_rays(centroid, normal, 700, 62)
            tmax = torch.full((700,), 100.0, device=DEV) if windowed else None
    args = (o, d, v0, e1, e2, EPS, False, mask, tmax, any_hit)
    idx, hit = fast_exact(args, split_over=2)
    if kind == "one-live":
        assert int(hit.sum()) == len(o)
        if not any_hit:
            assert bool((idx == lone).all())
    else:
        assert 0 < int(hit.sum()) < len(o)


@pytest.mark.parametrize("windowed", [False, True])
def test_fast_kernel_any_hit_over_a_split(scene, windowed):
    """Any-hit on few rays, so the tiles spread over many blocks of the
    split, each polling the keys other blocks decide."""
    s, g, _ = scene
    o, d, tmax = incoherent(s.cam_pos, 200, 63, windowed)
    args = (o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax, True)
    _, hit = fast_exact(args, split_over=4)
    assert 0 < int(hit.sum()) < len(o)


def test_fast_kernel_degenerate_triangles_match_plain():
    """Triangles whose det is +0 or -0 for every ray (zero edges, parallel
    edges) and rays lying in a triangle's plane, beside ordinary ones: the
    kernel's sign-bit flip on the common path and the plain version's
    multiplication by sgn must reject and accept the same pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(64)
    n = 300
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    v0[:, 2] -= 4.0
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    e1[0:40] = 0.0                                   # a zero edge
    e2[40:80] = -2.0 * e1[40:80]                     # parallel edges
    e1[80:120] = [1.0, 0.0, 0.0]                     # in the plane z = v0.z
    e2[80:120] = [0.0, 1.0, 0.0]
    e1[120:160] = [-1.0, 0.0, 0.0]                   # the same, flipped
    e2[120:160] = [0.0, -1.0, 0.0]
    o = np.zeros((2000, 3), np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d[:500, 2] = 0.0                                 # parallel to z planes
    o[:500, 2] = v0[80 + np.arange(500) % 80, 2]     # and in them
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = [torch.from_numpy(x).to(DEV) for x in (v0, e1, e2)]
    o, d = torch.from_numpy(o).to(DEV), torch.from_numpy(d).to(DEV)
    tmax = torch.full((len(o),), 8.0, device=DEV)
    hits = 0
    for cull in (True, False):
        for t_max in (None, tmax):
            for any_hit in (False, True):
                got = fast_exact((o, d, *tri, EPS, cull, None, t_max,
                                  any_hit))
                hits += int(got[1].sum())
    assert hits > 0


@pytest.mark.parametrize("intersector", ["fast", "mxu"])
def test_fast_and_mxu_renders_on_cuda_match_cpu(scene, intersector):
    """The reference-exact estimator (split + march) under fast and mxu:
    fast within 1e-4 of the CPU (the table's centre is a mean, summed in
    another order on each device); mxu to the JAX package's own bar for it
    (2e-3 * max(1, |a|) on more than 99% of values: cuBLAS and the CPU's
    BLAS sum the ten products in another order)."""
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=1024,
                         occlusion_mode="march", intersector=intersector)
    uniforms = lambda c: SeededUniforms(6, c)   # noqa: E731
    with profiling.recording() as rec:
        gpu = T.render_frame(s, cfg, device=DEV, uniforms=uniforms)
    assert ((rec.counts["select.launches.fast"] > 0)
            == (intersector == "fast"))
    cpu = T.render_frame(s, cfg, device="cpu", uniforms=uniforms)
    assert gpu.is_cuda and torch.isfinite(gpu).all()
    if intersector == "fast":
        torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)
    else:
        a, b = cpu.numpy(), gpu.cpu().numpy()
        assert (np.abs(a - b) <= 2e-3 * np.maximum(1.0, np.abs(a))
                ).mean() > 0.99


def test_mxu_on_cuda_ignores_tf32(scene):
    """With TF32 switched on globally the mxu select's winners do not
    change (its product runs in full float32) and the setting survives
    the call; against the CPU, JAX's bar (hit flags and winners agree on
    more than 99.9% of rays)."""
    s, g, _ = scene
    o, d, tmax = rays(s.cam_pos, 3000, seed=23)
    prev = torch.get_float32_matmul_precision()
    for any_hit in (False, True):
        args = (o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax,
                any_hit)
        try:
            torch.backends.cuda.matmul.allow_tf32 = False
            strict = intersect_mxu.mt_select_mxu(*args)
            torch.backends.cuda.matmul.allow_tf32 = True
            loose = intersect_mxu.mt_select_mxu(*args)
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.set_float32_matmul_precision(prev)
        assert_equal(loose, strict)
        cpu = intersect_mxu.mt_select_mxu(
            *(a.cpu() if torch.is_tensor(a) else a for a in args))
        hit, chit = strict[1].cpu(), cpu[1]
        assert float((hit == chit).float().mean()) > 0.999
        both = hit & chit
        assert float((strict[0].cpu()[both] == cpu[0][both]).float().mean()
                     ) > 0.999
        assert 0 < int(hit.sum()) < len(o)


def test_kd_counters_are_read_from_the_record(scene):
    """While tracing, the kd select hands the kernel the record's device
    counter; record() reads it once.  Off, the kernel gets none."""
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=256,
                         intersector="kdtree")
    with profiling.recording() as rec:
        T.render_frame(s, cfg, device=DEV)
    c = rec.read()["counts"]
    assert c["select.launches.kd"] > 0 and c["kd.staged"] > 0
    assert 0 < c["kd.tests"] <= c["kd.slots"]
    assert profiling.kd_counter(torch.device(DEV, 0)) is None


# ---- the gathers' backward (ops/gather.py, csrc/gather_grad.cu) -------------

def gather_case(n_rows, n, width, dtype, seed):
    """Indices as the render draws them (a third on row 0, the rest
    uniform) and gradients, on the card."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n)
    idx[rng.random(n) < 1 / 3] = 0
    vals = rng.normal(size=(n, width))
    return (torch.tensor(idx, device=DEV),
            torch.tensor(vals, dtype=dtype, device=DEV))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rows,n,width", [
    (1, 65536, 3), (3, 5000, 9), (12, 65536, 3), (2012, 65536, 6),
    (2012, 65536, 9), (5, 257, 1), (700, 700, 2), (4, 0, 3)],
    ids=["one-row-65536", "3", "12", "2012-w6", "2012-w9", "piece+1",
         "distinct", "empty"])
def test_gather_grad_kernel_matches_plain(card, n_rows, n, width, dtype):
    """The kernel makes the plain version's adds in its order, so both
    dtypes agree bit for bit (float32 would otherwise differ by the sum's
    rounding in another tree); float64 is also within 1e-12 of each row's
    sum of |values| of index_put_(accumulate=True)."""
    from simd_raytracer_tpu_torch.ops.gather import (row_sums,
                                                     row_sums_reference)
    idx, vals = gather_case(n_rows, n, width, dtype, seed=n_rows + width)
    with profiling.recording() as rec:
        got = row_sums(idx, vals, n_rows)
    assert rec.counts["gather.launches"] == (2 if n else 0)
    ref = row_sums_reference(idx, vals, n_rows)
    assert got.dtype == dtype and torch.equal(got, ref)
    if dtype == torch.float64:
        want = torch.zeros_like(got).index_put_((idx,), vals,
                                                accumulate=True)
        scale = torch.zeros_like(got).index_put_((idx,), vals.abs(),
                                                 accumulate=True)
        assert bool(((got - want).abs() <= 1e-12 * scale).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_backward_is_bitwise_reproducible(card, dtype):
    from simd_raytracer_tpu_torch.ops.gather import gather_rows
    idx, vals = gather_case(2012, 65536, 9, dtype, seed=11)
    table = torch.randn(2012, 3, 3, dtype=dtype, device=DEV,
                        requires_grad=True)
    grads = [torch.autograd.grad(gather_rows(table, idx),
                                 table, vals.reshape(-1, 3, 3))[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


def test_loss_and_grad_on_cuda_is_bitwise_reproducible(scene):
    """Two loss_and_grad calls on one seed (roulette, GI, the brute-force
    select, as the train cell) give the same bits: the gathers' backward
    has no atomics, and every other backward op sums in a fixed order."""
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=5, samples_per_pixel=2,
                         bounce_mode="roulette", intersector="jnp",
                         diffuse_reflection_ray_count=1)
    n = 48 * 48 * 2
    params, skeleton = G.split_params(s)
    runs = []
    for _ in range(2):
        with profiling.recording() as rec:
            runs.append(G.loss_and_grad(
                params, skeleton, cfg, torch.arange(n, device=DEV),
                torch.full((n, 3), 0.1, device=DEV), SeededUniforms(8, 0)))
        calls = rec.counts["gather.backward.calls"]
        assert calls > 0 and rec.counts["gather.launches"] == 2 * calls
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for k in G.DIFF_PARAM_NAMES:
        assert torch.equal(g0[k], g1[k]), k


def test_train_steps_through_the_refitted_sweep_kernel(scene, monkeypatch):
    """Three SGD steps at a large rate through the sweep kernel with
    accel_refit: every select of every step has the winners and hit
    flags of the mt_select kernel on that step's own triangles, one refit
    a step, and two runs give the same bits."""
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=5, samples_per_pixel=2,
                         bounce_mode="roulette", intersector="sweep",
                         diffuse_reflection_ray_count=1, accel_refit=True)
    n = 48 * 48 * 2
    calls = []
    inner = intersect_sweep.bind

    def bind(sweep, geom):
        select = inner(sweep, geom)
        brute = intersect_brute.bind(None, geom)

        def both(*args, **kwargs):
            got = select(*args, **kwargs)
            any_hit = kwargs.get("any_hit", len(args) > 9 and args[9])
            calls.append((got, brute(*args, **kwargs), any_hit))
            return got
        return both

    monkeypatch.setattr(intersect_sweep, "bind", bind)
    runs = []
    for _ in range(2):
        params, skeleton = G.split_params(s)
        with profiling.recording() as rec:
            runs.append(G.train_steps(
                params, skeleton, cfg, torch.arange(n, device=DEV),
                torch.full((n, 3), 0.1, device=DEV),
                lambda i: SeededUniforms(9, i), lr=0.2, n_steps=3,
                accel=build_accel(s, cfg).to(DEV)))
        assert rec.counts["sweep.refit.calls"] == 3
        assert rec.counts["select.launches.sweep"] > 0
    assert len(calls) > 6
    for (idx, hit), (want_i, want_h), any_hit in calls:
        assert torch.equal(hit, want_h)
        assert any_hit or torch.equal(idx[hit], want_i[hit])
    (p0, l0), (p1, l1) = runs
    assert torch.equal(l0, l1)
    for k in G.DIFF_PARAM_NAMES:
        assert torch.equal(p0[k], p1[k]), k
    assert not torch.equal(p0["vertices"], s.vertices)


def test_train_steps_through_the_refitted_kd_kernel(scene, kdtree,
                                                   monkeypatch):
    """Three SGD steps with split bounces at a large rate through the kd
    kernel with accel_refit, from the scene with the mirror sphere moved
    and the tree built before the move: every select of every step has
    the mt_select kernel's winners and hit flags on that step's own
    triangles, one refit a step, and the losses and parameters are the
    brute-force route's on the card."""
    s, _, _ = scene
    m = moved_mirror(s)
    n = 48 * 48
    calls = []
    inner = intersect_kd.bind

    def bind(tree, geom):
        select = inner(tree, geom)
        brute = intersect_brute.bind(None, geom)

        def both(*args, **kwargs):
            got = select(*args, **kwargs)
            calls.append((got, brute(*args, **kwargs)))
            return got
        return both

    def steps(**render):
        cfg = T.RenderConfig(max_ray_depth=5, **render)
        params, skeleton = G.split_params(m)
        accel = None if cfg.intersector == "jnp" else kdtree.replace(
            refit=cfg.accel_refit)
        return G.train_steps(params, skeleton, cfg,
                             torch.arange(n, device=DEV),
                             torch.full((n, 3), 0.1, device=DEV),
                             lambda i: SeededUniforms(9, i), lr=0.2,
                             n_steps=3, accel=accel)

    want_p, want_l = steps()
    monkeypatch.setattr(intersect_kd, "bind", bind)
    with profiling.recording() as rec:
        got_p, got_l = steps(intersector="kdtree", accel_refit=True)
    assert rec.counts["kd.refit.calls"] == 3
    assert rec.counts["select.launches.kd"] > 0
    assert len(calls) > 9
    for (idx, hit), (want_i, want_h) in calls:
        assert torch.equal(hit, want_h)
        assert torch.equal(idx[hit], want_i[hit])
    assert torch.equal(got_l, want_l)
    for k in G.DIFF_PARAM_NAMES:
        assert torch.equal(got_p[k], want_p[k]), k


# ---- the hit record: csrc/trace.cu against the plain torch version ---------

def same_record(got, ref) -> list:
    """The fields of two hit records whose dtype, shape or bits differ."""
    from simd_raytracer_tpu_torch.ops import intersect as I
    out = []
    for field in ("mask", "idx", *I._GRAD_FIELDS, *I._INT_FIELDS):
        a, b = getattr(got, field), getattr(ref, field)
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            out.append(field)
    return out


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("intersector", ["jnp", "sweep", "fast", "kdtree",
                                         "mxu"])
def test_trace_record_is_the_plain_record_bitwise(scene, intersector, cull):
    """Through every intersector, the record `trace` makes on the card
    (csrc/trace.cu, one launch) is the plain version's from the same
    winners, bit for bit, on hits and misses."""
    from simd_raytracer_tpu_torch.ops.intersect import (record_reference,
                                                        trace)
    s, g, _ = scene
    cfg = T.RenderConfig(intersector=intersector)
    accel = build_accel(s.to("cpu"), cfg)
    accel = None if accel is None else accel.to(DEV)
    o, d, _ = rays(s.cam_pos, 3000, seed=31)
    with profiling.recording() as rec:
        got = trace(o, d, s, g, EPS, cull, intersector=intersector,
                    accel=accel)
    assert rec.counts["trace.fused.calls"] == 1
    assert rec.counts["trace.fused.rows"] == 3000
    assert rec.counts["trace.launches"] == 1
    assert rec.counts["trace.plain.calls"] == 0
    assert 0 < int(got.mask.sum()) < 3000
    assert same_record(got, record_reference(o, d, got.idx, got.mask, s, g,
                                             EPS)) == []


@pytest.mark.parametrize("cull", [True, False])
def test_trace_record_kernels_at_the_determinant_clamp(card, cull):
    """The four-texture scene's rays with their winners, and rays along a
    triangle's edge whose refine clamps its determinant, flagged as hits
    and as misses: the record is the plain version's bit for bit, and the
    backward's gradients of o, d and every table are within the float64
    yardstick of the plain version's (one backward call: its kernel and
    two segmented sums of two launches)."""
    from simd_raytracer_tpu_torch.models.scene import build_scene
    from simd_raytracer_tpu_torch.ops import intersect as I
    scene = build_scene(**bitmap_scene_kwargs(32, 32)).to(DEV)
    geom, o, d, idx, hit = record_case(scene, cull, n=3000, seed=cull)
    ref = I.record_reference(o, d, idx, hit, scene, geom, EPS)
    assert same_record(I.record_fused(o, d, idx, hit, scene, geom, EPS),
                       ref) == []
    gen = torch.Generator(device=DEV).manual_seed(7)
    outs = [torch.randn(getattr(ref, k).shape, generator=gen, device=DEV)
            for k in I._GRAD_FIELDS]
    args = (scene, geom, o, d, idx, hit)
    with profiling.recording() as rec:
        vals, got = record_grads(I.record_fused, *args, outs)
    assert rec.counts["trace.fused.grad_calls"] == 1
    assert rec.counts["trace.backward.calls"] == 1
    assert rec.counts["trace.backward.launches"] == 5
    assert rec.counts["gather.backward.calls"] == 0
    plain_vals, plain = record_grads(I.record_reference, *args, outs)
    assert same_record(vals, plain_vals) == []
    _, exact = record_grads(I.record_reference, *args, outs, torch.float64)
    for leaf, (gap, allowed) in zip(RECORD_LEAVES,
                                    gradient_gaps(got, plain, exact)):
        assert gap <= allowed, (leaf, gap, allowed)


def test_trace_refuses_float64_on_the_card(scene):
    """csrc/trace.cu takes float32: a float64 trace on the card is refused,
    not recorded by another path."""
    from simd_raytracer_tpu_torch.ops.intersect import trace
    s, g, _ = scene
    o, d, _ = rays(s.cam_pos, 64, seed=3)
    with pytest.raises(ValueError, match="float32"):
        trace(o.double(), d.double(), s, g, EPS, True)


def test_training_traces_through_the_record_node(scene, monkeypatch):
    """An SGD step on the card (roulette, GI, the brute-force select, as
    the train cell): every trace call but the depth cutoff's runs the
    record as the autograd node, and each of those has one backward; no
    gather's backward comes from trace (the step makes those of a step
    whose plain record gathers by plain indexing); the loss is the plain
    record's step's bit for bit, and every gradient is within the float64
    yardstick of it (the same step on the CPU in float64)."""
    from simd_raytracer_tpu_torch.ops import intersect as I
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode="roulette", intersector="jnp",
                         diffuse_reflection_ray_count=1)
    n = 48 * 48 * 2

    def step(sc, dev=DEV):
        params, skeleton = G.split_params(sc)
        with profiling.recording() as rec:
            out = G.loss_and_grad(
                params, skeleton, cfg, torch.arange(n, device=dev),
                torch.full((n, 3), 0.1, dtype=sc.vertices.dtype, device=dev),
                SeededUniforms(8, 0))
        return out, rec

    (loss, grads), rec = step(s)
    calls = rec.spans["trace"][0]
    grad_calls = rec.counts["trace.fused.grad_calls"]
    assert rec.counts["trace.fused.calls"] == calls == grad_calls + 1
    assert rec.counts["trace.backward.calls"] == grad_calls > 0
    assert rec.counts["trace.plain.calls"] == 0
    monkeypatch.setattr(I, "record_applies", lambda o: False)
    (loss_p, grads_p), plain = step(s)
    with monkeypatch.context() as patch:
        patch.setattr(I, "gather_rows", lambda table, idx: table[idx])
        _, indexed = step(s)
    assert (rec.counts["gather.backward.calls"]
            == indexed.counts["gather.backward.calls"]
            < plain.counts["gather.backward.calls"])
    assert torch.equal(loss, loss_p)
    (_, grads_64), _ = step(s.to("cpu").map(
        lambda t: t.double() if t.is_floating_point() else t), "cpu")
    names = G.DIFF_PARAM_NAMES
    for k, (gap, allowed) in zip(names, gradient_gaps(
            [grads[k] for k in names], [grads_p[k] for k in names],
            [grads_64[k] for k in names])):
        assert gap <= allowed, (k, gap, allowed)


# ---- shading: csrc/shade.cu against the plain torch version ----------------

THREE_LIGHTS = ([[0.0, 2.0, -1.0], [2.0, 3.0, -2.0], [-2.0, 1.0, 0.0]],
                [60.0, 40.0, 25.0])


@pytest.fixture(scope="module")
def shade_scene(card):
    """The four-texture scene (albedo, edges, checker, bitmap) on the card
    with its one light, and with the first two or all three of
    THREE_LIGHTS."""
    from simd_raytracer_tpu_torch.models.scene import build_scene
    s = build_scene(**bitmap_scene_kwargs(32, 32)).to(DEV)
    pos, power = THREE_LIGHTS
    scenes = {1: s}
    for count in (2, 3):
        scenes[count] = s.replace(
            light_pos=torch.tensor(pos[:count], device=DEV),
            light_intensity=torch.tensor(power[:count], device=DEV))
    return scenes, T.derive_geometry(s)


def shade_args(scene, geom, cfg, n, seed, lit=True):
    """The arguments of one shade call over `shade_rows` on the card; with
    lit False no row is diffuse or textured, so no row needs light."""
    from simd_raytracer_tpu_torch.ops.intersect import HitRecord
    gi = cfg.diffuse_reflection_ray_count
    rows = shade_rows(n, seed, int(scene.tex_tag.shape[0]), gi,
                      scene.vertices.min(0).values.cpu().numpy(),
                      scene.vertices.max(0).values.cpu().numpy())
    if not lit:
        rows["mat_tag"] = np.random.default_rng(seed).integers(
            1, 4, n).astype(np.int32)
    t = {k: torch.from_numpy(v).to(DEV) for k, v in rows.items()}
    d_in, weight, coin, rnd_gi = (t.pop(k) for k in
                                  ("d_in", "weight", "rnd_coin", "rnd_gi"))
    return (scene, geom, HitRecord(**t), d_in, weight, cfg, None,
            coin if cfg.bounce_mode == "roulette" else None,
            rnd_gi if gi > 0 else None)


def assert_same_bits(got, ref):
    """contrib and every child tensor: same dtype, shape and bits."""
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", [0, 1, 1000, 4096])
@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("gi", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["split", "roulette"])
def test_shade_kernels_match_plain_bitwise(shade_scene, mode, gi, lights, n):
    """Every material tag, every texture kind (checker at negative UVs,
    bitmap rows and columns clamped at both edges), misses and dead rays,
    TIR and grazing refraction: contrib and every child tensor are the
    plain version's bits, at 0, 1, a ragged 1000 and a whole 4096 rows."""
    from simd_raytracer_tpu_torch.ops import shade as S
    scenes, geom = shade_scene
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=gi,
                         intersector="jnp")
    args = shade_args(scenes[lights], geom, cfg, n, seed=100 * gi + n)
    with profiling.recording() as rec:
        got = S.shade(*args)
    assert rec.counts["shade.fused.calls"] == 1
    assert rec.counts["shade.fused.rows"] == n
    assert rec.counts["shade.plain.calls"] == 0
    # shade_bounce over any row; shade_lights and shade_factor where a row
    # needs light.
    assert rec.counts["shade.launches"] == (
        0 if n == 0 else 3 if "occlusion" in rec.spans else 1)
    assert_same_bits(got, S.shade_reference(*args))


@pytest.mark.parametrize("mode", ["split", "roulette"])
def test_shade_kernels_with_no_row_needing_light(shade_scene, mode):
    """Reflective, refractive and constant rows only: `need` is empty, no
    shadow ray is traced, and the results are still the plain version's."""
    from simd_raytracer_tpu_torch.ops import shade as S
    scenes, geom = shade_scene
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=1,
                         intersector="jnp")
    args = shade_args(scenes[3], geom, cfg, 1000, seed=7, lit=False)
    with profiling.recording() as rec:
        got = S.shade(*args)
    assert "occlusion" not in rec.spans
    assert rec.counts["shade.launches"] == 1
    assert_same_bits(got, S.shade_reference(*args))


def check_shade_backward(args, n):
    """One shade call with every float input requiring grad: the values
    through the autograd node the plain version's bits, and every input's
    gradient through csrc/shade_grad.cu within the float64 yardstick (the
    plain version's float64 gradient from the call's own `need` and
    occlusion); one backward call of `n` rows and its launches counted."""
    from simd_raytracer_tpu_torch.ops import shade as S
    scene, geom, hit, _, weight, cfg = args[:6]
    need = S.need_rows(hit, weight)
    occ, _ = S._shadow(scene, geom, hit, cfg, None, need)
    k = cfg.child_slots
    gen = torch.Generator(device=DEV).manual_seed(n + k)
    outs = [torch.randn(shape, generator=gen, device=DEV)
            for shape in ((n, 3), (n * k, 3), (n * k, 3), (n * k,))]
    with profiling.recording() as rec:
        vals, got = shade_grads(S.shade, args, outs)
    assert rec.counts["shade.fused.grad_calls"] == 1
    assert rec.counts["shade.backward.calls"] == 1
    assert rec.counts["shade.backward.rows"] == n
    # shade_bounce_grad and the texture tables' segmented sum (two);
    # shade_lights_grad and the lights' segmented sum where a row needs
    # light.
    assert rec.counts["shade.backward.launches"] == (
        0 if n == 0 else 6 if need.numel() else 3)
    vals_p, plain = shade_grads(S.shade_reference, args, outs)
    for a, b in zip(vals, vals_p):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    _, exact = shade_grads(
        lambda *a: S.shade_reference(*a, lights=(need, occ)), args, outs,
        torch.float64)
    if n:
        assert sum(g is not None for g in plain) >= 10
        for g, g_p in zip(got, plain):
            assert (g is None) == (g_p is None)
    for i, (gap, allowed) in enumerate(gradient_gaps(got, plain, exact)):
        assert gap <= allowed, (i, gap, allowed)


@pytest.mark.parametrize("lights", [1, 2])
@pytest.mark.parametrize("gi", [0, 1, 2])
@pytest.mark.parametrize("mode", ["split", "roulette"])
def test_shade_backward_kernels_match_plain_gradients(shade_scene, mode, gi,
                                                      lights):
    """Every material tag (textured, refractive with TIR, reflective,
    constant, diffuse), every texture kind, misses and dead rays: the
    backward kernels' gradients of every input within the float64
    yardstick of the plain version's."""
    scenes, geom = shade_scene
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=gi,
                         intersector="jnp")
    check_shade_backward(shade_args(scenes[lights], geom, cfg, 1000,
                                    seed=300 + 10 * gi + lights), 1000)


@pytest.mark.parametrize("case", ["unlit", "empty"])
@pytest.mark.parametrize("mode", ["split", "roulette"])
def test_shade_backward_kernels_with_no_light_or_no_row(shade_scene, mode,
                                                        case):
    """Reflective, refractive and constant rows only (no row needs light:
    no light kernel, no light gradient), and a call of no rows (no
    launch)."""
    scenes, geom = shade_scene
    cfg = T.RenderConfig(bounce_mode=mode, diffuse_reflection_ray_count=1,
                         intersector="jnp")
    n = 0 if case == "empty" else 1000
    check_shade_backward(shade_args(scenes[2], geom, cfg, n, seed=9,
                                    lit=case != "unlit"), n)


def small_frame_cfgs():
    """The two frame cells' configurations at 64 square: GI (split, one
    diffuse ray, march occlusion, the fast select) and kd (spp 1, split,
    fast occlusion, the kd-tree)."""
    return {
        "gi": T.RenderConfig(samples_per_pixel=2, max_ray_depth=4,
                             diffuse_reflection_ray_count=1,
                             bounce_mode="split", intersector="fast",
                             occlusion_mode="march", chunk_size=1024),
        "kd": T.RenderConfig(samples_per_pixel=1, max_ray_depth=5,
                             bounce_mode="split", intersector="kdtree",
                             occlusion_mode="fast", chunk_size=1024)}


@pytest.mark.parametrize("which", ["gi", "kd"])
def test_frames_through_the_shade_kernels_equal_plain(card, which,
                                                      monkeypatch):
    """A 64x64 GI frame and kd frame: through the kernels (every shade
    call fused) bitwise equal to the same frame with the plain version
    called directly, and to itself rendered again."""
    from simd_raytracer_tpu_torch.ops import render, shade as S
    s = T.parse_scene_dict(mixed_doc(64, 64, g=16, subdiv=2)).to(DEV)
    cfg = small_frame_cfgs()[which]
    accel = render.build_accel(s, cfg)
    uniforms = lambda c: SeededUniforms(17, c)   # noqa: E731
    with profiling.recording() as rec:
        fused = T.render_frame(s, cfg, device=DEV, accel=accel,
                               uniforms=uniforms)
    assert rec.counts["shade.fused.calls"] == rec.spans["shade"][0] > 0
    assert rec.counts["shade.plain.calls"] == 0
    again = T.render_frame(s, cfg, device=DEV, accel=accel,
                           uniforms=uniforms)
    monkeypatch.setattr(render, "shade", S.shade_reference)
    plain = T.render_frame(s, cfg, device=DEV, accel=accel,
                           uniforms=uniforms)
    assert torch.isfinite(fused).all() and float(fused.max()) > 0
    assert torch.equal(fused, plain) and torch.equal(fused, again)


def test_training_shades_through_the_kernels_with_plain_gradients(
        scene, monkeypatch):
    """An SGD step's inputs require grad, so every shade call runs the
    kernels as the autograd node (`shade.fused.grad_calls` counts them)
    and its backward through csrc/shade_grad.cu (`shade.backward.calls`):
    the loss is the plain version's bit for bit, and every gradient is
    within the float64 yardstick of the plain version's (the same step on
    the CPU in float64)."""
    from simd_raytracer_tpu_torch.ops import render, shade as S
    s, _, _ = scene
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode="roulette", intersector="jnp",
                         diffuse_reflection_ray_count=1)
    n = 48 * 48 * 2

    def step(sc, dev=DEV):
        params, skeleton = G.split_params(sc)
        return G.loss_and_grad(
            params, skeleton, cfg, torch.arange(n, device=dev),
            torch.full((n, 3), 0.1, dtype=sc.vertices.dtype, device=dev),
            SeededUniforms(8, 0))

    with profiling.recording() as rec:
        loss, grads = step(s)
    calls = rec.spans["shade"][0]
    assert rec.counts["shade.fused.grad_calls"] == calls > 0
    assert rec.counts["shade.backward.calls"] == calls
    assert rec.counts["shade.fused.calls"] == calls
    assert rec.counts["shade.plain.calls"] == 0
    monkeypatch.setattr(render, "shade", S.shade_reference)
    loss_p, grads_p = step(s)
    assert torch.equal(loss, loss_p)
    _, grads_64 = step(s.to("cpu").map(
        lambda t: t.double() if t.is_floating_point() else t), "cpu")
    names = G.DIFF_PARAM_NAMES
    for k, (gap, allowed) in zip(names, gradient_gaps(
            [grads[k] for k in names], [grads_p[k] for k in names],
            [grads_64[k] for k in names])):
        assert gap <= allowed, (k, gap, allowed)


def test_shade_refuses_float64_on_the_card(shade_scene):
    """csrc/shade.cu takes float32: a float64 call on the card is refused,
    not shaded by another path."""
    from simd_raytracer_tpu_torch.ops import shade as S
    scenes, geom = shade_scene
    cfg = T.RenderConfig(diffuse_reflection_ray_count=1, intersector="jnp")
    args = list(shade_args(scenes[1], geom, cfg, 64, seed=3))
    args[4] = args[4].double()
    with pytest.raises(ValueError, match="float32"):
        S.shade(*args)
