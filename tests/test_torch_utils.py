"""PyTorch port: tile scheduling, the camera movement API, progressive
rendering with checkpoints, animation, profiling, the native loader and
PPM encoder, and the CLI flags, against the JAX package where it has the
same function."""

import json

import jax
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.accel.build import (
    build_kdtree_for_scene as j_build_kdtree_for_scene)
from simd_raytracer_tpu.models import camera as j_cam
from simd_raytracer_tpu.ops.render import make_ray_chunks as j_chunks
from simd_raytracer_tpu.parallel import tiles as j_tiles
from simd_raytracer_tpu.utils.animation import orbit_path as j_orbit
from simd_raytracer_tpu.utils.checkpoint import (
    render_progressive as j_progressive)
from simd_raytracer_tpu.utils.ppm import ppm_bytes as j_ppm_bytes
from simd_raytracer_tpu.utils.profiling import (
    wavefront_occupancy as j_occupancy)
from simd_raytracer_tpu_torch.__main__ import main as cli_main
from simd_raytracer_tpu_torch.models import camera as cam
from simd_raytracer_tpu_torch.models.loader import parse_scene_file
from simd_raytracer_tpu_torch.models.scene import SCENE_TENSOR_FIELDS
from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
from simd_raytracer_tpu_torch.parallel import tiles
from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
from simd_raytracer_tpu_torch.utils import animation, checkpoint, profiling
from simd_raytracer_tpu_torch.utils.ppm import ppm_bytes, read_ppm, save_ppm
from torch_parity import JaxUniforms, port_scene
from torch_scenes import mixed_doc

torch.set_num_threads(2)

DOC = mixed_doc(20, 24, g=12, subdiv=2)


@pytest.fixture(scope="module")
def scenes():
    js = J.parse_scene_dict(DOC)
    return js, port_scene(js)


@pytest.fixture()
def scene_file(tmp_path):
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(DOC))
    return str(path)


# --- tiles -------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    (SchedulingType.SINGLE, {}),
    (SchedulingType.REGION_GRID, dict(workers=9)),
    (SchedulingType.REGION_GRID, dict(workers=2)),
    (SchedulingType.BUCKET_TILES, dict(bucket=7)),
    (SchedulingType.BUCKET_TILES, dict(bucket=64)),
], ids=["single", "region9", "region2", "bucket7", "bucket64"])
def test_schedule_matches_jax_and_covers_once(kind, kw):
    h, w = 33, 47
    got = tiles.make_schedule(kind, h, w, **kw)
    ref = j_tiles.make_schedule(j_tiles.SchedulingType(kind.value), h, w,
                                **kw)
    assert [tuple(vars(t).values()) for t in got] == \
        [tuple(vars(t).values()) for t in ref]
    cover = np.zeros((h, w), np.int32)
    for t in got:
        cover[t.y0:t.y1, t.x0:t.x1] += 1
    assert (cover == 1).all()
    chunks = tiles.schedule_to_chunks(got, w, 2, 128, h * w * 2)
    assert np.array_equal(chunks, j_tiles.schedule_to_chunks(
        ref, w, 2, 128, h * w * 2))
    flat = chunks.reshape(-1)
    assert np.array_equal(np.sort(flat[flat < h * w * 2]),
                          np.arange(h * w * 2))


def test_tile_ray_ids_and_region_default():
    assert tiles.tile_ray_ids(tiles.RenderTile(2, 1, 4, 2), width=8,
                              spp=2).tolist() == [20, 21, 22, 23]
    # No card here: one region, the whole image.
    assert tiles.region_schedule(10, 12) == [tiles.RenderTile(0, 0, 12, 10)]


@pytest.mark.parametrize("kind", [SchedulingType.SINGLE,
                                  SchedulingType.BUCKET_TILES])
def test_make_ray_chunks_with_scheduling_matches_jax(scenes, kind):
    js, ts = scenes
    kw = dict(samples_per_pixel=2, chunk_size=96)
    got = make_ray_chunks(ts, T.RenderConfig(**kw), kind)
    ref = j_chunks(js, J.RenderConfig(**kw),
                   j_tiles.SchedulingType(kind.value))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", list(SchedulingType))
def test_scheduled_render_equals_linear(scenes, kind):
    """spp 1 is jitter-free, so the tile order changes no pixel."""
    _, ts = scenes
    cfg = T.RenderConfig(chunk_size=128, max_ray_depth=2)
    a = T.render_frame(ts, cfg, device="cpu")
    b = T.render_frame(ts, cfg, device="cpu", scheduling=kind)
    assert torch.equal(a, b)


# --- camera ------------------------------------------------------------

@pytest.mark.parametrize("move,arg", [
    ("translate", [0.3, -0.2, 0.5]), ("truck", 0.7), ("pedestal", -0.4),
    ("dolly", 1.3), ("pan", 25.0), ("tilt", -12.0), ("roll", 40.0)])
def test_camera_moves_match_jax(scenes, move, arg):
    js, ts = scenes
    ref = getattr(j_cam, move)(js, arg)
    got = getattr(cam, move)(ts, arg)
    for f in ("cam_pos", "cam_mat"):
        x = getattr(got, f)
        assert x.dtype == getattr(ts, f).dtype
        np.testing.assert_allclose(x.numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6)
    assert torch.equal(got.vertices, ts.vertices)


def test_camera_moves_keep_float64(scenes):
    _, ts = scenes
    f64 = ts.map(lambda t: t.double() if t.is_floating_point() else t)
    moved = cam.roll(cam.pan(cam.dolly(f64, 0.5), 10.0), 5.0)
    ref = cam.roll(cam.pan(cam.dolly(ts, 0.5), 10.0), 5.0)
    assert moved.cam_pos.dtype == moved.cam_mat.dtype == torch.float64
    for f in ("cam_pos", "cam_mat"):
        np.testing.assert_allclose(getattr(moved, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=0,
                                   atol=1e-6)


# --- animation ---------------------------------------------------------

def test_orbit_path_matches_jax_and_renders_distinct_frames(scenes,
                                                            tmp_path):
    js, ts = scenes
    frames = list(animation.orbit_path(ts, n_frames=3))
    ref = list(j_orbit(js, n_frames=3))
    for f, r in zip(frames, ref):
        np.testing.assert_allclose(f.cam_pos.numpy(), np.asarray(r.cam_pos),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(f.cam_mat.numpy(), np.asarray(r.cam_mat),
                                   rtol=0, atol=1e-6)
    imgs = animation.render_animation(
        frames, T.RenderConfig(chunk_size=256, max_ray_depth=1),
        out_dir=str(tmp_path), prefix="orbit", device="cpu")
    assert len(imgs) == 3 and all(i.shape == (20, 24, 3) for i in imgs)
    assert not torch.equal(imgs[0], imgs[1])
    assert not torch.equal(imgs[1], imgs[2])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "orbit_0000.ppm", "orbit_0001.ppm", "orbit_0002.ppm"]
    assert read_ppm(str(tmp_path / "orbit_0002.ppm")).shape == (20, 24, 3)


def test_dolly_path_moves_along_view_axis(scenes):
    _, ts = scenes
    frames = list(animation.dolly_path(ts, n_frames=3, total_dist=1.0))
    assert len(frames) == 3 and frames[0] is ts
    # Two steps of 0.5 along the third row of the orientation matrix.
    step = (frames[2].cam_pos - frames[0].cam_pos).numpy()
    np.testing.assert_allclose(step, ts.cam_mat[2].numpy(), rtol=0,
                               atol=1e-6)


# --- progressive rendering ---------------------------------------------

PROGRESSIVE = dict(chunk_size=256, max_ray_depth=2, bounce_mode="roulette")


def test_progressive_matches_jax_with_its_uniforms(scenes):
    js, ts = scenes
    jcfg = J.RenderConfig(**PROGRESSIVE)
    n_chunks = -(-ts.height * ts.width * 2 // jcfg.chunk_size)

    def uniforms(b):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(jcfg.rng_seed), b),
            n_chunks)
        return lambda c: JaxUniforms(keys[c])

    ref = j_progressive(js, jcfg, total_spp=4, spp_per_batch=2)
    got = checkpoint.render_progressive(
        ts, T.RenderConfig(**PROGRESSIVE), total_spp=4, spp_per_batch=2,
        device="cpu", uniforms=uniforms)
    assert got.shape == (20, 24, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_progressive_resume_repeats_the_uninterrupted_render(scenes,
                                                             tmp_path):
    _, ts = scenes
    cfg = T.RenderConfig(**PROGRESSIVE)
    ck = str(tmp_path / "render.ckpt.npz")
    full = checkpoint.render_progressive(ts, cfg, total_spp=6,
                                         spp_per_batch=2, device="cpu")

    class Stop(Exception):
        pass

    def interrupt(done, _img):
        if done >= 2:
            raise Stop

    with pytest.raises(Stop):
        checkpoint.render_progressive(ts, cfg, total_spp=6, spp_per_batch=2,
                                      checkpoint_path=ck, on_batch=interrupt,
                                      device="cpu")
    with np.load(ck) as state:
        assert int(state["samples_done"]) == 2
        assert set(state.files) == {"accum", "samples_done", "fingerprint"}
    seen = []
    resumed = checkpoint.render_progressive(
        ts, cfg, total_spp=6, spp_per_batch=2, checkpoint_path=ck,
        on_batch=lambda done, img: seen.append(done), device="cpu")
    assert seen == [4, 6]
    np.testing.assert_array_equal(resumed, full)
    # Batches draw different samples.
    one = checkpoint.render_progressive(ts, cfg, total_spp=2,
                                        spp_per_batch=2, device="cpu")
    assert not np.array_equal(one, full)

    other = T.RenderConfig(**{**PROGRESSIVE, "max_ray_depth": 1})
    with pytest.warns(UserWarning, match="different scene/config"):
        checkpoint.render_progressive(ts, other, total_spp=2,
                                      spp_per_batch=2, checkpoint_path=ck,
                                      device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        checkpoint.render_progressive(ts, cfg, total_spp=3, spp_per_batch=2,
                                      device="cpu")


# --- profiling ---------------------------------------------------------

def test_phase_timer_accumulates():
    t = profiling.PhaseTimer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    assert set(t.seconds) == {"a", "b"}
    assert "a" in t.report() and "b" in t.report()


@pytest.mark.parametrize("kw", [dict(), dict(bounce_mode="roulette"),
                                dict(intersector="kdtree")],
                         ids=["split", "roulette", "kdtree"])
def test_wavefront_occupancy_is_non_increasing(scenes, kw):
    js, ts = scenes
    cfg = T.RenderConfig(chunk_size=480, **kw)
    if kw.get("bounce_mode") == "roulette":
        occ = profiling.wavefront_occupancy(ts, cfg, torch.arange(480),
                                            device="cpu")
        assert all(a >= b for a, b in zip(occ, occ[1:]))
    else:
        # Split is deterministic at spp 1: the counts equal JAX's.
        occ = profiling.wavefront_occupancy(ts, cfg, torch.arange(480),
                                            device="cpu")
        j_accel = (j_build_kdtree_for_scene(js)
                   if kw.get("intersector") == "kdtree" else None)
        assert occ == j_occupancy(js, J.RenderConfig(**kw, chunk_size=480),
                                  jax.numpy.arange(480, dtype=np.int32),
                                  accel=j_accel)
    assert len(occ) == cfg.max_ray_depth + 1 and occ[0] == 480
    assert occ[1] < occ[0]


def test_profile_render_and_device_trace(scene_file, tmp_path):
    cfg = T.RenderConfig(chunk_size=256, max_ray_depth=1,
                         intersector="kdtree")
    m = profiling.profile_render(scene_file, cfg, scale=0.5, repeats=1,
                                 trace_dir=str(tmp_path / "trace"),
                                 device="cpu")
    for k in ("load", "accel_build", "first_call", "render"):
        assert m[k] > 0, k
    assert (m["height"], m["width"], m["spp"]) == (10, 12, 1)
    assert m["rays_per_sec"] == pytest.approx(120 / m["render"])
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# --- native loader and PPM ---------------------------------------------

def test_native_loader_matches_python(scene_file, tmp_path):
    py = parse_scene_file(scene_file, use_native=False)
    cc = parse_scene_file(scene_file, use_native=True)
    for f in SCENE_TENSOR_FIELDS:
        a, b = getattr(py, f), getattr(cc, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (py.height, py.width, py.bucket_size, py.num_meshes) == \
        (cc.height, cc.width, cc.bucket_size, cc.num_meshes)
    bad = tmp_path / "bad.crtscene"
    bad.write_text('{"settings": {"image_settings": {"height": 4}}}')
    with pytest.raises(ValueError):
        parse_scene_file(str(bad), use_native=True)


def test_native_ppm_matches_python():
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, size=(17, 23, 3)).astype(np.float32)
    ref = j_ppm_bytes(img, use_native=False)
    assert ppm_bytes(img, use_native=False) == ref
    assert ppm_bytes(img, use_native=True) == ref
    assert ppm_bytes(torch.from_numpy(img)) == ref


# --- CLI ---------------------------------------------------------------

@pytest.mark.parametrize("flags,kw,sched", [
    (["--intersector", "kdtree", "--scheduling", "bucket", "--profile"],
     dict(intersector="kdtree"), SchedulingType.BUCKET_TILES),
    (["--ray-order", "tiled", "--scheduling", "region", "--spp", "2",
      "--bounce-mode", "roulette"],
     dict(ray_order="tiled", samples_per_pixel=2, bounce_mode="roulette"),
     SchedulingType.REGION_GRID),
    (["--intersector", "sweep", "--scheduling", "single"],
     dict(intersector="sweep"), SchedulingType.SINGLE),
], ids=["kdtree-bucket-profile", "tiled-region", "sweep-single"])
def test_cli_flags_render(scene_file, tmp_path, capsys, flags, kw, sched):
    out = tmp_path / "out.ppm"
    assert cli_main([scene_file, "-o", str(out), "--max-depth", "2",
                     "--chunk", "256", *flags, "--device", "cpu"]) == 0
    img = T.render_frame(T.parse_scene_file(scene_file),
                         T.RenderConfig(max_ray_depth=2, chunk_size=256,
                                        **kw),
                         device="cpu", scheduling=sched)
    save_ppm(img, str(tmp_path / "expect.ppm"))
    assert out.read_bytes() == (tmp_path / "expect.ppm").read_bytes()
    printed = capsys.readouterr().out
    assert "Rendering took" in printed
    assert ("accel_build" in printed) == ("--profile" in flags)


def test_cli_progressive_checkpoint(scene_file, tmp_path):
    out = tmp_path / "out.ppm"
    ck = tmp_path / "cli.ckpt.npz"
    argv = [scene_file, "-o", str(out), "--max-depth", "2", "--chunk",
            "256", "--spp", "4", "--progressive-batch", "2",
            "--checkpoint", str(ck), "--bounce-mode", "roulette",
            "--device", "cpu"]
    assert cli_main(argv) == 0
    with np.load(ck) as state:
        assert int(state["samples_done"]) == 4
    img = checkpoint.render_progressive(
        T.parse_scene_file(scene_file),
        T.RenderConfig(max_ray_depth=2, chunk_size=256, samples_per_pixel=4,
                       bounce_mode="roulette"),
        total_spp=4, spp_per_batch=2, device="cpu")
    save_ppm(img, str(tmp_path / "expect.ppm"))
    assert out.read_bytes() == (tmp_path / "expect.ppm").read_bytes()
