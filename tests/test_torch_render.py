"""PyTorch port: the whole forward render slice against JAX `render_frame`
on the same scene, with JAX's own uniforms injected where the estimator is
stochastic."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.ops.render import make_ray_chunks as j_chunks
from simd_raytracer_tpu_torch.__main__ import main as cli_main
from simd_raytracer_tpu_torch.ops.render import fold_chunk, make_ray_chunks
from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
from simd_raytracer_tpu_torch.utils import profiling
from simd_raytracer_tpu_torch.utils.ppm import read_ppm, save_ppm
from torch_parity import JaxUniforms, port_scene
from torch_scenes import mixed_doc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scenes():
    doc = mixed_doc(48, 48, g=16, subdiv=2)
    js = J.parse_scene_dict(doc)
    return js, {"arrays": port_scene(js), "parsed": T.parse_scene_dict(doc)}


@pytest.mark.parametrize("source", ["arrays", "parsed"])
def test_split_render_matches_jax(scenes, source):
    js, ts = scenes
    kw = dict(max_ray_depth=3, chunk_size=2048)
    ref = np.asarray(J.render_frame(js, J.RenderConfig(**kw)))
    img = T.render_frame(ts[source], T.RenderConfig(**kw), device="cpu")
    assert img.shape == (48, 48, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("source", ["arrays", "parsed"])
def test_roulette_sweep_render_matches_jax(scenes, source):
    js, ts = scenes
    kw = dict(max_ray_depth=3, chunk_size=2048, samples_per_pixel=2,
              bounce_mode="roulette", intersector="sweep")
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    chunks = make_ray_chunks(ts[source], tcfg)
    assert np.array_equal(chunks, j_chunks(js, jcfg))
    keys = jax.random.split(jax.random.PRNGKey(jcfg.rng_seed), len(chunks))
    ref = np.asarray(J.render_frame(js, jcfg))
    img = T.render_frame(ts[source], tcfg, device="cpu",
                         uniforms=lambda c: JaxUniforms(keys[c]))
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-4)


def test_roulette_render_with_torch_generator(scenes):
    _, ts = scenes
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=1024,
                         samples_per_pixel=2, bounce_mode="roulette")
    a = T.render_frame(ts["parsed"], cfg, device="cpu")
    b = T.render_frame(ts["parsed"], cfg, device="cpu")
    c = T.render_frame(ts["parsed"], T.RenderConfig(
        **{**cfg.__dict__, "rng_seed": 7}), device="cpu")
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert (a != ts["parsed"].background).any()


def test_cpu_render_launches_no_kernel(scenes):
    _, ts = scenes
    with profiling.recording() as rec:
        T.render_frame(ts["parsed"].replace(height=8, width=8),
                       T.RenderConfig(max_ray_depth=2, intersector="sweep",
                                      bounce_mode="roulette"), device="cpu")
    assert (rec.counts["select.launches.brute"],
            rec.counts["select.launches.sweep"]) == (0, 0)


@pytest.mark.parametrize("flags,kw", [
    (["--intersector", "sweep", "--bounce-mode", "roulette", "--spp", "2"],
     dict(intersector="sweep", bounce_mode="roulette", samples_per_pixel=2)),
    (["--gi-rays", "1", "--occlusion", "march", "--intersector", "fast"],
     dict(diffuse_reflection_ray_count=1, occlusion_mode="march",
          intersector="fast")),
], ids=["roulette-sweep", "gi-march-fast"])
def test_cli_writes_the_render(tmp_path, scenes, flags, kw):
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(mixed_doc(48, 48, g=16, subdiv=2)))
    out = tmp_path / "out.ppm"
    assert cli_main([str(path), "-o", str(out), "--width", "20",
                     "--height", "12", "--max-depth", "2", *flags,
                     "--device", "cpu"]) == 0
    img = T.render_frame(
        T.parse_scene_file(str(path)).replace(width=20, height=12),
        T.RenderConfig(max_ray_depth=2, **kw), device="cpu")
    save_ppm(img, str(tmp_path / "expect.ppm"))
    assert out.read_bytes() == (tmp_path / "expect.ppm").read_bytes()
    assert read_ppm(str(out)).shape == (12, 20, 3)


def _fold_by_chunks(chunks, colors, hw, spp, total):
    """NumPy model of the fold-back: within a chunk each run of one
    pixel's samples summed in sample order, the runs added to their pixels
    in chunk order."""
    accum = np.zeros((hw, 3), np.float32)
    for ids, col in zip(chunks, colors):
        run_pix, run = None, None
        for i, c in zip(ids, col):
            if i >= total:
                continue
            p = i // spp
            if p != run_pix:
                if run_pix is not None:
                    accum[run_pix] += run
                run_pix, run = p, c.copy()
            else:
                run = run + c
        if run_pix is not None:
            accum[run_pix] += run
    return accum


@pytest.mark.parametrize("spp", [4, 8])
@pytest.mark.parametrize("chunk_size", [96, 100], ids=["aligned", "split"])
@pytest.mark.parametrize("order", ["linear", "tiled", "bucket", "region",
                                   "single"])
def test_fold_back_equals_numpy_reshape_sum(scenes, order, chunk_size, spp):
    """fold_chunk over every chunk of a frame against a NumPy per-pixel
    reshape-sum of the same sample colors, with padding ids (tiled blocks
    past the image edge, the last chunk's tail) carrying garbage colors.
    With chunk_size a multiple of spp the two are equal bit for bit (at
    spp 8 too, where a pairwise sum would not be); at 100 (a multiple of
    neither 4 nor 8) a pixel may straddle two chunks, whose
    partial sums add in chunk order: equal to that NumPy model bit for
    bit, and to the reshape-sum within float32 rounding."""
    _, ts = scenes
    h, w = 20, 37
    scene = ts["parsed"].replace(height=h, width=w, bucket_size=16)
    cfg = T.RenderConfig(samples_per_pixel=spp, chunk_size=chunk_size,
                         ray_order="tiled" if order == "tiled" else "linear")
    sched = {"bucket": SchedulingType.BUCKET_TILES,
             "region": SchedulingType.REGION_GRID,
             "single": SchedulingType.SINGLE}.get(order)
    chunks = make_ray_chunks(scene, cfg, sched)
    total = h * w * spp
    assert (chunks >= total).any()
    rng = np.random.default_rng(len(order) * chunk_size + spp)
    table = rng.random((total, 3), dtype=np.float32)
    colors = np.where((chunks < total)[..., None],
                      table[np.minimum(chunks, total - 1)],
                      rng.random(chunks.shape + (3,), dtype=np.float32))
    accum = torch.zeros((h * w, 3))
    for ids, col in zip(chunks, colors):
        fold_chunk(accum, torch.from_numpy(ids), torch.from_numpy(col), spp,
                   total)
    got = accum.numpy()
    ref = table.reshape(h * w, spp, 3).sum(axis=1)
    assert np.array_equal(got, _fold_by_chunks(chunks, colors, h * w, spp,
                                               total))
    if chunk_size % spp == 0:
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_import_pulls_in_no_jax():
    code = ("import sys, simd_raytracer_tpu_torch, "
            "simd_raytracer_tpu_torch.__main__, "
            "simd_raytracer_tpu_torch.ops.render, "
            "simd_raytracer_tpu_torch.ops.grad, "
            "simd_raytracer_tpu_torch.ops.intersect_fast, "
            "simd_raytracer_tpu_torch.ops.intersect_mxu, "
            "simd_raytracer_tpu_torch.ops.intersect_kd, "
            "simd_raytracer_tpu_torch.accel.traverse, "
            "simd_raytracer_tpu_torch.parallel.tiles, "
            "simd_raytracer_tpu_torch.parallel.sharding, "
            "simd_raytracer_tpu_torch.graft_entry, "
            "simd_raytracer_tpu_torch.models.camera, "
            "simd_raytracer_tpu_torch.utils.animation, "
            "simd_raytracer_tpu_torch.utils.checkpoint, "
            "simd_raytracer_tpu_torch.utils.profiling, "
            "simd_raytracer_tpu_torch.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'simd_raytracer_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
