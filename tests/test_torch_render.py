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
from simd_raytracer_tpu_torch.ops import intersect_brute, intersect_sweep
from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
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
    before = (intersect_brute.LAUNCHES, intersect_sweep.LAUNCHES)
    T.render_frame(ts["parsed"].replace(height=8, width=8),
                   T.RenderConfig(max_ray_depth=2, intersector="sweep",
                                  bounce_mode="roulette"), device="cpu")
    assert (intersect_brute.LAUNCHES, intersect_sweep.LAUNCHES) == before


@pytest.mark.parametrize("kw,item", [
    (dict(intersector="mxu"), "A14"),
])
def test_unported_configs_raise(scenes, kw, item):
    _, ts = scenes
    with pytest.raises(NotImplementedError, match=item):
        T.render_frame(ts["parsed"], T.RenderConfig(**kw), device="cpu")


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


def test_import_pulls_in_no_jax():
    code = ("import sys, simd_raytracer_tpu_torch, "
            "simd_raytracer_tpu_torch.__main__, "
            "simd_raytracer_tpu_torch.ops.render, "
            "simd_raytracer_tpu_torch.ops.grad, "
            "simd_raytracer_tpu_torch.ops.intersect_fast, "
            "simd_raytracer_tpu_torch.ops.intersect_kd, "
            "simd_raytracer_tpu_torch.accel.traverse, "
            "simd_raytracer_tpu_torch.parallel.tiles, "
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
