"""PyTorch port: diffuse GI (diffuse_reflection_ray_count > 0) against the
JAX package, with JAX's own uniforms injected.

The JAX renders run with bounce_skip=False: the cond-free graph compiles
in half the time and gives the same values (config.py of the JAX package);
the port ignores the flag."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.ops import intersect as j_isect
from simd_raytracer_tpu.ops import shade as j_shade
from simd_raytracer_tpu_torch.ops import intersect as t_isect
from simd_raytracer_tpu_torch.ops import shade as t_shade
from simd_raytracer_tpu_torch.ops.render import make_ray_chunks, render_chunk
from torch_parity import JaxUniforms, port_scene
from torch_scenes import SeededUniforms, mixed_doc

torch.set_num_threads(2)

EPS = 1e-6
MODES = {"split-jnp": dict(),
         "roulette-sweep": dict(bounce_mode="roulette", intersector="sweep",
                                samples_per_pixel=2)}


@pytest.fixture(scope="module")
def scenes():
    js = J.parse_scene_dict(mixed_doc(12, 12, g=8, subdiv=2))
    return js, port_scene(js)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("gi", [1, 2])
def test_gi_render_matches_jax(scenes, gi, mode):
    js, ts = scenes
    kw = dict(max_ray_depth=3, chunk_size=64, bounce_skip=False,
              diffuse_reflection_ray_count=gi, **MODES[mode])
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    ref = np.asarray(J.render_frame(js, jcfg))
    keys = jax.random.split(jax.random.PRNGKey(jcfg.rng_seed),
                            len(make_ray_chunks(ts, tcfg)))
    img = T.render_frame(ts, tcfg, device="cpu",
                         uniforms=lambda c: JaxUniforms(keys[c]))
    assert img.shape == (12, 12, 3) and torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-4)


def _hit_records(js, ts, n=96, seed=0):
    """Camera rays through the scene, traced by JAX; the same records as
    the port's HitRecord."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(js.cam_pos), (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d[:, 1] -= 0.3
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jg = J.derive_geometry(js)
    jh = j_isect.trace(jnp.asarray(o), jnp.asarray(d), js, jg, EPS, True)
    th = t_isect.HitRecord(**{
        f: torch.from_numpy(np.array(getattr(jh, f)))
        for f in (x.name for x in dataclasses.fields(jh))})
    return jg, jh, th, d


@pytest.mark.parametrize("mode", ["split", "roulette"])
@pytest.mark.parametrize("gi", [1, 2])
def test_gi_shade_matches_jax(scenes, gi, mode):
    """Contrib and children of one bounce on identical hit records."""
    js, ts = scenes
    jg, jh, th, d = _hit_records(js, ts)
    n = d.shape[0]
    rng = np.random.default_rng(gi)
    weight = rng.uniform(0.2, 1.0, n).astype(np.float32)
    weight[::7] = 0.0                        # dead rays
    coin = rng.random(n, dtype=np.float32)
    rnd_gi = rng.random((n, gi, 2), dtype=np.float32)
    kw = dict(diffuse_reflection_ray_count=gi, bounce_mode=mode)
    jc, jch = j_shade.shade(
        js, jg, jh, jnp.asarray(d), jnp.asarray(weight), J.RenderConfig(**kw),
        jax.random.PRNGKey(0), rnd_coin=jnp.asarray(coin),
        rnd_gi=jnp.asarray(rnd_gi))
    tc, tch = t_shade.shade(
        ts, T.derive_geometry(ts), th, torch.from_numpy(d),
        torch.from_numpy(weight), T.RenderConfig(**kw),
        rnd_coin=torch.from_numpy(coin), rnd_gi=torch.from_numpy(rnd_gi))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    for a, b, name in zip(jch, tch, ("o", "d", "weight", "miss_bg")):
        if name == "miss_bg":
            assert np.array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-5, err_msg=name)
    diffuse = (th.mask & (th.mat_tag == 0)).numpy() & (weight > 0)
    assert diffuse.sum() >= 10
    if mode == "split":
        w = tch[2].reshape(n, -1).numpy()
        assert w.shape[1] == max(2, gi)
        np.testing.assert_allclose(w[diffuse, :gi],
                                   np.repeat(weight[diffuse, None] / (gi + 1),
                                             gi, axis=1), rtol=1e-6)
        if gi == 1:
            assert (w[diffuse, 1] == 0.0).all()    # slot 1 stays empty
    else:
        np.testing.assert_allclose(tch[2].numpy()[diffuse],
                                   weight[diffuse] * gi / (gi + 1),
                                   rtol=1e-6)


class RecordingUniforms(SeededUniforms):
    def __init__(self):
        super().__init__(0, 0)
        self.calls = []

    def gi(self, depth, n, count):
        self.calls.append((depth, n, count))
        return super().gi(depth, n, count)


def test_gi_uniforms_drawn_at_full_wavefront_width(scenes):
    _, ts = scenes
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=64,
                         diffuse_reflection_ray_count=3)
    src = RecordingUniforms()
    chunk = torch.from_numpy(make_ray_chunks(ts, cfg)[0])
    render_chunk(ts, T.derive_geometry(ts), cfg, chunk, src)
    # Split widens by K = 3 per bounce; no draw at the last depth.
    assert src.calls == [(0, 64, 3), (1, 192, 3), (2, 576, 3)]


def test_gi_render_with_torch_generator(scenes):
    _, ts = scenes
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=2,
                         bounce_mode="roulette",
                         diffuse_reflection_ray_count=2)
    a = T.render_frame(ts, cfg, device="cpu")
    b = T.render_frame(ts, cfg, device="cpu")
    assert torch.isfinite(a).all() and torch.equal(a, b)
    no_gi = T.render_frame(ts, T.RenderConfig(
        **{**cfg.__dict__, "diffuse_reflection_ray_count": 0}), device="cpu")
    assert not torch.equal(a, no_gi)
