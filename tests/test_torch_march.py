"""PyTorch port: march occlusion (occlusion_mode="march") and the "fast"
select against the JAX package.

March results are compared exactly, on rays aimed through the glass sphere
of `mixed_doc`.  Fast-select winners may differ from JAX only at a near
tie (|dt| <= 1e-6 * t), as in test_torch_select.py; any-hit exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.accel.sweep import build_sweep_for_scene as j_build
from simd_raytracer_tpu.ops import shade as j_shade
from simd_raytracer_tpu.ops.intersect_mxu import mt_select_fast as j_fast
from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
from simd_raytracer_tpu_torch.ops import intersect as t_isect
from simd_raytracer_tpu_torch.ops import shade as t_shade
from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
from simd_raytracer_tpu_torch.ops.intersect_fast import mt_select_fast
import oracle
from test_torch_select import CASES, _case_args, assert_same_winners, rays
from torch_scenes import mixed_doc

torch.set_num_threads(2)

EPS = 1e-6
GLASS_C = np.array([-2.2, -0.6, -7.0])     # mixed_doc's glass icosphere
N_RAYS = 512


@pytest.fixture(scope="module")
def glass():
    doc = mixed_doc(16, 16, g=8, subdiv=2)
    js, ts = J.parse_scene_dict(doc), T.parse_scene_dict(doc)
    return (js, J.derive_geometry(js), j_build(js),
            ts, T.derive_geometry(ts), build_sweep_for_scene(ts))


def glass_rays(n=N_RAYS, seed=0):
    """Origins around the glass sphere, aimed at points near its centre
    (most cross it), windows from 0.5 to 12."""
    rng = np.random.default_rng(seed)
    o = GLASS_C + rng.normal(scale=2.5, size=(n, 3))
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    aim = GLASS_C + rng.normal(scale=0.8, size=(n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.5, 12.0, n)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


def both_occluded(glass, rays_, **kw):
    js, jg, jacc, ts, tg, tacc = glass
    o, d, tmax = rays_
    kw = dict(occlusion_mode="march", **kw)
    accel = (jacc, tacc) if kw.get("intersector") == "sweep" else (None, None)
    ref = np.asarray(j_shade.occluded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), js, jg,
        J.RenderConfig(**kw), accel[0]))
    got = t_shade.occluded(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tmax), ts, tg,
                           T.RenderConfig(**kw), accel[1])
    assert got.dtype == torch.bool
    return ref, got.numpy()


@pytest.mark.parametrize("max_march", [8, 2])
@pytest.mark.parametrize("intersector", ["jnp", "sweep", "fast"])
def test_march_occluded_matches_jax(glass, intersector, max_march):
    rays_ = glass_rays()
    ref, got = both_occluded(glass, rays_, intersector=intersector,
                             max_shadow_march=max_march)
    np.testing.assert_array_equal(got, ref)
    assert 0.1 < got.mean() < 0.9
    # Glass matters: march differs from the solid-only fast predicate on
    # some rays once the hop cap bites.
    js, jg, jacc, ts, tg, tacc = glass
    o, d, tmax = (torch.from_numpy(x) for x in rays_)
    fast = t_shade.occluded(o, d, tmax, ts, tg,
                            T.RenderConfig(intersector=intersector),
                            tacc if intersector == "sweep" else None)
    crossed = mt_select_brute(o, d, tg.v0, tg.e1, tg.e2, EPS, False,
                              tg.tri_valid & tg.tri_transmissive, tmax,
                              any_hit=True)[1]
    assert crossed.float().mean() > 0.3
    assert np.array_equal(got[~crossed.numpy()], fast.numpy()[~crossed])
    if max_march == 2:
        assert (got != fast.numpy()).any()


def test_march_matches_oracle(glass):
    """The scalar replication of render.hpp:110-131 in tests/oracle.py
    (no hop cap; these rays need at most three hops)."""
    js, _, _, ts, tg, _ = glass
    o, d, tmax = glass_rays(n=256, seed=2)
    cfg = J.RenderConfig(occlusion_mode="march")
    ns = oracle.NumpyScene(js)
    want = np.array([oracle.is_occluded(ns, o[i], d[i], float(tmax[i]), cfg)
                     for i in range(len(o))])
    got = t_shade.occluded(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tmax), ts, tg,
                           T.RenderConfig(occlusion_mode="march"))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_march_reads_the_winner_only_inside_the_window(glass):
    """A window miss may carry any idx (the brute-force kernel returns the
    closest winner beyond the window): pointing every miss at a glass
    triangle must not change a single answer."""
    _, _, _, ts, tg, _ = glass
    o, d, tmax = (torch.from_numpy(x) for x in glass_rays(seed=1))
    glass_id = int(tg.tri_transmissive.nonzero()[0, 0])
    cfg = T.RenderConfig(occlusion_mode="march")
    calls = []
    bound = t_isect.make_select_fn("jnp", geom=tg)

    def lying_select(*args, **kw):
        idx, hit = bound(*args, **kw)
        calls.append(kw.get("any_hit", False))
        return torch.where(hit, idx, glass_id), hit

    honest = t_shade._march(
        t_isect.make_select_fn("jnp", geom=tg), o, d, tmax, tg, cfg)
    lied = t_shade._march(lying_select, o, d, tmax, tg, cfg)
    assert calls and not any(calls)          # closest-hit hops only
    assert torch.equal(lied, honest)
    assert 0 < int(honest.sum()) < len(o)


def test_march_without_glass_is_the_solid_probe(glass):
    """Rays whose window crosses no glass never enter the hop loop."""
    _, _, _, ts, tg, _ = glass
    o, d, tmax = (torch.from_numpy(x) for x in rays(ts.cam_pos, seed=9))
    no_glass = ts.replace(mat_tag=torch.where(ts.mat_tag == 2, 0,
                                              ts.mat_tag))
    g = T.derive_geometry(no_glass)
    march = t_shade.occluded(o, d, tmax, no_glass, g,
                             T.RenderConfig(occlusion_mode="march"))
    fast = t_shade.occluded(o, d, tmax, no_glass, g, T.RenderConfig())
    assert torch.equal(march, fast) and 0 < int(march.sum()) < len(o)


# ---- the fast select --------------------------------------------------------

@pytest.mark.parametrize("cull,masked,windowed,any_hit", CASES)
def test_fast_select_matches_jax(glass, cull, masked, windowed, any_hit):
    js, jg, _, ts, tg, _ = glass
    o, d, tmax = rays(js.cam_pos, n=1024, seed=3)
    jm, tm, jt, tt = _case_args(jg, tg, tmax, masked, windowed)
    ref = j_fast(jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1, jg.e2, EPS,
                 cull, jm, t_max=jt, any_hit=any_hit)
    got = mt_select_fast(torch.from_numpy(o), torch.from_numpy(d), tg.v0,
                         tg.e1, tg.e2, EPS, cull, tm, t_max=tt,
                         any_hit=any_hit)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert_same_winners(jg, o, d, ref, got)
    assert 0 < int(got[1].sum()) < len(o)
    # Against the port's brute force: the same winners up to near ties.
    brute = t_isect.mt_select(torch.from_numpy(o), torch.from_numpy(d),
                              tg.v0, tg.e1, tg.e2, EPS, cull, tm, t_max=tt,
                              any_hit=any_hit)
    assert_same_winners(jg, o, d, brute, got)


def test_fast_select_blocks_agree(glass, monkeypatch):
    """Blocking over triangles changes nothing: one block and many give
    the same winners bit for bit (the lowest index wins a tie)."""
    js, _, _, ts, tg, _ = glass
    o, d, tmax = (torch.from_numpy(x) for x in rays(js.cam_pos, seed=4))
    one = mt_select_fast(o, d, tg.v0, tg.e1, tg.e2, EPS, False, None, tmax)
    from simd_raytracer_tpu_torch.ops import intersect_fast
    monkeypatch.setattr(intersect_fast, "_block", lambda r: 16)
    many = mt_select_fast(o, d, tg.v0, tg.e1, tg.e2, EPS, False, None, tmax)
    assert all(torch.equal(a, b) for a, b in zip(one, many))


def test_refexact_render_matches_jax(glass):
    """The reference-exact estimator: split + march + fast."""
    js, _, _, ts, _, _ = glass
    kw = dict(max_ray_depth=3, chunk_size=256, samples_per_pixel=1,
              occlusion_mode="march", intersector="fast", bounce_skip=False)
    ref = np.asarray(J.render_frame(js, J.RenderConfig(**kw)))
    img = T.render_frame(ts, T.RenderConfig(**kw), device="cpu")
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-4)
