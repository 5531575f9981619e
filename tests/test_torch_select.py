"""PyTorch port: the plain versions of the select kernels against the JAX
package (jnp and Pallas in interpret mode) on the same rays and scenes.

Winners are compared exactly.  Where one differs it must be a near tie:
both triangles accept the ray at t within 1e-6 * t of each other (the
JAX side runs under XLA, which may fuse a*b - c*d into one multiply-add).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.accel.sweep import build_sweep_for_scene as j_build
from simd_raytracer_tpu.ops import intersect as j_isect
from simd_raytracer_tpu.ops import intersect_sweep as j_sweep
from simd_raytracer_tpu.ops.intersect_pallas import mt_select_pallas
from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
from simd_raytracer_tpu_torch.ops import intersect as t_isect
from simd_raytracer_tpu_torch.ops import intersect_brute, intersect_sweep
from simd_raytracer_tpu_torch.utils import profiling
from torch_scenes import mixed_doc, terrain_doc

torch.set_num_threads(2)

EPS = 1e-6
N_RAYS = 1024


@pytest.fixture(scope="module")
def mixed():
    doc = mixed_doc(48, 48, g=16, subdiv=2)
    js, ts = J.parse_scene_dict(doc), T.parse_scene_dict(doc)
    return js, J.derive_geometry(js), ts, T.derive_geometry(ts)


def rays(scene_cam, n=N_RAYS, seed=0):
    """Half from the camera, half scattered around it; random directions
    and per-ray windows between 0 and 25."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(scene_cam, np.float32), (n, 1))
    o[n // 2:] += rng.normal(scale=2.0, size=(n - n // 2, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2])
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.0, 25.0, n)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


def refine_t(jg, o, d, idx):
    t, _, _ = j_isect.mt_refine(jnp.asarray(o), jnp.asarray(d),
                                jg.v0[idx], jg.e1[idx], jg.e2[idx], EPS)
    return np.asarray(t)


def assert_same_winners(jg, o, d, ref, got, check_idx=True):
    """Exact (idx, hit) equality up to near ties."""
    (ri, rh), (gi, gh) = ref, got
    ri, rh = np.asarray(ri), np.asarray(rh)
    gi, gh = np.asarray(gi), np.asarray(gh)
    assert np.array_equal(rh, gh), f"hit differs on {np.sum(rh != gh)} rays"
    if not check_idx:
        return
    diff = np.nonzero(rh & (ri != gi))[0]
    if len(diff):
        ta = refine_t(jg, o[diff], d[diff], ri[diff])
        tb = refine_t(jg, o[diff], d[diff], gi[diff])
        assert np.all(np.abs(ta - tb) <= 1e-6 * np.abs(ta)), (diff, ta, tb)
    assert np.array_equal(ri[~rh], gi[~rh])


CASES = [(cull, masked, windowed, any_hit)
         for cull in (True, False) for masked in (False, True)
         for windowed in (False, True) for any_hit in (False, True)]


def _case_args(jg, tg, tmax, masked, windowed):
    jm = tm = None
    if masked:
        jm = jg.tri_valid & ~jg.tri_transmissive
        tm = tg.tri_valid & ~tg.tri_transmissive
    jt = jnp.asarray(tmax) if windowed else None
    tt = torch.from_numpy(tmax) if windowed else None
    return jm, tm, jt, tt


@pytest.mark.parametrize("cull,masked,windowed,any_hit", CASES)
def test_mt_select_matches_jax(mixed, cull, masked, windowed, any_hit):
    js, jg, ts, tg = mixed
    o, d, tmax = rays(js.cam_pos, seed=1)
    jm, tm, jt, tt = _case_args(jg, tg, tmax, masked, windowed)
    ref = j_isect.mt_select(jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1,
                            jg.e2, EPS, cull, jm, t_max=jt, any_hit=any_hit)
    got = t_isect.mt_select(torch.from_numpy(o), torch.from_numpy(d),
                            tg.v0, tg.e1, tg.e2, EPS, cull, tm, t_max=tt,
                            any_hit=any_hit)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert_same_winners(jg, o, d, ref, got)
    assert 0 < int(got[1].sum()) < N_RAYS


@pytest.mark.parametrize("cull,masked,windowed,any_hit", CASES)
def test_mt_select_reference_matches_pallas(mixed, cull, masked, windowed,
                                            any_hit):
    js, jg, ts, tg = mixed
    o, d, tmax = rays(js.cam_pos, seed=2)
    jm, tm, jt, tt = _case_args(jg, tg, tmax, masked, windowed)
    ref = mt_select_pallas(jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1,
                           jg.e2, EPS, cull, jm, t_max=jt, any_hit=any_hit,
                           interpret=True)
    got = intersect_brute.mt_select_reference(
        torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2, EPS,
        cull, tm, t_max=tt, any_hit=any_hit)
    assert_same_winners(jg, o, d, ref, got)
    # On CPU tensors the wrapper is the plain version and launches nothing.
    with profiling.recording() as rec:
        again = intersect_brute.mt_select_brute(
            torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2,
            EPS, cull, tm, t_max=tt, any_hit=any_hit)
    assert rec.counts["select.launches.brute"] == 0
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_mt_refine_matches_jax(mixed):
    js, jg, ts, tg = mixed
    o, d, _ = rays(js.cam_pos, seed=3)
    idx = np.array(j_isect.mt_select(jnp.asarray(o), jnp.asarray(d),
                                       jg.v0, jg.e1, jg.e2, EPS, False,
                                       jg.tri_valid)[0])
    a = j_isect.mt_refine(jnp.asarray(o), jnp.asarray(d), jg.v0[idx],
                          jg.e1[idx], jg.e2[idx], EPS)
    ti = torch.from_numpy(idx).long()
    b = t_isect.mt_refine(torch.from_numpy(o), torch.from_numpy(d),
                          tg.v0[ti], tg.e1[ti], tg.e2[ti], EPS)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5)


def test_trace_matches_jax(mixed):
    js, jg, ts, tg = mixed
    o, d, _ = rays(js.cam_pos, seed=4)
    a = j_isect.trace(jnp.asarray(o), jnp.asarray(d), js, jg, EPS, True)
    b = t_isect.trace(torch.from_numpy(o), torch.from_numpy(d), ts, tg, EPS,
                      True)
    assert np.array_equal(np.asarray(a.mask), b.mask.numpy())
    for f in ("t", "u", "v", "w", "position", "hit_n", "face_n", "albedo"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in ("idx", "mat_tag", "smooth", "tex", "mesh_idx"):
        assert np.array_equal(getattr(b, f).numpy(),
                              np.asarray(getattr(a, f))), f


def test_build_sweep_matches_jax(mixed):
    js, _, ts, _ = mixed
    a, b = j_build(js), build_sweep_for_scene(ts)
    assert b.r_tile == a.r_tile and b.num_slices == a.num_slices == 5
    for f in ("tri_soa", "aabb", "tri_ids"):
        assert np.array_equal(getattr(b, f).numpy(),
                              np.asarray(getattr(a, f))), f


@pytest.mark.parametrize("windowed", [False, True])
def test_tile_schedule_matches_jax(mixed, windowed):
    js, _, ts, _ = mixed
    o, d, tmax = rays(js.cam_pos, n=2048, seed=5)
    tm = tmax if windowed else np.full(len(o), j_sweep.BIG, np.float32)
    aabb = build_sweep_for_scene(ts).aabb
    ja = j_sweep._tile_reach(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tm), jnp.asarray(aabb.numpy()), 512)
    ta = intersect_sweep._tile_reach(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tm), aabb, 512)
    for x, y in zip(ja, ta):
        assert np.array_equal(y.numpy(), np.asarray(x))
    js_ = j_sweep._tile_schedule(*ja)
    ts_ = intersect_sweep._tile_schedule(*ta)
    for x, y in zip(js_, ts_):
        assert np.array_equal(y.numpy(), np.asarray(x))


def _sweep_case(js, jg, ts, tg, jsw, tsw, o, d, tmax, cull, windowed,
                any_hit):
    jt = jnp.asarray(tmax) if windowed else None
    tt = torch.from_numpy(tmax) if windowed else None
    jm = jg.tri_valid & ~jg.tri_transmissive
    tm = tg.tri_valid & ~tg.tri_transmissive
    ref = j_sweep.make_sweep_select(jsw, interpret=True)(
        jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1, jg.e2, EPS, cull, jm,
        t_max=jt, any_hit=any_hit)
    got = intersect_sweep.make_sweep_select(tsw)(
        torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2, EPS,
        cull, tm, t_max=tt, any_hit=any_hit)
    assert_same_winners(jg, o, d, ref, got, check_idx=not any_hit)
    return got


SWEEP_CASES = [(cull, windowed, any_hit) for cull in (True, False)
               for windowed in (False, True) for any_hit in (False, True)
               if not (any_hit and not windowed)]


@pytest.mark.parametrize("cull,windowed,any_hit", SWEEP_CASES)
def test_sweep_resident_size_matches_jax(mixed, cull, windowed, any_hit):
    """A soup JAX keeps resident (its _kernel_resident)."""
    js, jg, ts, tg = mixed
    jsw = j_build(js)
    assert jsw.tri_soa.size * 4 * 11 // 9 <= j_sweep.RESIDENT_MAX_BYTES
    o, d, tmax = rays(js.cam_pos, n=1000, seed=6)
    got = _sweep_case(js, jg, ts, tg, jsw, build_sweep_for_scene(ts), o, d,
                      tmax, cull, windowed, any_hit)
    # Closest hits also equal the port's brute force, exactly.
    if not any_hit:
        tt = torch.from_numpy(tmax) if windowed else None
        brute = t_isect.mt_select(torch.from_numpy(o), torch.from_numpy(d),
                                  tg.v0, tg.e1, tg.e2, EPS, cull,
                                  tg.tri_valid & ~tg.tri_transmissive,
                                  t_max=tt)
        assert all(torch.equal(a, b) for a, b in zip(got, brute))


@pytest.fixture(scope="module")
def big_terrain():
    """270^2 * 2 = 145,800 triangles: 570 slices, 6.4 MB of soup, which
    JAX streams (its _kernel)."""
    doc = terrain_doc(270, 32, 32)
    js, ts = J.parse_scene_dict(doc), T.parse_scene_dict(doc)
    return js, J.derive_geometry(js), ts, T.derive_geometry(ts)


@pytest.mark.parametrize("windowed,any_hit", [(False, False), (True, True)])
def test_sweep_streaming_size_matches_jax(big_terrain, windowed, any_hit):
    js, jg, ts, tg = big_terrain
    jsw = j_build(js)
    assert jsw.tri_soa.size * 4 * 11 // 9 > j_sweep.RESIDENT_MAX_BYTES
    o, d, tmax = rays(js.cam_pos, n=512, seed=7)
    got = _sweep_case(js, jg, ts, tg, jsw, build_sweep_for_scene(ts), o, d,
                      tmax, False, windowed, any_hit)
    assert 0 < int(got[1].sum()) < len(o)


def test_sweep_reference_counts_no_launch(mixed):
    js, jg, ts, tg = mixed
    o, d, _ = rays(js.cam_pos, n=100, seed=8)
    with profiling.recording() as rec:
        idx, hit = intersect_sweep.make_sweep_select(
            build_sweep_for_scene(ts))(torch.from_numpy(o),
                                       torch.from_numpy(d), tg.v0, tg.e1,
                                       tg.e2, EPS, False)
    assert rec.counts["select.launches.sweep"] == 0
    assert idx.shape == (100,) and hit.dtype == torch.bool
