"""PyTorch port: the "mxu" select (numerators as one float32 matrix product
a block, torch.matmul) against the JAX package's `mt_select_mxu`, and the
render and CLI that reach it.

JAX's own bar (tests/test_bounce_modes.py:86-123): the two sides sum the
ten products of each numerator in another order (XLA's dot against
torch.matmul), so near-tie winners may flip; hit flags agree on more than
99.9% of rays and the winners where both hit on more than 99.9%.  Renders
agree to 2e-3 * max(1, |a|) on more than 99% of values."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.ops.intersect_mxu import mt_select_mxu as j_mxu
from simd_raytracer_tpu_torch.__main__ import main as cli_main
from simd_raytracer_tpu_torch.ops import intersect_mxu as M
from simd_raytracer_tpu_torch.ops.intersect import make_select_fn, mt_select
from simd_raytracer_tpu_torch.utils.ppm import save_ppm
from test_torch_select import CASES, _case_args, rays
from torch_parity import JaxUniforms
from torch_scenes import mixed_doc

torch.set_num_threads(2)

EPS = 1e-6


@pytest.fixture(scope="module")
def mixed():
    doc = mixed_doc(16, 20, g=16, subdiv=2)
    js, ts = J.parse_scene_dict(doc), T.parse_scene_dict(doc)
    return js, J.derive_geometry(js), ts, T.derive_geometry(ts)


def assert_jax_bar(ref, got):
    (ri, rh), (gi, gh) = ((np.asarray(i), np.asarray(h)) for i, h in (ref,
                                                                      got))
    assert (rh == gh).mean() > 0.999, (rh != gh).sum()
    both = rh & gh
    assert (ri[both] == gi[both]).mean() > 0.999


@pytest.mark.parametrize("cull,masked,windowed,any_hit", CASES)
def test_mxu_select_matches_jax(mixed, cull, masked, windowed, any_hit):
    js, jg, ts, tg = mixed
    o, d, tmax = rays(js.cam_pos, seed=11)
    jm, tm, jt, tt = _case_args(jg, tg, tmax, masked, windowed)
    ref = j_mxu(jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1, jg.e2, EPS,
                cull, jm, t_max=jt, any_hit=any_hit)
    got = make_select_fn("mxu", geom=tg)(
        torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2, EPS,
        cull, tm, t_max=tt, any_hit=any_hit)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert_jax_bar(ref, got)
    assert 0 < int(got[1].sum()) < len(o)
    # Against the port's brute force, to the same bar.
    assert_jax_bar(mt_select(torch.from_numpy(o), torch.from_numpy(d), tg.v0,
                             tg.e1, tg.e2, EPS, cull, tm, t_max=tt,
                             any_hit=any_hit), got)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_mxu_blocks_agree(mixed, monkeypatch, windowed, any_hit):
    """Blocking over rays and triangles changes nothing: the default blocks
    and blocks of 100 rays x 16 triangles give the same winners bit for
    bit (each product element is one row times one column)."""
    _, _, ts, tg = mixed
    o, d, tmax = (torch.from_numpy(x) for x in rays(ts.cam_pos, seed=12))
    args = (o, d, tg.v0, tg.e1, tg.e2, EPS, False, tg.tri_valid,
            tmax if windowed else None, any_hit)
    one = M.mt_select_mxu(*args)
    monkeypatch.setattr(M, "RAY_BLOCK", 100)
    monkeypatch.setattr(M, "tri_block", lambda r: 16)
    many = M.mt_select_mxu(*args)
    assert all(torch.equal(a, b) for a, b in zip(one, many))
    assert 0 < int(one[1].sum()) < len(o)


def test_full_f32_matmul_is_scoped():
    """The product runs with TF32 off whatever the global setting, which is
    restored after the select."""
    prev = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with M.full_f32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32
        o = torch.zeros(4, 3)
        d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
        v0 = torch.tensor([[-1.0, -1.0, -5.0]])
        M.mt_select_mxu(o, d, v0, torch.tensor([[2.0, 0.0, 0.0]]),
                        torch.tensor([[0.0, 2.0, 0.0]]), EPS, False)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)


def test_mxu_render_matches_jnp_and_jax(mixed):
    """JAX's test_mxu_render_matches_jnp on an in-repo scene: spp 4 (jitter
    keeps pixel centres off shared edges), depth 3; the port's mxu render
    against its jnp render and against JAX's mxu render with JAX's
    uniforms injected."""
    js, _, ts, _ = mixed
    kw = dict(chunk_size=2048, max_ray_depth=3, samples_per_pixel=4,
              bounce_skip=False)
    jcfg = J.RenderConfig(intersector="mxu", **kw)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.rng_seed), 1)
    uniforms = lambda c: JaxUniforms(keys[c])   # noqa: E731
    a = T.render_frame(ts, T.RenderConfig(**kw), device="cpu",
                       uniforms=uniforms).numpy()
    b = T.render_frame(ts, T.RenderConfig(intersector="mxu", **kw),
                       device="cpu", uniforms=uniforms).numpy()
    c = np.asarray(J.render_frame(js, jcfg))
    assert np.isfinite(b).all() and b.shape == (16, 20, 3)
    for ref in (a, c):
        scale = np.maximum(1.0, np.abs(ref))
        assert (np.abs(ref - b) <= 2e-3 * scale).mean() > 0.99
    assert (b != ts.background.numpy()).any()


def test_cli_renders_mxu(tmp_path):
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(mixed_doc(16, 20, g=16, subdiv=2)))
    out = tmp_path / "out.ppm"
    assert cli_main([str(path), "-o", str(out), "--max-depth", "2",
                     "--intersector", "mxu", "--device", "cpu"]) == 0
    img = T.render_frame(T.parse_scene_file(str(path)),
                         T.RenderConfig(max_ray_depth=2, intersector="mxu"),
                         device="cpu")
    save_ppm(img, str(tmp_path / "expect.ppm"))
    assert out.read_bytes() == (tmp_path / "expect.ppm").read_bytes()
