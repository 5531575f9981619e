"""PyTorch port: gradients and SGD steps (ops/grad.py) against the JAX
package, and against finite differences.

Both sides differentiate the same float64 params (JAX's split_params output
carried over by params_from_arrays) with the same uniforms; the selects
run in float32 on both sides, so the winners agree.  The finite-difference
checks are those of tests/test_grad.py, run on the port in float64 on an
in-repo scene with the same steps and tolerances (the originals read
scene files that are not in the repository)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.accel.sweep import build_sweep_for_scene as j_build
from simd_raytracer_tpu.ops import grad as JG
from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
from simd_raytracer_tpu_torch.models.scene import build_scene
from simd_raytracer_tpu_torch.ops import grad as G
from torch_parity import JaxUniforms, port_scene, to_x64
from torch_scenes import SeededUniforms, bitmap_scene_kwargs, mixed_doc

torch.set_num_threads(2)

H, W = 12, 16
# The train path (roulette + sweep, GI), the split brute-force path (float32
# winners on the port, float64 on JAX: equal on these rays) and split GI.
JAX_CASES = {
    "roulette-sweep-gi1": dict(bounce_mode="roulette", intersector="sweep",
                               samples_per_pixel=2,
                               diffuse_reflection_ray_count=1),
    "split-jnp": dict(),
    "split-sweep-gi2": dict(intersector="sweep",
                            diffuse_reflection_ray_count=2),
}


@pytest.fixture(scope="module")
def jax_pair():
    """The float64 scene on both sides, with their sweep accels."""
    with enable_x64():
        js = to_x64(J.parse_scene_dict(mixed_doc(H, W, g=8, subdiv=2)))
        jp, jsk = JG.split_params(js)
        tsk = port_scene(js)
        tp = G.params_from_arrays({k: np.asarray(v) for k, v in jp.items()},
                                  device="cpu")
        return jp, jsk, j_build(js), tp, tsk, build_sweep_for_scene(tsk)


def _cfg(mod, name):
    return mod.RenderConfig(max_ray_depth=3, chunk_size=H * W * 2,
                            bounce_skip=False, **JAX_CASES[name])


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_loss_and_grad_matches_jax(jax_pair, name):
    jp, jsk, jacc, tp, tsk, tacc = jax_pair
    with enable_x64():
        jcfg = _cfg(J, name)
        n = H * W * jcfg.samples_per_pixel
        ids = np.arange(n, dtype=np.int32)
        target = np.full((n, 3), 0.1)
        key = jax.random.PRNGKey(7)
        accel = (jacc, tacc) if jcfg.intersector == "sweep" else (None, None)
        j_loss, j_grads = JG.loss_and_grad(
            jp, jsk, jcfg, jnp.asarray(ids), jnp.asarray(target), key,
            accel[0])
        t_loss, t_grads = G.loss_and_grad(
            tp, tsk, _cfg(T, name), torch.from_numpy(ids),
            torch.from_numpy(target), JaxUniforms(key, jnp.float64),
            accel[1])
    assert t_loss.dtype == torch.float64
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-9)
    assert set(t_grads) == set(G.DIFF_PARAM_NAMES)
    for k in G.DIFF_PARAM_NAMES:
        np.testing.assert_allclose(t_grads[k].numpy(), np.asarray(j_grads[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for k in ("vertices", "mat_albedo", "light_intensity", "background"):
        assert t_grads[k].abs().max() > 0, k


def test_train_steps_matches_jax(jax_pair):
    jp, jsk, jacc, tp, tsk, tacc = jax_pair
    name = "roulette-sweep-gi1"
    with enable_x64():
        jcfg = _cfg(J, name)
        n = H * W * jcfg.samples_per_pixel
        ids = np.arange(n, dtype=np.int32)
        target = np.full((n, 3), 0.1)
        key = jax.random.PRNGKey(3)
        keys = jax.random.split(key, 3)
        j_params, j_losses = JG.train_steps(
            jax.tree_util.tree_map(jnp.array, jp), jsk, jcfg,
            jnp.asarray(ids), jnp.asarray(target), key, lr=2e-3, n_steps=3,
            accel=jacc)
        t_params, t_losses = G.train_steps(
            tp, tsk, _cfg(T, name), torch.from_numpy(ids),
            torch.from_numpy(target),
            lambda i: JaxUniforms(keys[i], jnp.float64), lr=2e-3, n_steps=3,
            accel=tacc)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses),
                               rtol=1e-9)
    for k in G.DIFF_PARAM_NAMES:
        np.testing.assert_allclose(t_params[k].numpy(),
                                   np.asarray(j_params[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


# ---- finite differences (tests/test_grad.py on the port) ------------------

@pytest.fixture(scope="module")
def fd_setup():
    """Float64 mixed scene (all five materials, three texture tags), split,
    brute force, depth 3, all 12x16 primary rays, zero target."""
    s = T.parse_scene_dict(mixed_doc(H, W, g=8, subdiv=2))
    s = s.map(lambda t: t.double() if t.is_floating_point() else t)
    params, skeleton = G.split_params(s)
    cfg = T.RenderConfig(chunk_size=H * W, max_ray_depth=3)
    ids = torch.arange(H * W)
    target = torch.zeros((H * W, 3), dtype=torch.float64)
    return params, skeleton, cfg, ids, target


def fd_check(setup, name, flat_index, h=1e-5, rtol=5e-4, atol=1e-9):
    params, skeleton, cfg, ids, target = setup
    src = SeededUniforms(7, 0)
    _, grads = G.loss_and_grad(params, skeleton, cfg, ids, target, src)
    g_val = float(grads[name].reshape(-1)[flat_index])

    def perturbed(delta):
        p = dict(params)
        arr = params[name].clone()
        arr.view(-1)[flat_index] += delta
        p[name] = arr
        return float(G.pixel_loss(p, skeleton, cfg, ids, target, src))

    fd = (perturbed(h) - perturbed(-h)) / (2 * h)
    assert fd != 0.0, f"{name}[{flat_index}] does not reach the loss"
    assert np.isclose(g_val, fd, rtol=rtol, atol=max(atol, abs(fd) * rtol)), (
        f"{name}[{flat_index}]: analytic {g_val:.6g} vs fd {fd:.6g}")
    return grads


def test_albedo_gradient_matches_fd(fd_setup):
    fd_check(fd_setup, "mat_albedo", 0)     # diffuse terrain, red


def test_light_intensity_gradient_matches_fd(fd_setup):
    fd_check(fd_setup, "light_intensity", 0, h=1e-4)


def test_light_position_gradient_matches_fd(fd_setup):
    fd_check(fd_setup, "light_pos", 1)


def test_vertex_gradient_matches_fd(fd_setup):
    params, skeleton, cfg, ids, target = fd_setup
    _, grads = G.loss_and_grad(params, skeleton, cfg, ids, target,
                               SeededUniforms(7, 0))
    # The z of the vertex whose gradient is largest, as the original nudges
    # a vertex along depth; a step of 1e-4 as there.
    v = int(grads["vertices"].abs().sum(dim=1).argmax())
    fd_check(fd_setup, "vertices", 3 * v + 2, h=1e-4, rtol=2e-3)


def test_background_gradient_matches_fd(fd_setup):
    fd_check(fd_setup, "background", 1)


def test_ior_gradient_matches_fd(fd_setup):
    refr = int(np.where(fd_setup[1].mat_tag.numpy() == 2)[0][0])
    fd_check(fd_setup, "mat_ior", refr, rtol=2e-3)


def test_texture_param_gradients_flow(fd_setup):
    grads = fd_check(fd_setup, "tex_color_a", 0)   # the checker's color A
    assert float(grads["tex_color_b"].abs().max()) > 0
    # The bitmap texels get gradients on the scene that has a bitmap.
    s = build_scene(**bitmap_scene_kwargs(8, 8)).map(
        lambda t: t.double() if t.is_floating_point() else t)
    params, skeleton = G.split_params(s)
    _, g = G.loss_and_grad(params, skeleton, T.RenderConfig(max_ray_depth=2),
                           torch.arange(64), torch.zeros(64, 3,
                                                        dtype=torch.float64),
                           SeededUniforms(7, 0))
    assert float(g["atlas"].abs().max()) > 0


def test_loss_and_grad_of_padding_ids_is_zero(fd_setup):
    """Ids past the frame reach no param: zero gradients, as JAX's grad
    gives, and the loss of zero colors."""
    params, skeleton, cfg, ids, _ = fd_setup
    target = torch.full((len(ids), 3), 0.5, dtype=torch.float64)
    loss, grads = G.loss_and_grad(params, skeleton, cfg, ids + len(ids),
                                  target, SeededUniforms(7, 0))
    assert float(loss) == 0.25
    for k, g in grads.items():
        assert g.shape == params[k].shape and not g.any(), k


# ---- SGD steps ------------------------------------------------------------

def _darker_target(setup):
    params, skeleton, cfg, ids, _ = setup
    dark = dict(params, mat_albedo=params["mat_albedo"] * 0.5)
    with torch.no_grad():
        return G.render_ids(G.merge_params(dark, skeleton), cfg, ids,
                            SeededUniforms(7, 0))


def test_train_step_reduces_loss(fd_setup):
    params, skeleton, cfg, ids, _ = fd_setup
    target = _darker_target(fd_setup)
    p, losses = params, []
    for _ in range(5):
        p, loss = G.train_step(p, skeleton, cfg, ids, target,
                               SeededUniforms(7, 0), lr=2e-3)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert not any(v.requires_grad for v in p.values())


def test_train_steps_matches_unrolled_single_steps(fd_setup):
    params, skeleton, _, ids, _ = fd_setup
    cfg = T.RenderConfig(chunk_size=H * W, max_ray_depth=3,
                         bounce_mode="roulette",
                         diffuse_reflection_ray_count=1)
    target = _darker_target(fd_setup)
    p_ref, ref_losses = params, []
    for i in range(3):
        p_ref, loss = G.train_step(p_ref, skeleton, cfg, ids, target,
                                   SeededUniforms(11, i), lr=2e-3)
        ref_losses.append(float(loss))
    p_loop, losses = G.train_steps(params, skeleton, cfg, ids, target,
                                   lambda i: SeededUniforms(11, i), lr=2e-3,
                                   n_steps=3)
    assert losses.tolist() == ref_losses
    for k in p_ref:
        assert torch.equal(p_loop[k], p_ref[k]), k


@pytest.mark.parametrize("kw", [
    dict(diffuse_reflection_ray_count=2),
    dict(diffuse_reflection_ray_count=1, bounce_mode="roulette",
         samples_per_pixel=2, occlusion_mode="march"),
], ids=["split-gi2", "roulette-gi1-march"])
def test_gradients_finite_on_all_materials(kw):
    s = T.parse_scene_dict(mixed_doc(10, 10, g=8, subdiv=2))
    params, skeleton = G.split_params(s)
    cfg = T.RenderConfig(max_ray_depth=3, **kw)
    n = 100 * cfg.samples_per_pixel
    loss, grads = G.loss_and_grad(params, skeleton, cfg, torch.arange(n),
                                  torch.zeros(n, 3), SeededUniforms(5, 0))
    assert torch.isfinite(loss)
    for k, g in grads.items():
        assert g.shape == params[k].shape and torch.isfinite(g).all(), k
    for k in ("vertices", "mat_albedo", "mat_ior", "tex_color_a",
              "light_pos", "light_intensity", "background"):
        assert grads[k].abs().max() > 0, k
