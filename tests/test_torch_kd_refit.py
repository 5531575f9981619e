"""PyTorch port: the kd tree refitted to each frame's or step's vertices
(RenderConfig.accel_refit with intersector="kdtree", accel/build.py::
refit_kdtree, bound in ops/intersect_kd.py::bind), held against the
brute-force select on moved triangles in plain torch on the CPU, and a
train step through it against JAX's brute-force route in float64.

The frozen tree, JAX's route, keeps its tests in tests/test_torch_kdtree.py;
the kd kernel on a refitted tree is held in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.ops import grad as JG
from simd_raytracer_tpu_torch.accel.build import (build_kdtree_for_scene,
                                                  refit_kdtree)
from simd_raytracer_tpu_torch.accel import traverse
from simd_raytracer_tpu_torch.accel.traverse import kd_select
from simd_raytracer_tpu_torch.models.scene import derive_geometry
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import intersect_brute, intersect_kd
from simd_raytracer_tpu_torch.ops.intersect import (BIG, make_select_fn,
                                                    mt_select)
from simd_raytracer_tpu_torch.ops.render import build_accel, render_chunk
from simd_raytracer_tpu_torch.utils import profiling
from torch_parity import JaxUniforms, port_scene, to_x64
from torch_scenes import SeededUniforms, mixed_doc

torch.set_num_threads(2)

H, W = 12, 16
EPS = 1e-6
MIRROR = 2      # the mirror icosphere's mesh in mixed_doc
# Moves the mirror sphere up, left and toward the camera, well out of the
# leaf cells that list its triangles.
SHIFT = (-1.5, 1.5, 3.0)


@pytest.fixture(scope="module")
def scene():
    """The float32 mixed scene: 896 triangles, a 79-node tree."""
    return T.parse_scene_dict(mixed_doc(H, W, g=8, subdiv=2))


def _moved(scene, mesh=MIRROR, shift=SHIFT):
    vid = scene.tri_vidx[scene.tri_mesh == mesh].long().unique()
    v = scene.vertices.clone()
    v[vid] += torch.tensor(shift, dtype=v.dtype)
    return scene.replace(vertices=v)


def _rays(scene, n=4000, seed=1):
    """Half from the camera, half around it, all looking into the scene;
    windows in [0.5, 12]."""
    rng = np.random.default_rng(seed)
    o = np.tile(scene.cam_pos.numpy(), (n, 1)).astype(np.float32)
    o[n // 2:] += rng.normal(scale=2.0, size=(n - n // 2, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.5, 12.0, n).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)


def _lost(got, want):
    """Rays whose winner or hit flag differs from the brute force's."""
    return (got[1] != want[1]) | (want[1] & (got[0] != want[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("move", [False, True])
def test_refit_boxes_hold_their_triangles_and_children(scene, dtype, move):
    """Every listed triangle's corners lie inside its leaf's box, every
    parent's box holds its children's, and the topology is the build's;
    float64 vertices give float32 boxes rounded outward."""
    s = _moved(scene) if move else scene
    s = s.map(lambda t: t.to(dtype) if t.is_floating_point() else t)
    tree = build_kdtree_for_scene(scene)
    got = refit_kdtree(tree, s.vertices, s.tri_vidx)
    for f in ("child0", "child1", "leaf_id", "leaf_tris"):
        assert torch.equal(getattr(got, f), getattr(tree, f)), f
    assert got.node_min.dtype == got.node_max.dtype == torch.float32
    lo, hi = got.node_min.to(dtype), got.node_max.to(dtype)
    corners = s.vertices[s.tri_vidx.long()]                  # (T, 3, 3)
    for node in range(tree.num_nodes):
        leaf = int(tree.leaf_id[node])
        if leaf >= 0:
            ids = tree.leaf_tris[leaf]
            c = corners[ids[ids >= 0].long()].reshape(-1, 3)
            assert bool((c >= lo[node]).all() and (c <= hi[node]).all())
            if dtype == torch.float32 and c.numel():
                assert torch.equal(lo[node], c.amin(dim=0))
                assert torch.equal(hi[node], c.amax(dim=0))
        else:
            for child in (tree.child0[node], tree.child1[node]):
                if _is_empty_leaf(tree, child):
                    continue
                assert bool((lo[node] <= lo[child]).all()
                            and (hi[node] >= hi[child]).all())


def _is_empty_leaf(tree, node):
    leaf = int(tree.leaf_id[node])
    return leaf >= 0 and not bool((tree.leaf_tris[leaf] >= 0).any())


def test_an_empty_leaf_gets_a_box_no_ray_enters(scene):
    """A leaf that lists nothing adds nothing to its parent's union and
    gets the point box at +inf."""
    tree = build_kdtree_for_scene(scene)
    node = int((tree.leaf_id >= 0).nonzero()[0, 0])
    parent = int(((tree.child0 == node) | (tree.child1 == node)
                  ).nonzero()[0, 0])
    sibling = int(tree.child0[parent] + tree.child1[parent]) - node
    emptied = tree.replace(leaf_tris=tree.leaf_tris.clone())
    emptied.leaf_tris[tree.leaf_id[node]] = -1
    got = refit_kdtree(emptied, scene.vertices, scene.tri_vidx)
    assert bool((got.node_min[node] == np.inf).all())
    assert bool((got.node_max[node] == np.inf).all())
    assert torch.equal(got.node_min[parent], got.node_min[sibling])
    assert torch.equal(got.node_max[parent], got.node_max[sibling])


@pytest.mark.parametrize("move", [False, True])
def test_the_refitted_walk_never_visits_an_empty_leaf(scene, move,
                                                      monkeypatch):
    """The plain walk pops the empty leaves of the refitted tree (the test
    scene's tree has six) and its slab test and prune reject every one, so
    no ray makes an empty leaf pending."""
    s = _moved(scene) if move else scene
    tree = build_kdtree_for_scene(scene)
    assert sum(_is_empty_leaf(tree, n) for n in range(tree.num_nodes)) > 0
    got = refit_kdtree(tree, s.vertices, s.tri_vidx)
    popped, entered = [], []
    plain_slab = traverse._slab

    def slab(o, inv_d, bmin, bmax):
        t_near, hit = plain_slab(o, inv_d, bmin, bmax)
        empty = (bmin == np.inf).all(dim=1) & (bmax == np.inf).all(dim=1)
        popped.append(int(empty.sum()))
        entered.append(int((empty & hit & (t_near <= BIG)).sum()))
        return t_near, hit

    monkeypatch.setattr(traverse, "_slab", slab)
    o, d, _ = _rays(s)
    geom = derive_geometry(s)
    kd_select(o, d, geom.v0, geom.e1, geom.e2, EPS, False, None, got)
    assert sum(popped) > 0
    assert sum(entered) == 0


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("move", [False, True])
def test_refitted_kd_winners_equal_brute_force(scene, move, any_hit,
                                               windowed):
    """The kdtree select bound on the (moved) geometry through the normal
    binding: its winners and hit flags are mt_select's, bit for bit."""
    g = derive_geometry(_moved(scene) if move else scene)
    tree = build_kdtree_for_scene(scene).replace(refit=True)
    o, d, tmax = _rays(scene)
    args = (o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid,
            tmax if windowed else None, any_hit)
    want = make_select_fn("jnp", geom=g)(*args)
    got = make_select_fn("kdtree", tree, g)(*args)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert 0.05 < float(want[1].float().mean()) < 0.95


@pytest.mark.parametrize("cull", [False, True])
def test_frozen_walk_loses_winners_that_the_refit_keeps(scene, cull):
    """The fault a refit cures: once the mirror sphere has left the cells
    that list it, the walk on the build's boxes prunes rays that hit it
    (a counted set, all of them hits on the moved mesh), and the walk on
    the refitted boxes loses none."""
    m = _moved(scene)
    g = derive_geometry(m)
    tree = build_kdtree_for_scene(scene)
    o, d, _ = _rays(scene)
    args = (o, d, g.v0, g.e1, g.e2, EPS, cull, g.tri_valid)
    want = mt_select(*args)
    frozen = _lost(kd_select(*args, tree), want)
    refit = _lost(kd_select(*args, refit_kdtree(tree, m.vertices,
                                                m.tri_vidx)), want)
    assert int(frozen.sum()) >= 100
    on_mesh = want[1] & (g.tri_mesh[want[0].long()] == MIRROR)
    assert bool(on_mesh[frozen].all())
    assert not refit.any()


def test_accel_refit_is_accepted_with_the_kd_tree(scene):
    """RenderConfig takes accel_refit with "kdtree", and build_accel marks
    the tree; without accel_refit the tree is the build's, unmarked."""
    cfg = T.RenderConfig(intersector="kdtree", accel_refit=True)
    tree = build_accel(scene, cfg)
    assert tree.refit
    plain = build_accel(scene, T.RenderConfig(intersector="kdtree"))
    assert not plain.refit
    assert torch.equal(tree.node_min, plain.node_min)


def test_accel_refit_refuses_a_kd_tree_not_marked_for_it(scene):
    """accel_refit with a kd tree built without the configuration is
    refused, not walked on the build's boxes; a marked tree bound without
    geometry is refused too."""
    cfg = T.RenderConfig(intersector="kdtree", accel_refit=True,
                         max_ray_depth=1, chunk_size=32)
    with pytest.raises(ValueError, match="accel_refit"):
        render_chunk(scene, derive_geometry(scene), cfg,
                     torch.arange(32, dtype=torch.int32),
                     SeededUniforms(0, 0), build_kdtree_for_scene(scene))
    with pytest.raises(ValueError, match="geometry"):
        make_select_fn("kdtree", build_accel(scene, cfg))


def test_frames_through_the_refitted_kd_tree_equal_brute_force(scene):
    """render_frame of the moved scene on the tree built from the scene
    as it was: with accel_refit the frame is the brute-force frame bit
    for bit; on the build's boxes it is not."""
    m = _moved(scene)
    frames = {}
    for name, render in (("brute", {}),
                         ("refit", dict(intersector="kdtree",
                                        accel_refit=True)),
                         ("frozen", dict(intersector="kdtree"))):
        cfg = T.RenderConfig(max_ray_depth=3, chunk_size=64, **render)
        accel = build_accel(scene, cfg)
        frames[name] = T.render_frame(m, cfg, device="cpu", accel=accel)
    assert torch.equal(frames["refit"], frames["brute"])
    assert not torch.equal(frames["frozen"], frames["brute"])


def _split_cfg(**render):
    return T.RenderConfig(max_ray_depth=3, chunk_size=H * W, **render)


def test_train_steps_through_the_refitted_kd_tree_equal_brute_force(
        scene, monkeypatch):
    """Three SGD steps with split bounces at a large rate, from the scene
    with the mirror sphere moved, on the tree built before the move:
    every select of every step, shadow queries included, has mt_select's
    winners and hit flags on that step's own triangles, one refit a step;
    the losses and parameters are the brute-force route's, and those of
    the build's boxes are not."""
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

    def steps(cfg):
        params, skeleton = G.split_params(_moved(scene))
        n = H * W
        return G.train_steps(params, skeleton, cfg,
                             torch.arange(n, dtype=torch.int32),
                             torch.full((n, 3), 0.1),
                             lambda i: SeededUniforms(5, i), lr=0.2,
                             n_steps=3, accel=build_accel(scene, cfg))

    want_p, want_l = steps(_split_cfg())
    frozen_p, frozen_l = steps(_split_cfg(intersector="kdtree"))
    monkeypatch.setattr(intersect_kd, "bind", bind)
    with profiling.recording() as rec:
        got_p, got_l = steps(_split_cfg(intersector="kdtree",
                                        accel_refit=True))
    assert rec.counts["kd.refit.calls"] == 3
    assert len(calls) > 9
    for got, want in calls:
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-6)
    for k in G.DIFF_PARAM_NAMES:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert not np.allclose(frozen_l.numpy(), want_l.numpy(), rtol=1e-3)


def test_train_steps_through_the_refitted_kd_tree_match_jax_in_float64():
    """Three SGD steps, split bounces, float64 on both sides: the port
    through the refitted kd tree against JAX's brute-force jnp route."""
    lr = 0.05
    with enable_x64():
        js = to_x64(J.parse_scene_dict(mixed_doc(H, W, g=8, subdiv=2)))
        jp, jsk = JG.split_params(js)
        tsk = port_scene(js)
        tp = G.params_from_arrays({k: np.asarray(v) for k, v in jp.items()},
                                  device="cpu")
        n = H * W
        ids = np.arange(n, dtype=np.int32)
        target = np.full((n, 3), 0.1)
        key = jax.random.PRNGKey(3)
        keys = jax.random.split(key, 3)
        j_params, j_losses = JG.train_steps(
            jax.tree_util.tree_map(jnp.array, jp), jsk,
            J.RenderConfig(max_ray_depth=3, chunk_size=n, bounce_skip=False),
            jnp.asarray(ids), jnp.asarray(target), key, lr=lr, n_steps=3)
        cfg = _split_cfg(intersector="kdtree", accel_refit=True,
                         bounce_skip=False)
        t_params, t_losses = G.train_steps(
            tp, tsk, cfg, torch.from_numpy(ids), torch.from_numpy(target),
            lambda i: JaxUniforms(keys[i], jnp.float64), lr=lr, n_steps=3,
            accel=build_accel(tsk, cfg))
    assert t_losses.dtype == torch.float64
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses),
                               rtol=1e-9)
    for k in G.DIFF_PARAM_NAMES:
        np.testing.assert_allclose(t_params[k].numpy(),
                                   np.asarray(j_params[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


def _bind_and_select(scene):
    g = derive_geometry(_moved(scene))
    o, d, tmax = _rays(scene, n=500)
    tree = build_kdtree_for_scene(scene).replace(refit=True)
    select = make_select_fn("kdtree", tree, g)
    select(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid)
    select(o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax, True)
    return tree


def test_kd_refit_records_its_span_and_counters_while_recording(scene):
    """One refit a binding: span `refit`, `kd.refit.calls` and
    `kd.refit.nodes` (the tree's nodes); outside recording() nothing is
    recorded."""
    profiling.reset()
    _bind_and_select(scene)
    assert profiling.record() == {"spans": {}, "counts": {}}
    with profiling.recording() as rec:
        tree = _bind_and_select(scene)
    data = rec.read()
    assert data["spans"]["refit"]["calls"] == 1
    assert data["counts"]["kd.refit.calls"] == 1
    assert data["counts"]["kd.refit.nodes"] == tree.num_nodes == 79
    profiling.reset()


def test_without_accel_refit_the_kd_walk_reads_the_build(scene):
    """An unmarked tree is bound as it was built: no refit, no span, the
    build's boxes in the pack."""
    g = derive_geometry(_moved(scene))
    tree = build_kdtree_for_scene(scene)
    with profiling.recording() as rec:
        select = make_select_fn("kdtree", tree, g)
    assert "refit" not in rec.read()["spans"]
    assert rec.counts["kd.refit.calls"] == 0
    pack = select.keywords["pack"]
    assert torch.equal(pack.box, torch.cat([tree.node_min, tree.node_max],
                                           dim=1))
