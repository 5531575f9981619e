"""PyTorch port: the kd-tree build, its native builder, the plain kd
traversal, the kdtree select with its window emulation, kdtree renders and
the kdleaf sweep partition, against the JAX package on the same scenes.

Trees, winners and renders on the CPU are compared exactly, except the
port's kdtree render against JAX's (1e-4, as every render parity test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.accel.build import build_kdtree as j_build_kdtree
from simd_raytracer_tpu.accel.build import (
    build_kdtree_for_scene as j_build_for_scene)
from simd_raytracer_tpu.accel.sweep import build_sweep_for_scene as j_sweep
from simd_raytracer_tpu.accel.traverse import kd_select as j_kd_select
from simd_raytracer_tpu.ops.intersect import make_select_fn as j_select_fn
from simd_raytracer_tpu_torch.accel.build import (KDTREE_FIELDS,
                                                  build_kdtree,
                                                  build_kdtree_for_scene,
                                                  kdtree_from_arrays,
                                                  scene_aabbs, tree_depth)
from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
from simd_raytracer_tpu_torch.accel.traverse import kd_select, kd_work_pairs
from simd_raytracer_tpu_torch.native import native_build_kdtree
from simd_raytracer_tpu_torch.ops import intersect_kd, intersect_sweep
from simd_raytracer_tpu_torch.ops.intersect import make_select_fn, mt_select
from torch_parity import port_scene
from torch_scenes import mixed_doc, terrain_doc

torch.set_num_threads(2)

EPS = 1e-6
DOCS = {"mixed": mixed_doc(32, 32, g=16, subdiv=2),
        "dense": mixed_doc(24, 24, g=30, subdiv=3),
        "terrain": terrain_doc(20, 24, 24)}
BUILDS = [(8, 64), (12, 128), (5, 16)]


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, doc in DOCS.items():
        js = J.parse_scene_dict(doc)
        ts = port_scene(js)
        out[name] = (js, J.derive_geometry(js), ts, T.derive_geometry(ts))
    return out


def rays(cam, n=1024, seed=0):
    """Half from the camera, half scattered around it; random directions
    and windows in [0, 25]."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(cam, np.float32), (n, 1))
    o[n // 2:] += rng.normal(scale=2.0, size=(n - n // 2, 3))
    d = rng.normal(size=(n, 3))
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.0, 25.0, n)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


def port_tree(jtree):
    return kdtree_from_arrays({f: np.asarray(getattr(jtree, f))
                               for f in KDTREE_FIELDS})


def assert_trees_equal(a, b):
    for f in KDTREE_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape and np.array_equal(x, y), f
    assert a.depth == b.depth


@pytest.mark.parametrize("build", BUILDS, ids=lambda b: f"d{b[0]}-l{b[1]}")
@pytest.mark.parametrize("name", sorted(DOCS))
def test_kd_build_matches_jax(scenes, name, build):
    js, _, ts, _ = scenes[name]
    got = build_kdtree_for_scene(ts, *build, use_native=False)
    ref = j_build_for_scene(js, *build, use_native=False)
    assert_trees_equal(got, ref)
    assert got.node_min.dtype == torch.float32
    assert got.leaf_tris.dtype == torch.int32
    assert got.leaf_cap % 8 == 0 and got.num_nodes == len(ref.child0)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_native_kd_build_equals_numpy(scenes, name):
    _, _, ts, _ = scenes[name]
    for build in BUILDS:
        assert_trees_equal(build_kdtree_for_scene(ts, *build,
                                                  use_native=True),
                           build_kdtree_for_scene(ts, *build,
                                                  use_native=False))


def test_kd_build_invariants(scenes):
    """tests/test_kdtree.py's invariants on an in-repo scene."""
    _, _, ts, _ = scenes["dense"]
    tree = build_kdtree_for_scene(ts, use_native=False)
    child0, child1 = tree.child0.numpy(), tree.child1.numpy()
    leaf_id, leaf_tris = tree.leaf_id.numpy(), tree.leaf_tris.numpy()
    node_min, node_max = tree.node_min.numpy(), tree.node_max.numpy()
    inner = child0 >= 0
    assert (child1[inner] >= 0).all()
    assert (leaf_id[inner] == -1).all()
    assert (leaf_id[~inner] >= 0).all()
    for c in (child0, child1):
        sel = c[inner]
        assert (node_min[sel] >= node_min[inner] - 1e-6).all()
        assert (node_max[sel] <= node_max[inner] + 1e-6).all()
    valid_ids = np.flatnonzero(ts.tri_valid.numpy())
    present = np.unique(leaf_tris[leaf_tris >= 0])
    assert np.isin(valid_ids, present).all()
    assert not np.isin(np.flatnonzero(~ts.tri_valid.numpy()), present).any()
    tri_min, tri_max, _ = scene_aabbs(ts)
    for n in np.flatnonzero(~inner):
        tris = leaf_tris[leaf_id[n]]
        tris = tris[tris >= 0]
        assert (tri_max[tris] >= node_min[n] - 1e-6).all()
        assert (tri_min[tris] <= node_max[n] + 1e-6).all()
    assert tree.depth == tree_depth(child0, child1) == 8


def test_kd_build_of_no_triangles():
    tree = build_kdtree(np.zeros((4, 3), np.float32),
                        np.zeros((4, 3), np.float32),
                        valid=np.zeros(4, bool))
    ref = j_build_kdtree(np.zeros((4, 3), np.float32),
                         np.zeros((4, 3), np.float32),
                         valid=np.zeros(4, bool))
    assert_trees_equal(tree, ref)
    assert tree.num_nodes == 1 and tree.depth == 0
    native = native_build_kdtree(np.zeros((4, 3), np.float32),
                                 np.zeros((4, 3), np.float32),
                                 np.zeros(4, bool), 8, 64, required=True)
    assert_trees_equal(native, tree)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["mixed", "terrain"])
def test_kd_select_matches_jax_and_brute_force(scenes, name, cull, masked):
    js, jg, ts, tg = scenes[name]
    jtree = j_build_for_scene(js, use_native=False)
    tree = port_tree(jtree)
    o, d, _ = rays(ts.cam_pos.numpy(), seed=1)
    mask = tg.tri_valid.clone()
    if masked:
        mask[::3] = False
    ji, jh = j_kd_select(jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1,
                         jg.e2, EPS, cull, jnp.asarray(mask.numpy()), jtree)
    args = (torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2,
            EPS, cull, mask, tree)
    before = intersect_kd.LAUNCHES
    got = intersect_kd.kd_select_cuda(*args)   # CPU tensors: the plain walk
    assert intersect_kd.LAUNCHES == before
    assert torch.equal(got[0], kd_select(*args)[0])
    ki, kh = got
    assert ki.dtype == torch.int32 and kh.dtype == torch.bool
    assert np.array_equal(kh.numpy(), np.asarray(jh))
    assert np.array_equal(ki.numpy(), np.asarray(ji))
    bi, bh = mt_select(*args[:7], mask)
    assert torch.equal(kh, bh) and torch.equal(ki[kh], bi[bh])
    assert 0 < int(kh.sum()) < len(o)


def test_kd_select_near_tie_on_shared_edges():
    """A flat grid whose triangles share edges and vertices, rays aimed
    exactly at grid points and diagonals (several triangles accept at one
    t), and a small max_leaf so that split planes run through those
    points: the lowest id must win in the kd walk as in brute force.

    Against JAX's kd_select run op by op (jax.disable_jit): exact on every
    ray.  Jitted, XLA fuses the slab test's arithmetic and the JAX walk
    prunes some boxes of this zero-thickness grid that hold the winner
    (ROADMAP §C).  Against brute force: exact on the interior targets; a
    ray at the grid's outer edge meets the root box exactly on its face,
    where the slab test's rounding may leave it out, in both walks."""
    g = 8
    xs = np.linspace(-2.0, 2.0, g + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    verts = np.stack([gx, gy, np.full_like(gx, -3.0)], -1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    v00 = (ii * (g + 1) + jj).ravel()
    tris = np.concatenate([np.stack([v00, v00 + 1, v00 + g + 2], 1),
                           np.stack([v00, v00 + g + 2, v00 + g + 1], 1)])
    doc = {"settings": {"background_color": [0, 0, 0],
                        "image_settings": {"width": 4, "height": 4}},
           "camera": {"position": [0, 0, 0],
                      "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
           "lights": [{"position": [0, 0, 1], "intensity": 1.0}],
           "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                          "smooth_shading": False}],
           "objects": [{"material_index": 0,
                        "vertices": verts.reshape(-1).tolist(),
                        "triangles": tris.reshape(-1).tolist()}]}
    js = J.parse_scene_dict(doc)
    ts = port_scene(js)
    jg, tg = J.derive_geometry(js), T.derive_geometry(ts)
    targets = np.concatenate([verts, 0.5 * (verts[tris[:, 0]]
                                            + verts[tris[:, 2]])])
    rng = np.random.default_rng(2)
    o = rng.normal(scale=0.3, size=(len(targets), 3)).astype(np.float32)
    o[:, 2] = 0.0
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jtree = j_build_for_scene(js, 8, 4, use_native=False)
    tree = port_tree(jtree)
    assert_trees_equal(tree, build_kdtree_for_scene(ts, 8, 4))
    args = (torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2,
            EPS, False, tg.tri_valid)
    ki, kh = kd_select(*args, tree)
    bi, bh = mt_select(*args)
    with jax.disable_jit():
        ji, jh = j_kd_select(jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1,
                             jg.e2, EPS, False, jg.tri_valid, jtree)
    assert np.array_equal(kh.numpy(), np.asarray(jh))
    assert np.array_equal(ki.numpy(), np.asarray(ji))
    inner = torch.from_numpy((np.abs(targets[:, :2]) < 1.99).all(axis=1))
    assert int(inner.sum()) == 169
    assert torch.equal(kh[inner], bh[inner])
    assert torch.equal(ki[inner & kh], bi[inner & bh])
    assert int(kh[inner].sum()) > 150


def test_kd_select_refuses_a_deep_tree(scenes):
    _, _, ts, tg = scenes["mixed"]
    tree = build_kdtree_for_scene(ts)
    o, d, _ = rays(ts.cam_pos.numpy(), n=8)
    with pytest.raises(ValueError, match="stack"):
        kd_select(torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1,
                  tg.e2, EPS, True, None, tree.replace(depth=63))


def test_kd_work_pairs_counts_the_visited_leaves(scenes):
    """The walk's pair count lies between one leaf's live lanes for every
    hitting ray and every live lane of every leaf for every ray; masking
    triangles out lowers it."""
    _, _, ts, tg = scenes["mixed"]
    tree = build_kdtree_for_scene(ts)
    o, d, _ = rays(ts.cam_pos.numpy(), n=256, seed=3)
    args = (torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2,
            EPS, False)
    pairs = kd_work_pairs(*args, tg.tri_valid, tree)
    refs = int((tree.leaf_tris >= 0).sum())
    hits = int(kd_select(*args, tg.tri_valid, tree)[1].sum())
    assert hits <= pairs < len(o) * refs
    masked = tg.tri_valid.clone()
    masked[::2] = False
    assert kd_work_pairs(*args, masked, tree) < pairs


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("cull", [True, False])
def test_kdtree_select_fn_window_matches_jax(scenes, cull, any_hit):
    js, jg, ts, tg = scenes["mixed"]
    jtree = j_build_for_scene(js, use_native=False)
    o, d, tmax = rays(ts.cam_pos.numpy(), seed=4)
    ji, jh = j_select_fn("kdtree", jtree)(
        jnp.asarray(o), jnp.asarray(d), jg.v0, jg.e1, jg.e2, EPS, cull,
        jg.tri_valid, jnp.asarray(tmax), any_hit)
    ki, kh = make_select_fn("kdtree", port_tree(jtree))(
        torch.from_numpy(o), torch.from_numpy(d), tg.v0, tg.e1, tg.e2, EPS,
        cull, tg.tri_valid, torch.from_numpy(tmax), any_hit)
    assert np.array_equal(kh.numpy(), np.asarray(jh))
    assert np.array_equal(ki.numpy(), np.asarray(ji))
    assert 0 < int(kh.sum()) < len(o)
    if any_hit:
        assert not ki.any()


def test_kdtree_select_needs_a_tree():
    with pytest.raises(ValueError, match="accel"):
        make_select_fn("kdtree")


KD_RENDER = dict(max_ray_depth=3, chunk_size=512)


@pytest.mark.parametrize("occlusion", ["fast", "march"])
def test_kdtree_render_equals_brute_force(scenes, occlusion):
    """tests/test_kdtree.py:101-109 on an in-repo scene: the kdtree render
    (tree built by render_frame) equals the brute-force render exactly."""
    _, _, ts, _ = scenes["mixed"]
    kw = dict(occlusion_mode=occlusion, **KD_RENDER)
    img_b = T.render_frame(ts, T.RenderConfig(**kw), device="cpu")
    img_k = T.render_frame(ts, T.RenderConfig(intersector="kdtree", **kw),
                           device="cpu")
    assert torch.equal(img_b, img_k)


def test_kdtree_render_matches_jax(scenes):
    js, _, ts, _ = scenes["mixed"]
    kw = dict(intersector="kdtree", **KD_RENDER)
    ref = np.asarray(J.render_frame(js, J.RenderConfig(**kw)))
    img = T.render_frame(ts, T.RenderConfig(**kw), device="cpu")
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-4)


def test_kdleaf_sweep_build_matches_jax(scenes):
    js, _, ts, _ = scenes["dense"]
    ref = j_sweep(js, partition="kdleaf")
    got = build_sweep_for_scene(ts, partition="kdleaf")
    for f in ("tri_soa", "aabb", "tri_ids"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    ids = got.tri_ids.numpy()
    # Leaves share triangles: some id sits in more than one slice.
    assert len(np.unique(ids[ids >= 0])) < int((ids >= 0).sum())
    with pytest.raises(ValueError, match="partition"):
        build_sweep_for_scene(ts, partition="bvh")


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kdleaf_sweep_select_matches_brute_force(scenes, windowed, any_hit):
    """Slices with duplicated triangles merge on (t, id): the same winners
    as brute force."""
    _, _, ts, tg = scenes["dense"]
    sweep = build_sweep_for_scene(ts, partition="kdleaf")
    o, d, tmax = (torch.from_numpy(x) for x in
                  rays(ts.cam_pos.numpy(), seed=5))
    tm = tmax if windowed else None
    solid = tg.tri_valid & ~tg.tri_transmissive
    got = intersect_sweep.make_sweep_select(sweep)(
        o, d, tg.v0, tg.e1, tg.e2, EPS, False, solid, tm, any_hit)
    ref = mt_select(o, d, tg.v0, tg.e1, tg.e2, EPS, False, solid, tm,
                    any_hit)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0][got[1]], ref[0][ref[1]])
    assert 0 < int(got[1].sum()) < len(o)


def test_kdtree_render_under_jax_uniforms_matches_jax(scenes):
    """A stochastic kdtree render (roulette, spp 2) with JAX's uniforms."""
    from torch_parity import JaxUniforms
    js, _, ts, _ = scenes["mixed"]
    kw = dict(samples_per_pixel=2, bounce_mode="roulette",
              intersector="kdtree", **KD_RENDER)
    jcfg = J.RenderConfig(**kw)
    n_chunks = -(-ts.height * ts.width * 2 // jcfg.chunk_size)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.rng_seed), n_chunks)
    ref = np.asarray(J.render_frame(js, jcfg))
    img = T.render_frame(ts, T.RenderConfig(**kw), device="cpu",
                         uniforms=lambda c: JaxUniforms(keys[c]))
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-4)
