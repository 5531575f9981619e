"""PyTorch port: scene model, loader, PPM, camera and textures against the
JAX package on the same inputs."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.models.camera import primary_rays as j_primary_rays
from simd_raytracer_tpu.models.scene import build_scene as j_build_scene
from simd_raytracer_tpu.models.textures import sample_texture as j_sample
from simd_raytracer_tpu.ops.intersect_pallas import (
    pack_triangles as j_pack_triangles)
from simd_raytracer_tpu.utils import ppm as j_ppm
from simd_raytracer_tpu_torch.models.camera import primary_rays
from simd_raytracer_tpu_torch.models.scene import (SCENE_TENSOR_FIELDS,
                                                   build_scene,
                                                   scene_from_arrays)
from simd_raytracer_tpu_torch.models.textures import sample_texture
from simd_raytracer_tpu_torch.ops import (intersect_brute, intersect_fast,
                                          intersect_kd)
from simd_raytracer_tpu_torch.ops.intersect import make_select_fn
from simd_raytracer_tpu_torch.ops.render import build_accel
from simd_raytracer_tpu_torch.utils import ppm
from test_loader import minimal_doc
from torch_scenes import (bitmap_scene_kwargs, mixed_doc, terrain_doc)

torch.set_num_threads(2)

DOCS = {
    "minimal": lambda: minimal_doc(),
    "mixed": lambda: mixed_doc(24, 32, g=8, subdiv=1),
    "terrain": lambda: terrain_doc(6, 12, 16),
}


def jax_arrays(js):
    return {f: np.asarray(getattr(js, f)) for f in SCENE_TENSOR_FIELDS}


def from_jax(js):
    return scene_from_arrays(jax_arrays(js), height=js.height,
                             width=js.width, bucket_size=js.bucket_size,
                             num_meshes=js.num_meshes)


def assert_scene_equal(js, ts):
    assert (ts.height, ts.width, ts.bucket_size, ts.num_meshes) == (
        js.height, js.width, js.bucket_size, js.num_meshes)
    for f in SCENE_TENSOR_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name", sorted(DOCS))
def test_parse_scene_dict_matches_jax(name):
    doc = DOCS[name]()
    js = J.parse_scene_dict(doc)
    assert_scene_equal(js, T.parse_scene_dict(doc))
    assert_scene_equal(js, from_jax(js))


def test_parse_scene_file_matches_jax(tmp_path):
    path = tmp_path / "mixed.crtscene"
    path.write_text(json.dumps(DOCS["mixed"]()))
    assert_scene_equal(J.parse_scene_file(str(path), use_native=False),
                       T.parse_scene_file(str(path)))


def test_build_scene_bitmap_matches_jax():
    kw = bitmap_scene_kwargs(16, 16)
    js = j_build_scene(**kw)
    ts = build_scene(**kw)
    assert_scene_equal(js, ts)
    assert int(ts.tex_width[3]) == 8 and ts.atlas.shape == (64, 3)


def test_scene_from_arrays_follows_vertex_dtype():
    arrays = jax_arrays(J.parse_scene_dict(DOCS["minimal"]()))
    arrays["vertices"] = arrays["vertices"].astype(np.float64)
    ts = scene_from_arrays(arrays, height=6, width=8, bucket_size=64,
                           num_meshes=1)
    assert ts.vertices.dtype == torch.float64
    assert ts.mat_albedo.dtype == torch.float64
    assert ts.tri_vidx.dtype == torch.int32
    assert ts.tri_valid.dtype == torch.bool


@pytest.mark.parametrize("name", ["minimal", "mixed"])
def test_derive_geometry_matches_jax(name):
    js = J.parse_scene_dict(DOCS[name]())
    jg = J.derive_geometry(js)
    for ts in (T.parse_scene_dict(DOCS[name]()), from_jax(js)):
        tg = T.derive_geometry(ts)
        for f in ("v0", "e1", "e2", "face_n", "vn", "uv"):
            np.testing.assert_allclose(getattr(tg, f).numpy(),
                                       np.asarray(getattr(jg, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
        for f in ("tri_mat", "tri_mesh", "tri_valid", "tri_transmissive"):
            assert np.array_equal(getattr(tg, f).numpy(),
                                  np.asarray(getattr(jg, f))), f


@pytest.mark.parametrize("name", ["minimal", "mixed"])
def test_geometry_packs_triangles_as_jax(name):
    """The brute-force kernel's (9, T) layout, packed by the select's
    binding to a frame's geometry: the JAX pack_triangles of the same
    geometry."""
    js = J.parse_scene_dict(DOCS[name]())
    jg = J.derive_geometry(js)
    tg = T.derive_geometry(T.parse_scene_dict(DOCS[name]()))
    soa = make_select_fn("jnp", geom=tg).keywords["tri_soa"]
    assert soa.dtype == torch.float32 and soa.is_contiguous()
    assert not soa.requires_grad
    assert torch.equal(soa, torch.cat([tg.v0.T, tg.e1.T, tg.e2.T]))
    np.testing.assert_allclose(
        soa.numpy(), np.asarray(j_pack_triangles(jg.v0, jg.e1, jg.e2)),
        rtol=0, atol=1e-6)


# intersector -> the backend module, the function there that builds the
# table its select reads, and the binding's keyword for that table.
BOUND = {"jnp": (intersect_brute, "pack_triangles", "tri_soa"),
         "fast": (intersect_fast, "fast_table", "table"),
         "kdtree": (intersect_kd, "pack_kd", "pack")}


@pytest.mark.parametrize("intersector", sorted(BOUND))
def test_select_is_bound_once_per_geometry(intersector, monkeypatch):
    """make_select_fn(name, accel, g) builds its select's table from g's
    own triangles once for the Geometry object and the accel: the same
    binding comes back on every later call, another Geometry or accel
    gets its own, and a frame, whose selects share one Geometry, builds
    one table."""
    module, table_fn, keyword = BOUND[intersector]
    real = getattr(module, table_fn)
    seen = []

    def counted(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, table_fn, counted)
    s = T.parse_scene_dict(DOCS["mixed"]())
    cfg = T.RenderConfig(max_ray_depth=3, chunk_size=512,
                         occlusion_mode="march", intersector=intersector)
    accel = build_accel(s, cfg)
    g = T.derive_geometry(s)
    select = make_select_fn(intersector, accel, g)
    assert make_select_fn(intersector, accel, g) is select
    assert len(seen) == 1
    assert all(a is b for a, b in zip(
        [x for x in seen[0] if torch.is_tensor(x)], (g.v0, g.e1, g.e2)))
    assert select.keywords[keyword] is not None
    assert make_select_fn(intersector, accel,
                          T.derive_geometry(s)) is not select
    assert len(seen) == 2
    if accel is not None:
        assert make_select_fn(intersector, build_accel(s, cfg),
                              g) is not select
        assert len(seen) == 3
    seen.clear()
    T.render_frame(s.replace(height=8, width=8), cfg, device="cpu")
    assert len(seen) == 1


@pytest.mark.parametrize("how", ["to", "map", "replace"])
def test_derived_geometry_starts_unbound(how):
    """A Geometry made from another by .to(), .map() or .replace() carries
    none of its selects: a binding holds the tables of the triangles it
    was built from."""
    g = T.derive_geometry(T.parse_scene_dict(DOCS["mixed"]()))
    select = make_select_fn("fast", geom=g)
    made = {"to": lambda: g.to("cpu"),
            "map": lambda: g.map(lambda t: t.clone()),
            "replace": lambda: g.replace(v0=g.v0 + 1.0)}[how]()
    assert made is not g and made.selects == {}
    assert make_select_fn("fast", geom=made) is not select
    assert make_select_fn("fast", geom=g) is select


@pytest.mark.parametrize("case", ["vertices", "material", "triangles",
                                  "lights", "texture", "albedo"])
def test_loader_rejects_malformed(case):
    doc = minimal_doc()
    if case == "vertices":
        doc["objects"][0]["vertices"] = [0, 0, 0, 1]
    elif case == "material":
        doc["materials"] = [{"type": "weird", "albedo": [1, 1, 1]}]
    elif case == "triangles":
        doc["objects"][0]["triangles"] = [0, 1]
    elif case == "lights":
        del doc["lights"]
    elif case == "texture":
        doc["textures"] = [{"name": "x", "type": "noise"}]
    else:
        doc["materials"] = [{"type": "diffuse", "albedo": "nope",
                             "smooth_shading": False}]
    with pytest.raises(ValueError):
        J.parse_scene_dict(doc)
    with pytest.raises(ValueError):
        T.parse_scene_dict(doc)


def test_loader_quirks():
    doc = minimal_doc(
        textures=[{"name": "tex0", "type": "albedo", "albedo": [0, 1, 0]}],
        materials=[{"type": "diffuse", "albedo": "tex0",
                    "smooth_shading": True}])
    doc["objects"][0]["uvs"] = [0.1, 0.2, 9.0, 0.3, 0.4, 9.0, 0.5, 0.6, 9.0]
    ts = T.parse_scene_dict(doc)
    assert ts.bucket_size == 64
    assert int(ts.mat_tag[0]) == 4 and bool(ts.mat_smooth[0])
    np.testing.assert_allclose(ts.uv[0].numpy(),
                               [[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]])
    assert_scene_equal(J.parse_scene_dict(doc), ts)


def test_ppm_bytes_identical(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, size=(7, 9, 3)).astype(np.float32)
    img[0, :4, 0] = [0.0, 1.0, 1.0 / 255.999, 128.0 / 255.999]
    expect = j_ppm.ppm_bytes(img, use_native=False)
    assert ppm.ppm_bytes(img) == expect
    assert ppm.ppm_bytes(torch.from_numpy(img)) == expect
    buf = io.StringIO()
    ppm.write_ppm(img, buf)
    assert buf.getvalue().encode() == expect
    path = str(tmp_path / "x.ppm")
    ppm.save_ppm(torch.from_numpy(img), path)
    assert np.array_equal(ppm.read_ppm(path), j_ppm.read_ppm(path))
    assert np.array_equal(ppm.read_ppm(path), ppm.image_to_u8(img))


@pytest.mark.parametrize("jitter", [False, True])
def test_primary_rays_match_jax(jitter):
    doc = DOCS["mixed"]()
    js, ts = J.parse_scene_dict(doc), T.parse_scene_dict(doc)
    rng = np.random.default_rng(1)
    n = 300
    px = rng.integers(0, js.width, n).astype(np.int32)
    py = rng.integers(0, js.height, n).astype(np.int32)
    j = (rng.random((2, n)).astype(np.float32) if jitter
         else np.full((2, n), 0.5, np.float32))
    jo, jd = j_primary_rays(js, 75.0, jnp.asarray(px), jnp.asarray(py),
                            jnp.asarray(j[0]), jnp.asarray(j[1]))
    to, td = primary_rays(ts, 75.0, torch.from_numpy(px),
                          torch.from_numpy(py), torch.from_numpy(j[0]),
                          torch.from_numpy(j[1]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tag", [0, 1, 2, 3])
def test_sample_texture_matches_jax(tag):
    kw = bitmap_scene_kwargs(16, 16)
    js, ts = j_build_scene(**kw), build_scene(**kw)
    rng = np.random.default_rng(tag)
    n = 500
    uvw = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    # UVs reach below zero: the checker must truncate toward zero
    # (C++ casts and %), and the bitmap must clamp.
    uvs = rng.uniform(-1.5, 1.5, (n, 3, 2)).astype(np.float32)
    tex = np.full(n, tag, np.int32)
    args = (uvw[:, 0], uvw[:, 1], uvw[:, 2], uvs)
    a = np.asarray(j_sample(js, jnp.asarray(tex),
                            *(jnp.asarray(x) for x in args)))
    b = sample_texture(ts, torch.from_numpy(tex),
                       *(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    # albedo is one constant color; every other sampler varies over UVs
    assert (len(np.unique(b, axis=0)) > 1) == (tag != 0)
