"""PyTorch port: the plain functions around the split select kernels, on
the CPU.

The CUDA kernels split a call over a second grid dimension
(`kernels.split`) and merge winners with an atomicMin over packed (t, id)
keys (`ops/select_keys.py`).
The kernels themselves run only on a card (tests/test_torch_cuda.py);
these tests hold what surrounds them: the split choice, the key seed and
decode against the plain versions' lexicographic merge, the work counter
behind chip_smoke.py's sweep bound, and the entry points' CUDA default.
"""

import json

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.__main__ import main as cli_main
from simd_raytracer_tpu_torch.accel.sweep import (R_TILE, SLICE_SIZE,
                                                  build_sweep_for_scene)
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops import intersect_brute, intersect_sweep
from simd_raytracer_tpu_torch.ops.intersect import BIG, IMAX
from simd_raytracer_tpu_torch.ops.select_keys import (decode_any,
                                                      decode_closest, key_id,
                                                      key_t, pack_keys,
                                                      seed_keys)
from torch_scenes import mixed_doc

torch.set_num_threads(2)

EPS = 1e-6
GROUPS_PER_TILE = R_TILE // intersect_sweep.GROUP


# (kernel, SMs, work): the sweep's calls over `work` schedule steps
# (slices), K1's over `work` triangles.
SPLITS = ([("sweep", n_sms, n_slices) for n_sms in (114, 132)
           for n_slices in (5, 417, 980)]
          + [("k1", 132, n_tris) for n_tris in (10, 256, 1000, 106510,
                                                250632)])


@pytest.mark.parametrize("kernel,n_sms,work", SPLITS)
def test_split_fills_the_card(kernel, n_sms, work):
    """kernels.split over the sweep's 128-ray groups (four a 512-ray tile)
    and schedule steps, and over K1's 128-ray blocks and 256-triangle
    tiles: enough blocks for BLOCKS_PER_SM on every SM, unless every block
    already holds one step; 1 for a call whose groups fill the card on
    their own."""
    target = kernels.BLOCKS_PER_SM * n_sms
    if kernel == "sweep":
        steps = work
        groups = [n_tiles * GROUPS_PER_TILE for n_tiles in (1, 3, 32)]
        full = -(-target // GROUPS_PER_TILE) * GROUPS_PER_TILE
    else:
        steps = -(-work // intersect_brute.TRI_TILE)
        groups = [-(-n_rays // intersect_brute.RAY_BLOCK)
                  for n_rays in (1, 129, 4096, 16384)]
        full = target
    for g in groups:
        k = kernels.split(g, steps, n_sms)
        assert 1 <= k <= steps
        assert g * k >= target or k == steps
    for g in (full, full + GROUPS_PER_TILE, 4 * full):
        assert kernels.split(g, steps, n_sms) == 1
    assert kernels.split(full - GROUPS_PER_TILE, steps, n_sms) == min(
        2, steps)


SEEDS = [0.0, -0.0, -2.5, BIG, 7.0, float("inf")]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("t_max", SEEDS, ids=lambda t: repr(t))
def test_key_min_is_the_lexicographic_merge(seed, t_max):
    """Candidates with exact t ties (also on the window's edge and at BIG),
    merged one at a time by lex_merge from (t_max, IMAX), and as the
    kernels do: the integer min over the seed and the packed keys of the
    candidates with t < BIG.  Every candidate has t > eps >= 0."""
    rng = np.random.default_rng(seed)
    n_rays, n_cand = 64, 40
    pool = np.array([1e-5, 0.5, 1.0, 2.0, 7.0, 1e30, BIG], np.float32)
    t = np.where(rng.random((n_rays, n_cand)) < 0.5,
                 rng.choice(pool, (n_rays, n_cand)),
                 rng.uniform(1e-5, 12.0, (n_rays, n_cand))).astype(np.float32)
    ids = rng.integers(0, 5000, (n_rays, n_cand)).astype(np.int32)
    ids[:, 1] = ids[:, 0]     # the same id twice
    t = torch.from_numpy(t)
    ids = torch.from_numpy(ids)
    tm = torch.full((n_rays,), t_max, dtype=torch.float32)

    best_t, best_i = tm.clone(), torch.full((n_rays,), IMAX, dtype=torch.int32)
    for c in range(n_cand):
        best_t, best_i = intersect_sweep.lex_merge(t[:, c], ids[:, c], best_t,
                                                   best_i)
    keys = torch.where(t < BIG, pack_keys(t, ids), seed_keys(tm)[:, None])
    keys = torch.minimum(keys.amin(dim=1), seed_keys(tm))

    idx, won = decode_closest(keys)
    assert torch.equal(won, best_i != IMAX)
    assert torch.equal(idx, torch.where(best_i != IMAX, best_i, 0))
    assert torch.equal(key_t(keys)[won], best_t[won])
    assert torch.equal(key_id(keys), best_i)


def test_seed_and_decode_edges():
    tm = torch.tensor([0.0, -0.0, -3.0, float("nan"), BIG, 2.0])
    keys = seed_keys(tm)
    assert bool((keys > 0).all())           # key 0 is the any-hit flag
    t = key_t(keys)
    assert not t.view(torch.int32)[:4].any()        # +0.0, not -0.0
    assert float(t[4]) == np.float32(BIG) and float(t[5]) == 2.0
    idx, won = decode_closest(keys)
    assert not won.any() and not idx.any()
    idx, hit = decode_any(torch.where(torch.arange(6) % 2 == 0, 0, keys))
    assert hit.tolist() == [True, False] * 3 and not idx.any()
    # A winner right at the window edge beats the seed; t is exact.
    k = torch.minimum(seed_keys(torch.tensor([2.0])),
                      pack_keys(torch.tensor([2.0]), torch.tensor([9])))
    assert decode_closest(k)[0].item() == 9 and key_t(k).item() == 2.0


@pytest.fixture(scope="module")
def small_sweep():
    s = T.parse_scene_dict(mixed_doc(24, 24, g=12, subdiv=1))
    g = T.derive_geometry(s)
    return s, g, build_sweep_for_scene(s)


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_work_pairs_matches_a_brute_count(small_sweep, any_hit):
    s, g, sw = small_sweep
    rng = np.random.default_rng(11)
    n = 1500                             # 3 tiles, the last one padded
    o = np.asarray(s.cam_pos, np.float32) + rng.normal(scale=2.0, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(x, dtype=torch.float32) for x in (o, d))
    tmax = torch.tensor(rng.uniform(0.0, 20.0, n), dtype=torch.float32)
    solid = g.tri_valid & ~g.tri_transmissive     # masked lanes count 0
    args = intersect_sweep.prepare_sweep(sw, o, d, solid, tmax)
    count, order, tnear, mask, tm = (args[i] for i in (0, 1, 2, 8, 5))
    best_t, _, decided = intersect_sweep.sweep_reference_walk(
        *args, EPS, True, any_hit)
    got = intersect_sweep.sweep_work_pairs(count, order, tnear, mask, tm,
                                           best_t, decided)

    live = (mask > 0).sum(dim=1).tolist()
    best_t, decided = best_t.reshape(-1).tolist(), decided.reshape(-1).tolist()
    want = 0
    for r in range(n):                   # the padding rays need nothing
        p = r // R_TILE
        for j in range(int(count[p, 0])):
            if decided[r] >= 0:
                need = j <= decided[r] and float(tnear[p, j]) <= float(tm[r])
            else:
                need = float(tnear[p, j]) <= best_t[r]
            want += live[int(order[p, j])] if need else 0
    assert got == want
    tile_wide = sum(R_TILE * SLICE_SIZE for p in range(order.shape[0])
                    for j in range(int(count[p, 0])))
    assert 0 < got < tile_wide
    assert any(x >= 0 for x in decided) == any_hit


def test_negative_epsilon_is_refused_on_the_cpu_too(small_sweep):
    """The key merge needs t >= 0, so the CUDA wrappers refuse eps < 0;
    the CPU refuses it in the same places, and RenderConfig.epsilon before
    any render starts."""
    s, g, sw = small_sweep
    o = s.cam_pos.float().expand(8, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(8, 3).contiguous()
    with pytest.raises(ValueError, match="epsilon"):
        intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, -EPS, True)
    with pytest.raises(ValueError, match="epsilon"):
        intersect_sweep.sweep_select(*intersect_sweep.prepare_sweep(sw, o, d),
                                     -EPS, True, False)
    with pytest.raises(ValueError, match="epsilon"):
        T.render_frame(s, T.RenderConfig(epsilon=-EPS, max_ray_depth=1),
                       device="cpu")
    assert intersect_brute.mt_select_brute(o, d, g.v0, g.e1, g.e2, 0.0,
                                           True)[0].shape == (8,)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    doc = mixed_doc(8, 8, g=4, subdiv=1)
    scene = T.parse_scene_dict(doc)
    cfg = T.RenderConfig(max_ray_depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.render_frame(scene, cfg)
    params, _ = G.split_params(scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.params_from_arrays({k: v.numpy() for k, v in params.items()})
    path = tmp_path / "scene.crtscene"
    path.write_text(json.dumps(doc))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main([str(path), "-o", str(tmp_path / "out.ppm")])
    # Asked for the CPU, they run there.
    assert T.render_frame(scene, cfg, device="cpu").shape == (8, 8, 3)
    assert G.params_from_arrays({k: v.numpy() for k, v in params.items()},
                                device="cpu")["vertices"].device.type == "cpu"
