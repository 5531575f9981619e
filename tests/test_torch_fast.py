"""PyTorch port: the fast select's table of per-triangle constants and its
wrapper on the CPU.

The table-fed plain version must give, bit for bit, what the fast select
gave before it had a table (`_fast_untabled`, the plain version as it was,
kept here as the reference); tests/test_torch_march.py holds it against
JAX.  The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch import kernels
from simd_raytracer_tpu_torch.models.scene import cross3
from simd_raytracer_tpu_torch.ops import intersect_brute
from simd_raytracer_tpu_torch.ops import intersect_fast as F
from simd_raytracer_tpu_torch.ops.intersect import BIG, _block, make_select_fn
from simd_raytracer_tpu_torch.utils import profiling
from test_torch_select import CASES, rays
from torch_scenes import mixed_doc

torch.set_num_threads(2)

EPS = 1e-6


@pytest.fixture(scope="module")
def scene():
    s = T.parse_scene_dict(mixed_doc(16, 16, g=8, subdiv=2))
    return s, T.derive_geometry(s)


def _fast_untabled(o, d, v0, e1, e2, eps, cull, tri_mask=None, t_max=None,
                   any_hit=False):
    """The plain fast select before the table: every constant computed per
    triangle block from (v0, e1, e2)."""
    dtype = o.dtype
    v0, e1, e2 = (x.to(dtype) for x in (v0, e1, e2))
    center = v0.mean(dim=0)
    o = o - center[None, :]
    v0 = v0 - center[None, :]
    c = cross3(o, d)
    tm = None if t_max is None else t_max.to(dtype)[:, None]

    def col(a, k):
        return a[:, k:k + 1]

    r = o.shape[0]
    hit = torch.zeros(r, dtype=torch.bool)
    best_t = torch.full((r,), BIG, dtype=dtype)
    best_i = torch.zeros(r, dtype=torch.int64)
    step = _block(r)
    for s in range(0, v0.shape[0], step):
        bv0, be1, be2 = v0[s:s + step], e1[s:s + step], e2[s:s + step]
        n = cross3(be1, be2)
        v0n = n[:, 0] * bv0[:, 0] + n[:, 1] * bv0[:, 1] + n[:, 2] * bv0[:, 2]
        wu = cross3(bv0, be2)
        wv = cross3(be1, bv0)

        def row(a, k):
            return a[None, :, k]

        det = -(col(d, 0) * row(n, 0) + col(d, 1) * row(n, 1)
                + col(d, 2) * row(n, 2))
        t_num = (col(o, 0) * row(n, 0) + col(o, 1) * row(n, 1)
                 + col(o, 2) * row(n, 2)) - v0n[None, :]
        u_num = (col(c, 0) * row(be2, 0) + col(c, 1) * row(be2, 1)
                 + col(c, 2) * row(be2, 2)
                 + col(d, 0) * row(wu, 0) + col(d, 1) * row(wu, 1)
                 + col(d, 2) * row(wu, 2))
        v_num = (col(d, 0) * row(wv, 0) + col(d, 1) * row(wv, 1)
                 + col(d, 2) * row(wv, 2)
                 - (col(c, 0) * row(be1, 0) + col(c, 1) * row(be1, 1)
                    + col(c, 2) * row(be1, 2)))
        sgn = torch.where(det >= 0.0, 1.0, -1.0).to(dtype)
        adet = det * sgn
        ok = det > eps if cull else adet > eps
        us, vs = u_num * sgn, v_num * sgn
        ok = ok & (us >= 0.0) & (us <= adet)
        ok = ok & (vs >= 0.0) & (us + vs <= adet)
        ok = ok & (t_num * sgn > eps * adet)
        if tri_mask is not None:
            ok = ok & tri_mask[None, s:s + step]
        if tm is not None:
            ok = ok & (t_num * sgn <= tm * adet)
        if any_hit:
            hit = hit | ok.any(dim=1)
            continue
        t_m = torch.where(ok, t_num / torch.where(ok, det, 1.0), BIG)
        blk_i = t_m.argmin(dim=1)
        blk_t = t_m.gather(1, blk_i[:, None])[:, 0]
        upd = blk_t < best_t
        best_t = torch.where(upd, blk_t, best_t)
        best_i = torch.where(upd, blk_i + s, best_i)
    if any_hit:
        return torch.zeros(r, dtype=torch.int32), hit
    return best_i.to(torch.int32), best_t < BIG


@pytest.mark.parametrize("cull,masked,windowed,any_hit", CASES)
def test_table_fed_select_equals_the_untabled_one(scene, cull, masked,
                                                  windowed, any_hit):
    """Bitwise, through the per-frame table of make_select_fn("fast")
    (float32), and in float64 with a table built on the call."""
    s, g = scene
    o, d, tmax = (torch.from_numpy(x) for x in rays(s.cam_pos, seed=5))
    mask = g.tri_valid & ~g.tri_transmissive if masked else None
    tm = tmax if windowed else None
    select = make_select_fn("fast", geom=g)
    got = select(o, d, g.v0, g.e1, g.e2, EPS, cull, mask, tm, any_hit)
    ref = _fast_untabled(o, d, g.v0, g.e1, g.e2, EPS, cull, mask, tm, any_hit)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert 0 < int(got[1].sum()) < len(o)
    o64, d64, g64 = o.double(), d.double(), g.map(
        lambda t: t.double() if t.is_floating_point() else t)
    got = F.mt_select_fast(o64, d64, g64.v0, g64.e1, g64.e2, EPS, cull, mask,
                           None if tm is None else tm.double(), any_hit)
    ref = _fast_untabled(o64, d64, g64.v0, g64.e1, g64.e2, EPS, cull, mask,
                         None if tm is None else tm.double(), any_hit)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_table_of_other_triangles_is_refused(scene):
    s, g = scene
    o, d, _ = (torch.from_numpy(x) for x in rays(s.cam_pos, n=64, seed=6))
    table = make_select_fn("fast", geom=g).keywords["table"]
    other = g.v0.clone()
    with pytest.raises(ValueError, match="table"):
        F.mt_select_fast(o, d, other, g.e1, g.e2, EPS, True, table=table)
    with pytest.raises(ValueError, match="table"):
        F.mt_select_fast(o.double(), d.double(), g.v0, g.e1, g.e2, EPS, True,
                         table=table)


@pytest.mark.parametrize("any_hit", [False, True])
def test_cpu_select_never_touches_the_kernel(scene, monkeypatch, any_hit):
    s, g = scene
    o, d, tmax = (torch.from_numpy(x) for x in rays(s.cam_pos, n=256, seed=7))

    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_library)
    with profiling.recording() as rec:
        got = make_select_fn("fast", geom=g)(o, d, g.v0, g.e1, g.e2, EPS,
                                             False, g.tri_valid, tmax,
                                             any_hit)
    assert rec.counts["select.launches.fast"] == 0
    assert torch.equal(got[1], F.mt_select_fast_reference(
        o, d, g.v0, g.e1, g.e2, EPS, False, g.tri_valid, tmax, any_hit)[1])


@pytest.mark.parametrize("any_hit", [False, True])
def test_negative_eps_is_refused(scene, any_hit):
    """The kernel's key merge needs t >= 0, so eps < 0 is refused on every
    device (tests/test_torch_cuda.py holds the card)."""
    s, g = scene
    o, d, _ = (torch.from_numpy(x) for x in rays(s.cam_pos, n=16, seed=8))
    with pytest.raises(ValueError, match="eps"):
        F.mt_select_fast(o, d, g.v0, g.e1, g.e2, -EPS, True, any_hit=any_hit)
    with pytest.raises(ValueError, match="eps"):
        make_select_fn("fast", geom=g)(o, d, g.v0, g.e1, g.e2, -EPS, True,
                                       any_hit=any_hit)


def test_empty_calls(scene):
    """No rays, and no triangles: misses of the right types."""
    s, g = scene
    o, d, _ = (torch.from_numpy(x) for x in rays(s.cam_pos, n=8, seed=9))
    idx, hit = F.mt_select_fast(o[:0], d[:0], g.v0, g.e1, g.e2, EPS, True)
    assert idx.shape == hit.shape == (0,)
    idx, hit = F.mt_select_fast(o, d, g.v0[:0], g.e1[:0], g.e2[:0], EPS, True)
    assert idx.dtype == torch.int32 and hit.dtype == torch.bool
    assert not hit.any() and not idx.any()
    assert np.isfinite(F.fast_table(g.v0, g.e1, g.e2).soa.numpy()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_rows_are_the_kernels_float4_words(scene, dtype):
    """FastTable.pack holds a triangle's 16 constants in a row, in the
    order csrc/fast_select.cu reads them as four float4 words: (n, v0 . n),
    (e2, wu.x), (wu.y, wu.z, wv.x, wv.y), (wv.z, e1); padded with zero rows
    to a whole number of FAST_TILE tiles; the same bits as the constants
    computed one by one and as the (16, T) row table the select had
    before (rows n, v0 . n, wu, wv, e1, e2)."""
    s, g = scene
    # The scene's triangles come padded to 128; drop 5 to leave a ragged
    # last tile.
    v0, e1, e2 = (x[:-5] for x in (g.v0, g.e1, g.e2))
    tab = F.fast_table(v0, e1, e2, dtype)
    v0, e1, e2 = (x.to(dtype) for x in (v0, e1, e2))
    assert torch.equal(tab.center, v0.mean(dim=0))
    t = v0.shape[0]
    pad = -(-t // F.FAST_TILE) * F.FAST_TILE
    assert tab.pack.shape == (pad, F.ROWS) and tab.pack.is_contiguous()
    assert tab.pack.dtype == dtype and pad > t
    assert not tab.pack[t:].any()
    v0c = v0 - tab.center
    n = cross3(e1, e2)
    v0n = n[:, 0] * v0c[:, 0] + n[:, 1] * v0c[:, 1] + n[:, 2] * v0c[:, 2]
    wu, wv = cross3(v0c, e2), cross3(e1, v0c)
    words = tab.pack[:t].reshape(t, 4, 4)
    for word, want in ((0, [n, v0n[:, None]]), (1, [e2, wu[:, :1]]),
                       (2, [wu[:, 1:], wv[:, :2]]), (3, [wv[:, 2:], e1])):
        assert torch.equal(words[:, word], torch.cat(want, dim=1))
    before = torch.cat([n.T, v0n[None], wu.T, wv.T, e1.T, e2.T], dim=0)
    order = [F.N, F.N + 1, F.N + 2, F.V0N, *range(F.WU, F.WU + 3),
             *range(F.WV, F.WV + 3), *range(F.E1, F.E1 + 3),
             *range(F.E2, F.E2 + 3)]
    assert torch.equal(tab.soa[order], before)
    assert tab.soa.shape == (F.ROWS, t)
    assert tab.soa.data_ptr() == tab.pack.data_ptr()


@pytest.mark.parametrize("n_sms", [132, 114, 16])
@pytest.mark.parametrize("n_tris", [10, 128, 1000, 106510, 250632])
def test_fast_split_fills_the_card(n_sms, n_tris):
    """The fast kernel's split is kernels.split over blocks of
    FAST_THREADS * FAST_WIDTH rays and tiles of FAST_TILE triangles:
    enough blocks for kernels.BLOCKS_PER_SM on every SM, never more than
    there are tiles, so every block of the kernel's even share takes at
    least one; a 1,085-ray march call splits as far as the tiles allow.
    K1's split of a 16,384-ray chunk of the full scene is unchanged."""
    target = kernels.BLOCKS_PER_SM * n_sms
    block = F.FAST_THREADS * F.FAST_WIDTH
    tiles = -(-n_tris // F.FAST_TILE)

    def fast_split(n_rays):
        return kernels.split(-(-n_rays // block), tiles, n_sms)

    for n_rays in (1, block - 1, block + 1, 1085, 16384, 32768):
        m = fast_split(n_rays)
        assert 1 <= m <= tiles
        assert -(-n_rays // block) * m >= target or m == tiles
        # The kernel's even share: block y takes tiles [y T / m, (y+1) T / m).
        shares = [(y + 1) * tiles // m - y * tiles // m for y in range(m)]
        assert min(shares) >= 1 and sum(shares) == tiles
    assert fast_split(target * block) == 1
    assert fast_split((target - 1) * block) == min(2, tiles)
    assert kernels.split(16384 // intersect_brute.RAY_BLOCK,
                         -(-106510 // intersect_brute.TRI_TILE), 132) == 33
