"""The float64 yardstick that holds a hand-written backward to the plain
version's gradients (the CPU and card tests, `chip_smoke.py`), the one
shade call with every float input requiring grad that they all
differentiate, and the hit records (ops/intersect.py) they differentiate
likewise."""

import numpy as np
import torch

EPS = 1e-6
# The leaves of a record call, in `ops/intersect.py::_RecordGrad`'s input
# order: o, d, then `_grad_tables`.
RECORD_LEAVES = ("o", "d", "v0", "e1", "e2", "vn", "face_n", "uv",
                 "mat_albedo", "mat_ior")


def shade_loss(fn, args, outs, dtype=torch.float32):
    """One shade call `fn(*args)` (args as `shade` takes them: scene, geom,
    hit, d_in, weight, cfg, accel, rnd_coin, rnd_gi) in `dtype`, with
    every float input of `_grad_inputs` a fresh leaf requiring grad ->
    (values: contrib and the four children's fields, the loss sum(o * g)
    over contrib and the children's origins, directions and weights with
    `outs` as the g, the leaves in `_grad_inputs` order: None where the
    input is None or not a float)."""
    from simd_raytracer_tpu_torch.ops import shade as S
    scene, geom, hit, d_in, weight, cfg, accel, coin, rnd_gi = args

    def cast(t):
        return t.to(dtype) if t is not None and t.is_floating_point() else t

    scene, hit = scene.map(cast), hit.map(cast)
    d_in, weight, coin, rnd_gi = map(cast, (d_in, weight, coin, rnd_gi))
    leaves = [None if t is None or not t.is_floating_point() else
              t.detach().clone().requires_grad_()
              for t in S._grad_inputs(scene, hit, d_in, weight, coin,
                                      rnd_gi)]
    nh = len(S._GRAD_HIT)
    h = hit.replace(**dict(zip(S._GRAD_HIT, leaves[:nh])))
    sc = scene.replace(**dict(zip(S._GRAD_SCENE, leaves[nh + 4:])))
    contrib, children = fn(sc, geom, h, *leaves[nh:nh + 2], cfg, accel,
                           *leaves[nh + 2:nh + 4])
    vals = [contrib, *children]
    loss = sum((o * g.to(dtype)).sum() for o, g in zip(vals, outs))
    return vals, loss, leaves


def leaf_grads(loss, leaves) -> list:
    """d loss / d each leaf, None where the leaf is None or unused."""
    got = iter(torch.autograd.grad(loss, [t for t in leaves
                                          if t is not None],
                                   allow_unused=True))
    return [None if t is None else next(got) for t in leaves]


def shade_grads(fn, args, outs, dtype=torch.float32):
    """(values, gradients of every leaf) of `shade_loss`'s call."""
    vals, loss, leaves = shade_loss(fn, args, outs, dtype)
    return vals, leaf_grads(loss, leaves)


def gradient_gaps(got, plain, exact) -> list:
    """The gradients of a hand-written backward held to the plain
    version's: for each leaf, the gradient of the kernels (`got`), of the
    plain version in float32 (`plain`) and in float64 (`exact`, the
    yardstick; None is a zero gradient) -> (gap, allowed): the kernels'
    largest distance from `exact`, and what it may be, twice the plain
    float32 gradient's distance plus 1e-6 of `exact`'s largest element.
    The three may lie on different devices (compared on the CPU)."""
    out = []
    for g, p, e in zip(got, plain, exact):
        like = next((t for t in (e, g, p) if t is not None), None)
        if like is None:
            out.append((0.0, 0.0))
            continue
        e = (like * 0 if e is None else e).double().cpu()
        if e.numel() == 0:
            out.append((0.0, 0.0))
            continue

        def gap(t):
            return float((e if t is None else (t.double().cpu() - e))
                         .abs().max())

        out.append((gap(g), 2.0 * gap(p) + 1e-6 * float(e.abs().max())))
    return out


def record_case(scene, cull, n=400, seed=0):
    """(geom, o, d, idx, hit) on `scene`'s device: `n` random rays around
    the camera with the brute-force select's winners, then one ray a
    triangle for eight valid triangles, running along the triangle's
    first edge a little off its plane, with that triangle as its winner:
    the refine's determinant is below eps there and clamps (the first
    four flagged as hits, the rest as misses)."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops import intersect as I
    geom = T.derive_geometry(scene)
    rng = np.random.default_rng(seed)
    o = scene.cam_pos.cpu().numpy() + rng.normal(scale=2.0, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(x, dtype=torch.float32,
                         device=geom.v0.device) for x in (o, d))
    idx, hit = I.mt_select(o, d, geom.v0, geom.e1, geom.e2, EPS, cull,
                           geom.tri_valid)
    tri = geom.tri_valid.nonzero()[1:9, 0]
    d_par = geom.e1[tri] / geom.e1[tri].norm(dim=1, keepdim=True)
    o_par = geom.v0[tri] + 0.5 * geom.face_n[tri] - d_par
    flags = torch.arange(len(tri), device=tri.device) < 4
    return (geom, torch.cat([o, o_par]), torch.cat([d, d_par]),
            torch.cat([idx, tri.int()]), torch.cat([hit, flags]))


def record_loss(fn, scene, geom, o, d, idx, hit, outs, dtype=torch.float32,
                eps=EPS):
    """One record call `fn(o, d, idx, hit, scene, geom, eps)` (a record
    function of ops/intersect.py) in `dtype`, with o, d and every table of
    `_grad_tables` a fresh leaf requiring grad -> (record, the loss
    sum(field * g) over the float fields with `outs` as the g (a field
    whose g is None is left out), the leaves in RECORD_LEAVES order)."""
    from simd_raytracer_tpu_torch.ops import intersect as I

    def leaf(t):
        return t.detach().to(dtype).clone().requires_grad_()

    leaves = [leaf(o), leaf(d)] + [leaf(t) for t in
                                   I._grad_tables(scene, geom)]
    n_tri = len(I._TRI_TABLES)
    g = geom.replace(**{k: t for (k, _), t in zip(I._TRI_TABLES,
                                                  leaves[2:2 + n_tri])})
    s = scene.replace(**{k: t for (k, _), t in zip(I._MAT_TABLES,
                                                   leaves[2 + n_tri:])})
    record = fn(leaves[0], leaves[1], idx, hit, s, g, eps)
    loss = sum((getattr(record, k) * out.to(dtype)).sum()
               for k, out in zip(I._GRAD_FIELDS, outs) if out is not None)
    return record, loss, leaves


def record_grads(fn, scene, geom, o, d, idx, hit, outs,
                 dtype=torch.float32, eps=EPS):
    """(record, gradients of every leaf) of `record_loss`'s call."""
    record, loss, leaves = record_loss(fn, scene, geom, o, d, idx, hit, outs,
                                       dtype, eps)
    return record, leaf_grads(loss, leaves)
