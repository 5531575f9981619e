"""The float64 yardstick that holds a hand-written backward to the plain
version's gradients (the CPU and card tests, `chip_smoke.py`), and the
one shade call with every float input requiring grad that they all
differentiate."""

import torch


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
