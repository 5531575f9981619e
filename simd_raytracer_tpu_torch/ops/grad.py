"""Differentiable rendering: losses and inverse-rendering SGD steps.

Counterpart of `simd_raytracer_tpu.ops.grad`.  Pixel gradients with respect
to vertices, UVs, albedo, IOR, texture colors and texels, lights and the
background come from torch autograd through the wavefront render.  The
selects run under `torch.no_grad()` (visibility is piecewise constant), so
gradients flow through the winning triangles' refined intersection math,
shading and texture lookups; the select kernels need no backward.  The
scene tables' gathers go through `ops/gather.py::gather_rows`, whose
backward sums each row's duplicates in a fixed order (a kernel on the
card), and on the card the hit record and the shading are autograd
nodes whose backward kernels sum their table rows the same way, so a
step's gradients are the same bits on every run.

Where JAX takes a PRNG key, these functions take a uniform source (an
object with `jitter`, `coin` and `gi`, see `ops.render.TorchUniforms`), and
`train_steps` a callable step -> source: step i uses source i, as JAX's
step i uses split(key, n_steps)[i].  With intersector="sweep" or "kdtree",
pass the accel built from the starting scene (`ops/render.py::
build_accel`).  By default it stays frozen across steps, as JAX's does:
the sweep's select tests the starting triangles and only the refine sees
the moved ones; the kd walk tests the moved triangles but prunes by the
build's boxes, which a moved triangle may have left.  With cfg.accel_refit
each step's select runs on the sweep's slices or the kd tree's boxes
refitted to that step's vertices, so its winners are those of the step's
own triangles.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import Scene, derive_geometry
from ..utils.profiling import span, spanned
from .render import render_chunk, resolve_device

# Scene leaves that make sense to differentiate.
DIFF_PARAM_NAMES = (
    "vertices", "uv", "mat_albedo", "mat_ior",
    "tex_color_a", "tex_color_b", "tex_param", "atlas",
    "light_pos", "light_intensity", "background",
)


def split_params(scene: Scene) -> Tuple[Dict[str, torch.Tensor], Scene]:
    """Split a scene into (differentiable params dict, scene skeleton)."""
    params = {k: getattr(scene, k) for k in DIFF_PARAM_NAMES}
    return params, scene


def merge_params(params: Dict[str, torch.Tensor], skeleton: Scene) -> Scene:
    return skeleton.replace(**params)


def params_from_arrays(arrays, device="cuda") -> Dict[str, torch.Tensor]:
    """Params from NumPy arrays named like DIFF_PARAM_NAMES (for instance
    JAX's split_params output through np.asarray), on `device` (the card
    unless the caller asks for "cpu"), in the dtype of `vertices`."""
    device = resolve_device(device)
    dtype = torch.from_numpy(np.array(arrays["vertices"])).dtype
    return {k: torch.from_numpy(np.array(arrays[k])).to(device=device,
                                                         dtype=dtype)
            for k in DIFF_PARAM_NAMES}


def render_ids(scene: Scene, cfg: RenderConfig, ids: torch.Tensor,
               uniforms, accel=None) -> torch.Tensor:
    """Differentiable colors for a flat batch of ray ids: (N,) -> (N, 3).
    The geometry is derived here, so gradients reach the vertices."""
    geom = derive_geometry(scene)
    return render_chunk(scene, geom, cfg, ids, uniforms, accel)


def pixel_loss(params: Dict[str, torch.Tensor], skeleton: Scene,
               cfg: RenderConfig, ids: torch.Tensor, target: torch.Tensor,
               uniforms, accel=None) -> torch.Tensor:
    """Mean squared error between rendered ray colors and target colors."""
    scene = merge_params(params, skeleton)
    colors = render_ids(scene, cfg, ids, uniforms, accel)
    return torch.mean((colors - target) ** 2)


@spanned("loss_and_grad")
def loss_and_grad(params, skeleton: Scene, cfg: RenderConfig, ids, target,
                  uniforms, accel=None):
    """(loss, {name: d loss / d param}) through torch.autograd.grad; a
    param the loss does not reach gets a zero gradient, as in JAX (every
    one where the ids are all padding)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        with span("forward"):
            loss = pixel_loss(leaves, skeleton, cfg, ids, target, uniforms,
                              accel)
        with span("backward"):
            grads = (torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}


def train_step(params, skeleton: Scene, cfg: RenderConfig, ids, target,
               uniforms, lr: float = 1e-2, accel=None):
    """One SGD inverse-rendering step -> (params, loss)."""
    loss, grads = loss_and_grad(params, skeleton, cfg, ids, target,
                                uniforms, accel)
    with torch.no_grad():
        params = {k: p - lr * grads[k] for k, p in params.items()}
    return params, loss


def train_steps(params, skeleton: Scene, cfg: RenderConfig, ids, target,
                uniforms: Callable[[int], object], lr: float = 1e-2,
                n_steps: int = 8, accel=None):
    """n_steps SGD steps -> (params, losses (n_steps,)).  Step i draws its
    estimator randomness from uniforms(i)."""
    losses = []
    for i in range(n_steps):
        params, loss = train_step(params, skeleton, cfg, ids, target,
                                  uniforms(i), lr, accel)
        losses.append(loss)
    return params, torch.stack(losses)
