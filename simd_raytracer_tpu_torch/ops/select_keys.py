"""Packed (t, id) keys: how the select kernels merge winners across blocks.

Both CUDA kernels (`csrc/mt_select.cu`, `csrc/sweep_select.cu`, through
`csrc/select_common.cuh`) let several blocks test one ray and merge their
winners with a 64-bit atomicMin on a per-ray key

    key = (float32 bits of t) << 32 | id

For t >= +0.0 the float bits order as unsigned integers, so the integer
min over keys is the lexicographic (t, id) min of the plain versions
(`ops/intersect_sweep.py::lex_merge`).  Keys are held in int64 here: for a
finite t >= 0 the top bit is clear, so signed and unsigned order agree.

The wrappers seed the keys and decode them with these functions; they run
on any device, which is how the CPU tests hold them against the plain
merge.  Seeds carry id IMAX (so "won" is "id != IMAX") and clamp t at +0.0:
-0.0 and negative floats do not order as integers, and with t > eps >= 0
for every candidate a negative or zero window accepts nothing either way.
Key 0 marks a ray an any-hit query has decided.

`launch` and `check_table` are the rest of what the four kernel wrappers
(brute, fast, kd, sweep) share.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import profiling
from .intersect import IMAX

_LOW = 0xFFFFFFFF

# Each select backend's kernel (srt_<kernel> of the library), by the name
# its launch counter carries.
KERNELS = {"brute": "mt_select", "fast": "fast_select", "kd": "kd_select",
           "sweep": "sweep_select"}


def check_eps(eps) -> None:
    """Raise unless eps >= 0: every candidate must have t > eps >= 0 for
    the key order to be the (t, id) order.  The select wrappers call it on
    every device, and `ops.render.check_supported` for RenderConfig.epsilon,
    so a configuration the card refuses is refused on the CPU too."""
    if not eps >= 0.0:
        raise ValueError(f"epsilon must be >= 0 for the key merge, got {eps}")


def pack_keys(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(t float32 >= +0.0, ids int) -> int64 keys, as the kernels pack
    them."""
    bits = t.float().contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | ids.to(torch.int64)


def seed_keys(t_max: torch.Tensor) -> torch.Tensor:
    """Keys a merge starts from: (t_max clamped at +0.0, IMAX).  NaN seeds
    at +0.0 too (the plain versions never accept against a NaN window)."""
    t = t_max.float()
    return pack_keys(torch.where(t > 0.0, t, 0.0), torch.full_like(
        t, IMAX, dtype=torch.int64))


def key_t(keys: torch.Tensor) -> torch.Tensor:
    """The float32 t of each key."""
    return (keys >> 32).to(torch.int32).view(torch.float32)


def key_id(keys: torch.Tensor) -> torch.Tensor:
    """The int32 id of each key (IMAX where nothing won)."""
    return (keys & _LOW).to(torch.int32)


def decode_closest(keys: torch.Tensor):
    """-> (idx int32, won bool): idx 0 where nothing was accepted."""
    ids = key_id(keys)
    won = ids != IMAX
    return torch.where(won, ids, 0), won


def decode_any(keys: torch.Tensor):
    """-> (idx int32 zeros, hit bool): hit where a block decided the ray."""
    return torch.zeros(keys.shape, dtype=torch.int32,
                       device=keys.device), keys == 0


def check_table(name: str, x: torch.Tensor, shape: tuple, dtype,
                device) -> None:
    """Raise unless `x`, a table a select kernel reads, is a contiguous
    `dtype` tensor of `shape` on `device`."""
    if (x.device != device or tuple(x.shape) != shape or x.dtype != dtype
            or not x.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous {dtype} {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def launch(backend: str, o, d, tris, tri_mask, t_max, mask_dtype, args):
    """The select kernels' shared launch, on CUDA tensors -> (mask, tmax).

    Checks that o, d are (R, 3) and tris = (v0, e1, e2), if any, (T, 3) on
    o's device; makes tri_mask (T,) a contiguous `mask_dtype` tensor and
    t_max (R,) a contiguous float32 one there (None stays None).  Where
    R > 0, runs the backend's kernel on args(o32, d32, mask, tmax) and the
    current stream, checks its return code and counts
    `select.launches.<backend>`."""
    r = o.shape[0]
    t = tris[0].shape[0] if tris else 0
    inputs = [("o", o, r), ("d", d, r)]
    inputs += [(name, x, t) for name, x in zip(("v0", "e1", "e2"), tris)]
    for name, x, rows in inputs:
        if x.device != o.device or tuple(x.shape) != (rows, 3):
            raise ValueError(f"{name}: expected ({rows}, 3) on {o.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    mask = (None if tri_mask is None else
            tri_mask.to(device=o.device, dtype=mask_dtype).contiguous())
    tmax = (None if t_max is None else
            t_max.to(device=o.device, dtype=torch.float32).contiguous())
    shapes = [None if x is None else tuple(x.shape) for x in (mask, tmax)]
    if shapes[0] not in (None, (t,)) or shapes[1] not in (None, (r,)):
        raise ValueError(f"tri_mask {shapes[0]} / t_max {shapes[1]} do not "
                         f"match T={t}, R={r}")
    if r:
        name = KERNELS[backend]
        rc = getattr(kernels.library(), f"srt_{name}")(
            *args(o.float().contiguous(), d.float().contiguous(), mask,
                  tmax), torch.cuda.current_stream(o.device).cuda_stream)
        kernels.check(rc, name)
        profiling.count(f"select.launches.{backend}")
    return mask, tmax
