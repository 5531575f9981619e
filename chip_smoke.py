#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simd_raytracer_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --fill-targets   # phase 6 also times the split's
                                           # fill targets

Builds the port's CUDA kernels from `simd_raytracer_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, drives the render path
(`parse_scene_file` -> `render_frame` -> `save_ppm`), diffuse GI, the
training path (`ops.grad.train_steps`), march occlusion, the reference
binary's kd-tree path in bucket tiles, progressive rendering, animation
and the CLI through the kernels at full size, and checks each on CUDA
against the CPU on a small scene or against another select.  Scenes come
from `tests/torch_scenes.py` (generated, no files).

Phases, one result line each:
  1. device and kernel build;
  2. the brute-force select kernel against its plain version (exact);
  3. the sweep kernel on a 106.5k- and a 250k-triangle scene: closest hits
     equal the brute-force kernel, any-hit equals its plain version (exact);
     the camera call timed against its plain version and its bound;
  4. a small render on the CPU (plain versions) and on CUDA (kernels), with
     the same uniforms: images within 1e-4;
  5. full-size renders on CUDA, with every kernel launch counted;
  6. each kernel on the calls that dominate the paths (captured from one
     headline, GI and default frame: the GI frame's full-reach secondary
     sweep call, the headline's largest shadow sweep call, the default
     frame's largest K1 shadow call) and on one 16,384-ray primary chunk:
     exact against its plain version, timed, with its bound (the pairs a
     front-to-back walk cannot skip, counted per ray, x 54 float
     operations over 67 TFLOP/s) and its share of that bound; with
     --fill-targets, the two largest calls also at fill targets of 16, 32
     and 64 blocks per SM;
  7. where the time of phase 5's headline and default frames goes: one
     frame of each under torch.profiler (device busy time, top device
     kernels), and one headline frame with CUDA events around every sweep
     kernel call (time per call by kind of ray);
  8. diffuse GI: small renders on the CPU and on CUDA with the same
     uniforms (gi 1 and 2, split + brute force and roulette + sweep),
     images within 1e-4; then one timed GI frame of the full scene;
  9. gradients of a small scene on CUDA against the CPU: losses within
     1e-5 relative, every gradient within 1e-3 * max|g_cpu| + 1e-6 plus
     twice the CPU's own float32 error against float64;
 10. the fwd+bwd path at full width (bench.py's backward phase): SGD
     steps of 65,536 rays, timed;
 11. northstar: the same at 128 spp with GI, after a finite-difference
     check of d loss / d light_intensity;
 12. refexact (split + march): small renders on the CPU and on CUDA under
     the sweep, brute force and fast selects, then one timed frame of the
     full scene;
 13. where the time of phase 8's GI frame, one SGD step of phases 10 and
     11 and phase 12's frame goes, as phase 7;
 14. the kd-tree of the full scene built by NumPy and by the native
     builder (equal arrays); the kd kernel exact against its plain
     version on the middle 16,384-ray primary chunk of phase 15's bucket
     order and on the largest shadow call of a 480x480 kd frame, timed
     against its bound (the live leaf lanes the walk tests x 54 over 67
     TFLOP/s) and beside K1 on the same calls; the kd kernel and a kdleaf
     sweep against K1 on 8,192 random rays;
 15. the reference binary's path at full width: parse, native kd build,
     a 960x960 spp 1 depth 5 split frame through the kd kernel in bucket
     tiles, save_ppm; held against the brute-force frame (max |d| 1e-4,
     PPM channels off by at most 1 on at most 0.1%), timed and profiled;
 16. render_progressive of the headline config at 8 spp in batches of 4,
     stopped after one batch and resumed from its checkpoint (within 1e-6
     relative of the whole render); a 4-frame orbit at 480x480; the
     wavefront occupancy of one headline chunk; the CLI with
     --intersector kdtree --scheduling bucket --profile.
Phases 5, 8-12, 15 and 16 each count the kernel launches of their own
paths from zero and fail if a kernel of the path never launched; the
kernel line reports their sum, with phase 6's and 14's times and bounds of
the sweep's full-reach secondary call and K1's and the kd kernel's primary
chunk (named by each entry's `call`).  The last three lines
are the card, a JSON object per kernel and {"ok": true, ...}.
Every phase raises on failure, so the script exits non-zero.  It needs a
CUDA device and exits 1 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
EPS = 1e-6
DEV = "cuda"

K1 = "mt_select"
SWEEP = "sweep_select"
KD = "kd_select"
KERNELS = {
    K1: {"name": K1, "route": "cuda",
         "source": "simd_raytracer_tpu_torch/csrc/mt_select.cu",
         "replaces": "simd_raytracer_tpu/ops/intersect_pallas.py:38"},
    SWEEP: {"name": SWEEP, "route": "cuda",
            "source": "simd_raytracer_tpu_torch/csrc/sweep_select.cu",
            "replaces": "simd_raytracer_tpu/ops/intersect_sweep.py:239 "
                        "(and :205, the streaming variant)"},
    KD: {"name": KD, "route": "cuda",
         "source": "simd_raytracer_tpu_torch/csrc/kd_select.cu",
         "replaces": "simd_raytracer_tpu/accel/traverse.py:57 (jnp)"},
}
MAX_ERR = {K1: 0, SWEEP: 0, KD: 0}
# Edge of the square frames of phases 5 (default), 8 and 12, and the ray
# ids of each SGD step of phases 10 and 11 (bench.py's chunk).
FRAME = 480
TRAIN_RAYS = 65536
# Edge of the reference binary's full-width frame (phase 15).
REFBIN = 960
# The kernel each select name runs on the card ("fast" is plain torch).
SELECT_KERNEL = {"jnp": K1, "pallas": K1, "sweep": SWEEP, "kdtree": KD}


# The argument names of ops/intersect_sweep.py::sweep_select before eps,
# cull and any_hit, in order (prepare_sweep's tuple).
SWEEP_ARGS = ("count", "order", "tnear", "o", "d", "tmax", "tri_soa", "ids",
              "mask")


def report(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def exact(kernel: str, what: str, got, ref, where=None) -> None:
    """Hold (idx, hit) of a kernel against its reference; record the
    largest absolute difference and raise on any."""
    (gi, gh), (ri, rh) = got, ref
    if where is not None:
        gi, ri = gi[where], ri[where]
    err = 0
    if gi.numel():
        err = int((gi.long() - ri.long()).abs().max())
    if gh.numel():
        err = max(err, int((gh.int() - rh.int()).abs().max()))
    MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    if err:
        raise AssertionError(
            f"{what}: {kernel} disagrees with its reference on "
            f"{int((gh != rh).sum())} hit flags / max |d idx| {err}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def random_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    o = np.asarray(scene.cam_pos.cpu(), np.float32) + rng.normal(
        scale=2.0, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.0, 30.0, n)
    return (torch.tensor(o, dtype=torch.float32, device=DEV),
            torch.tensor(d, dtype=torch.float32, device=DEV),
            torch.tensor(tmax, dtype=torch.float32, device=DEV))


def camera_rays(scene, cfg, chunk=None, uniforms=None):
    """Primary rays of every valid id (or of one chunk) in `cfg`'s order."""
    from simd_raytracer_tpu_torch.models.camera import primary_rays
    from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
    spp = cfg.samples_per_pixel
    ids = make_ray_chunks(scene, cfg)
    ids = ids[chunk] if chunk is not None else ids.reshape(-1)
    ids = torch.from_numpy(ids[ids < scene.height * scene.width * spp]
                           ).long().to(DEV)
    pix = ids // spp
    if uniforms is None:
        jx = jy = torch.full(ids.shape, 0.5, device=DEV)
    else:
        j = torch.as_tensor(uniforms.jitter(len(ids)), device=DEV)
        jx, jy = j[:, 0], j[:, 1]
    return primary_rays(scene, cfg.fov_degrees, pix % scene.width,
                        pix // scene.width, jx, jy)


def shadow_rays(scene, hit, light: int):
    """Shadow rays of the hits toward one light, as direct_light_factor
    builds them: zero-length window where the light is behind the
    surface."""
    from simd_raytracer_tpu_torch.models.scene import dot3
    keep = hit.mask.nonzero()[:, 0]
    pos = hit.position[keep]
    ldir = scene.light_pos[light][None] - pos
    r = torch.sqrt(dot3(ldir, ldir).clamp_min(1e-24))
    ldir = ldir / r[:, None]
    n = torch.where(hit.smooth[keep, None], hit.hit_n[keep], hit.face_n[keep])
    max_t = torch.where(dot3(ldir, n) > 0.0, r, 0.0)
    return pos + 1e-4 * ldir, ldir, max_t


def phase_build():
    from simd_raytracer_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    ptxas = [" ".join(line.split()) for line in kernels.build_log.splitlines()
             if "entry function" in line or "Used" in line or "spill" in line]
    report("1 device+build", device=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda, build_s=kernels.build_seconds,
           load_s=time.perf_counter() - t0, ptxas=ptxas)


def phase_k1(scene, geom):
    from simd_raytracer_tpu_torch.ops.intersect_brute import (
        mt_select_brute, mt_select_reference)
    o, d, tmax = random_rays(scene, 4096, seed=0)
    solid = geom.tri_valid & ~geom.tri_transmissive
    hits = []
    for cull in (True, False):
        for mask in (geom.tri_valid, solid):
            for t_max in (None, tmax):
                for any_hit in (False, True):
                    args = (o, d, geom.v0, geom.e1, geom.e2, EPS, cull, mask,
                            t_max, any_hit)
                    got = mt_select_brute(*args)
                    exact(K1, f"K1 cull={cull} window={t_max is not None} "
                          f"any_hit={any_hit}", got, mt_select_reference(*args))
                    hits.append(int(got[1].sum()))
    torch.cuda.synchronize()
    if not (0 < min(hits) and max(hits) < len(o)):
        raise AssertionError(f"degenerate K1 test rays: hits {hits}")
    report("2 K1 vs plain", rays=len(o), triangles=int(geom.tri_valid.sum()),
           cases=len(hits), hits_per_case=hits, exact=True)


def phase_sweep(label, scene):
    from simd_raytracer_tpu_torch import RenderConfig, derive_geometry
    from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
    from simd_raytracer_tpu_torch.ops.intersect import trace
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    from simd_raytracer_tpu_torch.ops.intersect_sweep import (
        prepare_sweep, sweep_select, sweep_select_reference)
    t0 = time.perf_counter()
    scene = scene.to(DEV)
    geom = derive_geometry(scene)
    sweep = build_sweep_for_scene(scene).to(DEV)
    o, d = camera_rays(scene, RenderConfig(intersector="sweep"))
    r = len(o)

    args = prepare_sweep(sweep, o, d, geom.tri_valid)
    got = sweep_select(*args, EPS, True, False)
    exact(SWEEP, f"{label} camera closest-hit vs K1",
          (got[0][:r], got[1][:r]),
          mt_select_brute(o, d, geom.v0, geom.e1, geom.e2, EPS, True,
                          geom.tri_valid))
    # The same call against the plain version, timed with its bound (the
    # streaming case of the JAX package on the 250k terrain).
    timed = sweep_call(f"{label} camera closest-hit", {
        **dict(zip(SWEEP_ARGS, args)), "eps": EPS, "cull": True,
        "any_hit": False})
    hit = trace(o, d, scene, geom, EPS, True, intersector="sweep",
                accel=sweep)
    solid = geom.tri_valid & ~geom.tri_transmissive
    shadow = {}
    for light in range(scene.light_pos.shape[0]):
        so, sd, st = shadow_rays(scene, hit, light)
        n = len(so)
        args = prepare_sweep(sweep, so, sd, solid, st)
        closest = sweep_select(*args, EPS, False, False)
        brute = mt_select_brute(so, sd, geom.v0, geom.e1, geom.e2, EPS, False,
                                solid, st)
        # K1 keeps the closest winner beyond the window as idx (hit False),
        # the sweep 0: ids are compared where the window holds a hit.
        exact(SWEEP, f"{label} shadow closest-hit vs K1",
              (closest[0][:n], closest[1][:n]), brute, where=brute[1])
        anyh = sweep_select(*args, EPS, False, True)
        exact(SWEEP, f"{label} shadow any-hit vs plain", anyh,
              sweep_select_reference(*args, EPS, False, True))
        k1_any = mt_select_brute(so, sd, geom.v0, geom.e1, geom.e2, EPS,
                                 False, solid, st, True)[1]
        shadow[f"light{light}"] = {
            "rays": n, "occluded": int(anyh[1][:n].sum()),
            "any_hit_flags_differing_from_K1": int(
                (anyh[1][:n] != k1_any).sum())}
    torch.cuda.synchronize()
    soup = sweep.tri_soa.numel() * 4 * 11 // 9
    report(f"3 sweep {label}", triangles=int(geom.tri_valid.sum()),
           slices=sweep.num_slices, soup_bytes=soup,
           jax_kernel="_kernel_resident" if soup <= 6 << 20 else "_kernel",
           camera_rays=r, camera_hits=int(got[1][:r].sum()), shadow=shadow,
           camera_call=timed, exact=True, seconds=time.perf_counter() - t0)


def render_cpu_vs_cuda(what, scene, cfg, seed):
    """Render `scene` on the CPU and on CUDA with the same uniforms; raise
    unless the images agree within 1e-4 and their PPM channels differ by
    at most 1 on at most 0.1% of channels."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.utils.ppm import image_to_u8
    from torch_scenes import SeededUniforms
    imgs, secs = {}, {}
    for dev in ("cpu", DEV):
        before = counts()
        t0 = time.perf_counter()
        imgs[dev] = T.render_frame(scene, cfg, device=dev,
                                   uniforms=lambda c: SeededUniforms(seed, c)
                                   ).cpu()
        secs[dev] = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in counts().items()}
    if cfg.intersector in SELECT_KERNEL:
        need_launches(what, launches, SELECT_KERNEL[cfg.intersector])
    a, b = imgs["cpu"], imgs[DEV]
    err = float((a - b).abs().max())
    ua, ub = image_to_u8(a).astype(int), image_to_u8(b).astype(int)
    off = int((ua != ub).sum())
    if not (torch.isfinite(b).all() and err <= 1e-4
            and int(np.abs(ua - ub).max()) <= 1 and off <= 0.001 * ua.size):
        raise AssertionError(f"{what}: CPU and CUDA renders differ: max |d| "
                             f"{err}, {off} PPM channels differ")
    return dict(max_abs_err=err, ppm_channels_differing=off,
                cpu_s=secs["cpu"], cuda_s=secs[DEV], cuda_launches=launches)


def small_scene(tmp):
    """The 10,780-triangle mixed scene at 128 x 128, through the file
    loader."""
    import simd_raytracer_tpu_torch as T
    from torch_scenes import mixed_doc
    path = os.path.join(tmp, "small.crtscene")
    with open(path, "w") as f:
        json.dump(mixed_doc(128, 128, g=64, subdiv=3), f)
    return T.parse_scene_file(path)


def phase_small(tmp):
    import simd_raytracer_tpu_torch as T
    scene = small_scene(tmp)
    cfg = T.RenderConfig(samples_per_pixel=2, max_ray_depth=5,
                         bounce_mode="roulette", intersector="sweep")
    report("4 small render cpu vs cuda",
           triangles=int(scene.tri_valid.sum()),
           **render_cpu_vs_cuda("phase 4", scene, cfg, 5))


def render_timed(label, scene, cfg, accel=None, frames=3, phase="5"):
    """One warm frame, then `frames` timed ones; checks the image."""
    import simd_raytracer_tpu_torch as T
    before = counts()
    times = []
    for i in range(frames + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = T.render_frame(scene, cfg, device=DEV, accel=accel)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    bg = scene.background.to(DEV)
    not_bg = float((img != bg).any(dim=-1).float().mean())
    if not (img.shape == (scene.height, scene.width, 3)
            and bool(torch.isfinite(img).all()) and not_bg > 0.01):
        raise AssertionError(f"{label}: bad image (shape {tuple(img.shape)}, "
                             f"non-background share {not_bg})")
    launches = {k: v - before[k] for k, v in counts().items()}
    rays = scene.height * scene.width * cfg.samples_per_pixel
    mean = sum(times[1:]) / frames
    report(f"{phase} {label}", width=scene.width, height=scene.height,
           spp=cfg.samples_per_pixel, depth=cfg.max_ray_depth,
           bounce_mode=cfg.bounce_mode, intersector=cfg.intersector,
           warm_s=times[0], frame_s=times[1:], primary_rays_per_s=rays / mean,
           non_background=not_bg, launches=launches)
    return img, launches, mean


def phase_full(tmp):
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
    from simd_raytracer_tpu_torch.models.scene import build_scene
    from simd_raytracer_tpu_torch.utils.ppm import read_ppm
    from torch_scenes import bitmap_scene_kwargs, mixed_doc
    path = os.path.join(tmp, "mixed960.crtscene")
    with open(path, "w") as f:
        json.dump(mixed_doc(960, 960), f)
    scene = T.parse_scene_file(path).to(DEV)
    headline = T.RenderConfig(samples_per_pixel=4, max_ray_depth=5,
                              bounce_mode="roulette", intersector="sweep")
    accel = build_sweep_for_scene(scene).to(DEV)
    bitmap = build_scene(**bitmap_scene_kwargs(256, 256)).to(DEV)

    default = scene.replace(height=FRAME, width=FRAME)
    counts_reset()
    img, l_head, s_head = render_timed("headline roulette+sweep", scene,
                                       headline, accel)
    _, l_default, s_default = render_timed("default split+jnp", default,
                                           T.RenderConfig())
    _, l_bitmap, _ = render_timed("bitmap textures", bitmap,
                                  T.RenderConfig())
    launches = counts()

    out = os.path.join(tmp, "headline.ppm")
    T.save_ppm(img, out)
    if read_ppm(out).shape != (scene.height, scene.width, 3):
        raise AssertionError("headline PPM has the wrong shape")
    if not (l_head[SWEEP] > 0 and l_default[K1] > 0 and l_bitmap[K1] > 0):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{l_head} {l_default} {l_bitmap}")
    frames = {"headline": (scene, headline, accel, s_head),
              "default": (default, T.RenderConfig(), None, s_default)}
    return frames, launches


def event_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Bounds: ~54 float operations per (ray, triangle) pair of the plain
# version (_mt_merge, ops/intersect_sweep.py), against the H100's published
# 67 TFLOP/s float32 rate outside the tensor cores and 3.35 TB/s of HBM.
# The kernels are built without FMA contraction, which halves the rate
# they can reach; the share is stated against the published peak anyway.
OPS_PER_PAIR = 54
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound(pairs, n_bytes):
    """(bound ms, bound_by) of `pairs` pair tests moving `n_bytes`."""
    ops_ms = pairs * OPS_PER_PAIR / PEAK_F32 * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if torch.is_tensor(x))


def capture(run, module, name, kind_of):
    """Run `run` with module.<name> wrapped; keep, for each kind of call
    (kind_of(bound arguments) -> (kind, size)), a copy of the arguments of
    its largest call."""
    import inspect
    fn = getattr(module, name)
    sig = inspect.signature(fn)
    kept = {}

    def wrapped(*args, **kw):
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        kind, size = kind_of(a.arguments)
        if size > kept.get(kind, (-1, None))[0]:
            kept[kind] = (size, {k: v.clone() if torch.is_tensor(v) else v
                                 for k, v in a.arguments.items()})
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, fn)
    torch.cuda.synchronize()
    return {k: v for k, (_, v) in kept.items()}


def ray_kind(any_hit, cull):
    return "shadow" if any_hit else "primary" if cull else "secondary"


def time_call(fn, plain, reps):
    """Kernel ms (two runs of `reps` calls, around one plain run) and the
    plain version's ms -> (kernel ms, plain ms, kernel runs)."""
    runs = [event_ms(fn, reps)]
    plain_ms = event_ms(plain, 1)
    runs.append(event_ms(fn, reps))
    return sum(runs) / 2, plain_ms, runs


def sweep_call(label, a):
    """Hold one captured sweep call exactly against the plain version;
    time it; count its bound per ray from the plain walk's final best t
    (ops/intersect_sweep.py::sweep_work_pairs)."""
    from simd_raytracer_tpu_torch.ops import intersect_sweep as S
    args = tuple(a.values())
    exact(SWEEP, label, S.sweep_select(*args), S.sweep_select_reference(*args))
    best_t, _, decided = S.sweep_reference_walk(*args)
    pairs = S.sweep_work_pairs(a["count"], a["order"], a["tnear"], a["mask"],
                               a["tmax"], best_t, decided)
    p, s = a["order"].shape
    # The count earlier versions took: 512 x 256 pairs for every slice up
    # to the tile's largest best t, kept beside the per-ray count.
    steps = torch.arange(s, device=a["tnear"].device)
    tile_walk = int(((steps[None] < a["count"])
                     & (a["tnear"] <= best_t.amax(dim=1, keepdim=True))).sum()
                    ) * 512 * 256
    ms, plain_ms, runs = time_call(lambda: S.sweep_select(*args),
                                   lambda: S.sweep_select_reference(*args),
                                   10)
    rp = p * 512
    b_ms, by = bound(pairs, nbytes(*args) + rp * 5)
    return dict(kind=ray_kind(a["any_hit"], a["cull"]), rays=rp, tiles=p,
                slices_scheduled_per_tile=float(a["count"].float().mean()),
                split=S.sweep_split(p, s, torch.cuda.get_device_properties(0)
                                    .multi_processor_count),
                ms=ms, runs_ms=runs, plain_ms=plain_ms, pairs_needed=pairs,
                bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms,
                pairs_tile_walk=tile_walk,
                bound_ms_tile_walk=bound(tile_walk, 0)[0], exact=True)


def k1_call(label, a):
    """The same for one captured brute-force call.  Pairs: every ray
    against every unmasked triangle; for any-hit, a hit ray needs at least
    one pair and a miss every one."""
    from simd_raytracer_tpu_torch.ops import intersect_brute as B
    fn_args = dict(a)
    exact(K1, label, B.mt_select_brute(**fn_args),
          B.mt_select_reference(**{k: v for k, v in fn_args.items()
                                   if k != "tri_soa"}))
    hit = B.mt_select_brute(**fn_args)[1]
    r = a["o"].shape[0]
    live = (int(a["v0"].shape[0]) if a["tri_mask"] is None
            else int(a["tri_mask"].sum()))
    hits = int(hit.sum())
    pairs = ((r - hits) * live + hits) if a["any_hit"] else r * live
    ms, plain_ms, runs = time_call(
        lambda: B.mt_select_brute(**fn_args),
        lambda: B.mt_select_reference(**{k: v for k, v in fn_args.items()
                                         if k != "tri_soa"}), 5)
    # o, d and t_max in, idx and hit out: 33 bytes a ray; the packed
    # triangle and its mask: 40 bytes a triangle.
    b_ms, by = bound(pairs, 33 * r + 40 * int(a["v0"].shape[0]))
    return dict(kind=ray_kind(a["any_hit"], a["cull"]), rays=r,
                triangles=int(a["v0"].shape[0]), live_triangles=live,
                split=B.k1_split(r, int(a["v0"].shape[0]),
                                 torch.cuda.get_device_properties(0)
                                 .multi_processor_count),
                ms=ms, runs_ms=runs, plain_ms=plain_ms, pairs_needed=pairs,
                bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms,
                exact=True)


def phase_timed(frames, full, accel):
    """Each kernel on the calls that dominate the paths, captured from one
    headline, one GI and one default frame, and on one 16,384-ray chunk of
    the headline's primary rays (the call earlier versions timed)."""
    from simd_raytracer_tpu_torch import derive_geometry
    from simd_raytracer_tpu_torch.ops import intersect_brute, intersect_sweep
    from simd_raytracer_tpu_torch.ops.intersect_sweep import prepare_sweep
    from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
    from torch_scenes import SeededUniforms
    scene, cfg, _, _ = frames["headline"]
    default, dcfg, _, _ = frames["default"]
    gi_frame = full.replace(height=FRAME, width=FRAME)

    def sweep_kind(a):
        return (ray_kind(a["any_hit"], a["cull"]), int(a["count"].sum()))

    def k1_kind(a):
        return (ray_kind(a["any_hit"], a["cull"]), a["o"].shape[0])

    head = capture(frame_run(scene, cfg, accel), intersect_sweep,
                   "sweep_select", sweep_kind)
    gi = capture(frame_run(gi_frame, gi_cfg(), accel), intersect_sweep,
                 "sweep_select", sweep_kind)
    dflt = capture(frame_run(default, dcfg, None), intersect_brute,
                   "mt_select_brute", k1_kind)

    geom = derive_geometry(scene)
    chunk = make_ray_chunks(scene, cfg).shape[0] // 2
    o, d = camera_rays(scene, cfg, chunk, SeededUniforms(6, chunk))
    sw = dict(zip(SWEEP_ARGS, prepare_sweep(accel, o, d, geom.tri_valid)))
    sw.update(eps=EPS, cull=True, any_hit=False)
    k1 = dict(o=o, d=d, v0=geom.v0, e1=geom.e1, e2=geom.e2, eps=EPS,
              cull=True, tri_mask=geom.tri_valid, t_max=None, any_hit=False,
              tri_soa=geom.tri_soa)
    calls = {
        "sweep primary chunk (headline)": sweep_call("primary chunk", sw),
        "sweep full-reach secondary (GI frame)": sweep_call(
            "GI secondary", gi["secondary"]),
        "sweep shadow (headline frame)": sweep_call("headline shadow",
                                                    head["shadow"]),
        "K1 primary chunk (headline)": k1_call("K1 primary chunk", k1),
        "K1 shadow (default frame)": k1_call("default shadow",
                                             dflt["shadow"]),
    }
    more = {}
    if "--fill-targets" in sys.argv[1:]:
        more["fill_target_ms"] = fill_targets(gi["secondary"], k1)
    report("6 kernels on the dominant calls", calls=calls, **more)
    return calls


def fill_targets(sweep_args, k1_args):
    """With --fill-targets only: the GI secondary sweep call and K1's
    primary chunk at fill targets of 16, 32 and 64 blocks per SM
    (kernels.BLOCKS_PER_SM, which sets the split), each exact against the
    plain version.  The measurement behind BLOCKS_PER_SM (PERF.md)."""
    from simd_raytracer_tpu_torch import kernels
    from simd_raytracer_tpu_torch.ops import intersect_brute as B
    from simd_raytracer_tpu_torch.ops import intersect_sweep as S
    args = tuple(sweep_args.values())
    plain = (S.sweep_select_reference(*args), B.mt_select_reference(
        **{k: v for k, v in k1_args.items() if k != "tri_soa"}))
    keep, out = kernels.BLOCKS_PER_SM, {}
    try:
        for n in (16, 32, 64, 32, 16, 64):
            kernels.BLOCKS_PER_SM = n
            exact(SWEEP, f"fill {n}", S.sweep_select(*args), plain[0])
            exact(K1, f"fill {n}", B.mt_select_brute(**k1_args), plain[1])
            ms = out.setdefault(n, {"sweep": [], "k1": []})
            ms["sweep"].append(event_ms(lambda: S.sweep_select(*args), 10))
            ms["k1"].append(event_ms(lambda: B.mt_select_brute(**k1_args), 5))
    finally:
        kernels.BLOCKS_PER_SM = keep
    return out


def device_profile(run):
    """One call of `run` (a frame or an SGD step) under torch.profiler ->
    (wall s, device busy s, device events, top kernels, {name: device s}).
    Busy time is the union of the intervals of every device event
    (kernels, copies, sets)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        n, t = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (n + 1, t + e.duration_ns())
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return wall, busy_ns * 1e-9, len(spans), [
        {"kernel": k[:80], "calls": n, "s": t * 1e-9} for k, (n, t) in top], {
        k: t * 1e-9 for k, (_, t) in by_name.items()}


def sweep_calls(run):
    """One call of `run` with CUDA events around every sweep kernel call,
    summed by kind of ray: primary (culled closest hit), secondary
    (closest hit) and shadow (any-hit)."""
    from simd_raytracer_tpu_torch.ops import intersect_sweep
    calls = []
    kernel = intersect_sweep.sweep_select

    def timed(*args):
        count, order, any_hit, cull = args[0], args[1], args[11], args[10]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel(*args)
        end.record()
        kind = "shadow" if any_hit else "primary" if cull else "secondary"
        calls.append((kind, order.shape[0], count.sum(), start, end))
        return out

    intersect_sweep.sweep_select = timed
    try:
        run()
    finally:
        intersect_sweep.sweep_select = kernel
    torch.cuda.synchronize()
    rows = [(kind, tiles, int(reach), s.elapsed_time(e))
            for kind, tiles, reach, s, e in calls]
    out = {}
    for kind in ("primary", "secondary", "shadow"):
        mine = [r for r in rows if r[0] == kind]
        tiles = sum(r[1] for r in mine)
        ms = sum(r[3] for r in mine)
        out[kind] = {"calls": len(mine), "tiles": tiles,
                     "reach_per_tile": sum(r[2] for r in mine) / max(tiles, 1),
                     "ms": ms, "ms_per_call": ms / max(len(mine), 1)}
    small = [r for r in rows if r[1] <= 16]
    out["calls_le_16_tiles"] = {
        "calls": len(small), "ms": sum(r[3] for r in small),
        "reach_per_tile": sum(r[2] for r in small)
        / max(sum(r[1] for r in small), 1)}
    out["slowest"] = [{"kind": k, "tiles": t, "reach_per_tile": n / t,
                       "ms": ms}
                      for k, t, n, ms in sorted(rows, key=lambda r: -r[3])[:5]]
    return out


def frame_run(scene, cfg, accel):
    import simd_raytracer_tpu_torch as T
    return lambda: T.render_frame(scene, cfg, device=DEV, accel=accel)


def phase_profile(phase, runs):
    """Where the time of earlier phases' frames or SGD steps goes, in this
    run.  runs: label -> (run, unprofiled seconds of one call, whether it
    runs the sweep)."""
    for label, (run, frame_s, sweep) in runs.items():
        wall, busy, n_events, top, _ = device_profile(run)
        fields = dict(profiled_wall_s=wall, device_busy_s=busy,
                      device_events=n_events,
                      busy_share_of_profiled_frame=busy / wall,
                      unprofiled_frame_s=frame_s,
                      busy_share_of_unprofiled_frame=busy / frame_s,
                      top_device=top)
        if sweep:
            fields["sweep_calls"] = sweep_calls(run)
        report(f"{phase} profile {label}", **fields)


def counts_reset() -> None:
    from simd_raytracer_tpu_torch.ops import (intersect_brute, intersect_kd,
                                              intersect_sweep)
    intersect_brute.LAUNCHES = 0
    intersect_sweep.LAUNCHES = 0
    intersect_kd.LAUNCHES = 0


def counts() -> dict:
    from simd_raytracer_tpu_torch.ops import (intersect_brute, intersect_kd,
                                              intersect_sweep)
    return {K1: intersect_brute.LAUNCHES, SWEEP: intersect_sweep.LAUNCHES,
            KD: intersect_kd.LAUNCHES}


def need_launches(what, launches, *kernels) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({launches})")


def torch_source(seed):
    """A uniform source drawing on the card from a generator seeded with
    `seed`: the same seed gives the same estimator."""
    from simd_raytracer_tpu_torch.ops.render import TorchUniforms
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return TorchUniforms(gen, DEV, torch.float32)


def gi_cfg():
    """The GI frame's config (phases 6, 8 and 13)."""
    import simd_raytracer_tpu_torch as T
    return T.RenderConfig(samples_per_pixel=2, max_ray_depth=5,
                          diffuse_reflection_ray_count=1,
                          bounce_mode="roulette", intersector="sweep")


def phase_gi(small, full, accel):
    import simd_raytracer_tpu_torch as T
    cases = {"split+jnp": dict(max_ray_depth=3),
             "roulette+sweep": dict(samples_per_pixel=2, max_ray_depth=5,
                                    bounce_mode="roulette",
                                    intersector="sweep")}
    out = {}
    for gi in (1, 2):
        for name, kw in cases.items():
            cfg = T.RenderConfig(diffuse_reflection_ray_count=gi, **kw)
            out[f"gi{gi} {name}"] = render_cpu_vs_cuda(
                f"GI gi={gi} {name}", small, cfg, 20 + gi)
    report("8 GI small render cpu vs cuda",
           triangles=int(small.tri_valid.sum()), cases=out)
    counts_reset()
    cfg = gi_cfg()
    frame = full.replace(height=FRAME, width=FRAME)
    _, _, frame_s = render_timed("GI frame roulette+sweep gi1", frame, cfg,
                                 accel, frames=1, phase="8")
    launches = counts()
    need_launches("GI frame", launches, SWEEP)
    return launches, (frame_run(frame, cfg, accel), frame_s, True)


def interior_ids(scene, cfg, n):
    """n ray ids from the middle of the frame (bench.py:188-191)."""
    total = scene.height * scene.width * cfg.samples_per_pixel
    n = min(total, n)
    return torch.arange(n, dtype=torch.int32, device=DEV) + (total - n) // 2


def phase_grad_small(small):
    """CUDA against CPU gradients of a float32 render.  The tolerance is
    1e-3 * max|g_cpu| + 1e-6 + 2 * the CPU's own float32 error (its
    distance to the float64 gradient of the same render): the gathers'
    backward sums terms that cancel (refine's 1/det on grazing hits), so a
    float32 sum in another order, or with atomics, moves by about that
    error; measured 6.6e-6 on a vertex whose gradient is 6.3e-3."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
    from simd_raytracer_tpu_torch.ops import grad as G
    from torch_scenes import SeededUniforms
    cfg = T.RenderConfig(samples_per_pixel=2, max_ray_depth=5,
                         diffuse_reflection_ray_count=1,
                         bounce_mode="roulette", intersector="sweep")
    ids = interior_ids(small, cfg, 8192)
    accel = build_sweep_for_scene(small)
    f64 = small.map(lambda t: t.double() if t.is_floating_point() else t)
    res = {}
    for name, scene, dev in (("cpu", small, "cpu"), (DEV, small, DEV),
                             ("cpu64", f64, "cpu")):
        params, skeleton = G.split_params(scene.to(dev))
        t0 = time.perf_counter()
        res[name] = G.loss_and_grad(
            params, skeleton, cfg, ids.to(dev),
            torch.full((len(ids), 3), 0.1, dtype=scene.vertices.dtype,
                       device=dev), SeededUniforms(9, 0), accel.to(dev))
        if dev == DEV:
            torch.cuda.synchronize()
        res[name] += (time.perf_counter() - t0,)
    (lc, gc, sc), (lg, gg, sg), (_, g64, _) = (res["cpu"], res[DEV],
                                              res["cpu64"])
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    errs = {}
    for k in G.DIFF_PARAM_NAMES:
        g, c = gg[k].cpu(), gc[k]
        err = float((g - c).abs().max())
        scale = float(c.abs().max())
        f32_err = float((c.double() - g64[k]).abs().max())
        tol = 1e-3 * scale + 1e-6 + 2 * f32_err
        errs[k] = {"max_abs_err": err, "max_abs_cpu": scale,
                   "cpu_f32_err_vs_f64": f32_err, "tol": tol}
        if not (torch.isfinite(g).all() and err <= tol):
            raise AssertionError(f"gradient {k}: CUDA vs CPU max |d| {err} "
                                 f"above {tol}")
    if not (torch.isfinite(lg) and loss_rel <= 1e-5):
        raise AssertionError(f"losses differ: {float(lg)} vs {float(lc)}")
    report("9 gradients cpu vs cuda", rays=len(ids), loss=float(lc),
           loss_rel_err=loss_rel,
           tolerance="1e-3*max|g_cpu|+1e-6+2*max|g_cpu-g_cpu_f64|",
           grads=errs, cpu_s=sc, cuda_s=sg)


def phase_train(label, phase, scene, accel, spp, gi, fd):
    """bench.py's backward phase on the full scene: 65,536 interior ray
    ids, zero target, `train_steps` of 8 SGD steps once warm and once
    timed; with `fd`, first the finite-difference check of
    d loss / d light_intensity (bench.py:195-218)."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops import grad as G
    cfg = T.RenderConfig(samples_per_pixel=spp, max_ray_depth=5,
                         chunk_size=TRAIN_RAYS,
                         diffuse_reflection_ray_count=gi,
                         bounce_mode="roulette", intersector="sweep")
    ids = interior_ids(scene, cfg, cfg.chunk_size)
    target = torch.zeros((len(ids), 3), device=DEV)
    params, skeleton = G.split_params(scene)
    fields = {}
    counts_reset()
    with torch.no_grad():
        loss0 = float(G.pixel_loss(params, skeleton, cfg, ids, target,
                                   torch_source(0), accel))
    _, grads = G.loss_and_grad(params, skeleton, cfg, ids, target,
                                    torch_source(0), accel)
    for k in ("vertices", "mat_albedo", "light_intensity"):
        if not (torch.isfinite(grads[k]).all()
                and float(grads[k].abs().max()) > 0):
            raise AssertionError(f"{label}: gradient of {k} is zero or "
                                 f"not finite")
    if fd:
        eps_fd = 0.05 * float(params["light_intensity"].abs().max()) or 1.0

        def loss_at(di):
            p = dict(params, light_intensity=params["light_intensity"] + di)
            with torch.no_grad():
                return float(G.pixel_loss(p, skeleton, cfg, ids, target,
                                          torch_source(0), accel))

        fd_val = (loss_at(eps_fd) - loss_at(-eps_fd)) / (2 * eps_fd)
        an = float(grads["light_intensity"].sum())
        rel = abs(fd_val - an) / max(abs(fd_val), abs(an), 1e-12)
        fields.update(fd_step=eps_fd, fd=fd_val, analytic=an, fd_rel_err=rel)
        if not rel < 0.05:
            raise AssertionError(f"{label}: FD mismatch, analytic {an} vs "
                                 f"FD {fd_val}")
    times = []
    for run in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = G.train_steps(
            params, skeleton, cfg, ids, target,
            lambda i, run=run: torch_source(100 * (run + 1) + i),
            n_steps=8, accel=accel)
        losses = losses.cpu()
        times.append(time.perf_counter() - t0)
        if not torch.isfinite(losses).all():
            raise AssertionError(f"{label}: non-finite losses {losses}")
    with torch.no_grad():
        loss1 = float(G.pixel_loss(params, skeleton, cfg, ids, target,
                                   torch_source(0), accel))
    launches = counts()
    need_launches(label, launches, SWEEP)
    if not loss1 < loss0:
        raise AssertionError(f"{label}: loss did not fall: {loss0} -> {loss1}")
    per_step = times[1] / 8
    report(f"{phase} {label}", rays=len(ids), spp=spp, gi=gi, depth=5,
           steps_per_call=8, warm_s=times[0], timed_s=times[1],
           s_per_step=per_step, fwd_bwd_rays_per_s=len(ids) / per_step,
           loss_before=loss0, loss_after_16_steps=loss1,
           losses_timed=losses.tolist(), launches=launches, **fields)

    def one_step():
        G.train_step(params, skeleton, cfg, ids, target, torch_source(7),
                     accel=accel)

    return launches, (one_step, per_step, True)


def phase_refexact(small, full, accel):
    import simd_raytracer_tpu_torch as T
    out = {}
    for isect in ("sweep", "jnp", "fast"):
        cfg = T.RenderConfig(max_ray_depth=5, occlusion_mode="march",
                             intersector=isect)
        out[isect] = render_cpu_vs_cuda(f"refexact {isect}", small, cfg, 30)
    report("12 refexact small render cpu vs cuda",
           triangles=int(small.tri_valid.sum()), cases=out)
    counts_reset()
    frame = full.replace(height=FRAME, width=FRAME)
    cfg = T.RenderConfig(occlusion_mode="march", intersector="sweep")
    _, _, frame_s = render_timed("refexact frame split+march+sweep", frame,
                                 cfg, accel, frames=1, phase="12")
    launches = counts()
    need_launches("refexact frame", launches, SWEEP)
    return launches, (frame_run(frame, cfg, accel), frame_s, True)


def kd_call(label, a, tree):
    """Hold the kd kernel on one call exactly against its plain version
    (accel/traverse.py::kd_select on the same CUDA tensors); time both;
    bound: the live leaf lanes the walk tests (kd_work_pairs) x 54 float
    operations over 67 TFLOP/s, or the bytes it must move."""
    from simd_raytracer_tpu_torch.accel.traverse import (kd_select,
                                                         kd_work_pairs)
    from simd_raytracer_tpu_torch.ops.intersect_kd import kd_select_cuda
    args = (a["o"], a["d"], a["v0"], a["e1"], a["e2"], a["eps"], a["cull"],
            a["tri_mask"], tree)
    got = kd_select_cuda(*args)
    exact(KD, label, got, kd_select(*args))
    pairs = kd_work_pairs(*args)
    ms, plain_ms, runs = time_call(lambda: kd_select_cuda(*args),
                                   lambda: kd_select(*args), 10)
    r, t = a["o"].shape[0], a["v0"].shape[0]
    # o, d in and idx, hit out: 29 bytes a ray; the packed triangle and
    # its mask: 40 bytes; the node records and the leaf lists.
    n_bytes = (29 * r + 40 * t + 40 * tree.num_nodes
               + 4 * tree.leaf_tris.numel())
    b_ms, by = bound(pairs, n_bytes)
    return dict(kind=ray_kind(a.get("any_hit", False), a["cull"]), rays=r,
                hits=int(got[1].sum()), ms=ms, runs_ms=runs,
                plain_ms=plain_ms, pairs_needed=pairs,
                pairs_per_ray=pairs / max(r, 1), bound_ms=b_ms, bound_by=by,
                share_of_bound=b_ms / ms, exact=True)


def kd_config():
    """The reference binary's configuration (phases 14 and 15): spp 1,
    depth 5, split, fast occlusion, the kd-tree, bucket tiles."""
    import simd_raytracer_tpu_torch as T
    return T.RenderConfig(max_ray_depth=5, intersector="kdtree")


def phase_kd(scene):
    """The kd build of the full scene by NumPy and by the native builder
    (equal arrays); the kd kernel exact against its plain version on the
    middle 16,384-ray primary chunk of the kd frame's bucket order (K1
    timed on it too) and on the largest shadow call of a 480x480 kd
    frame, timed against its bound; the kd kernel and a kdleaf sweep
    against K1 on 8,192 random rays."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.models.camera import primary_rays
    from simd_raytracer_tpu_torch.accel.build import (KDTREE_FIELDS,
                                                      build_kdtree_for_scene)
    from simd_raytracer_tpu_torch.accel.sweep import build_sweep_for_scene
    from simd_raytracer_tpu_torch.ops import intersect as I
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    from simd_raytracer_tpu_torch.ops.intersect_kd import kd_select_cuda
    from simd_raytracer_tpu_torch.ops.intersect_sweep import (
        make_sweep_select)
    from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
    from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
    host = scene.to("cpu")
    secs = {}
    for name, native in (("numpy", False), ("native", True)):
        t0 = time.perf_counter()
        tree = build_kdtree_for_scene(host, use_native=native)
        secs[name] = time.perf_counter() - t0
        if native:
            for f in KDTREE_FIELDS:
                if not torch.equal(getattr(tree, f), getattr(np_tree, f)):
                    raise AssertionError(f"native kd build differs: {f}")
        np_tree = tree
    tree = tree.to(DEV)
    geom = T.derive_geometry(scene)
    leaf_lens = (tree.leaf_tris >= 0).sum(dim=1)

    ids = make_ray_chunks(scene, kd_config(), SchedulingType.BUCKET_TILES)
    chunk = ids[ids.shape[0] // 2]
    pix = torch.from_numpy(chunk[chunk < scene.height * scene.width]
                           ).long().to(DEV)
    half = torch.full(pix.shape, 0.5, device=DEV)
    o, d = primary_rays(scene, kd_config().fov_degrees, pix % scene.width,
                        pix // scene.width, half, half)
    primary = dict(o=o, d=d, v0=geom.v0, e1=geom.e1, e2=geom.e2, eps=EPS,
                   cull=True, tri_mask=geom.tri_valid)

    def kind_of(a):
        return ray_kind(a["any_hit"], a["cull"]), a["o"].shape[0]

    frame = scene.replace(height=FRAME, width=FRAME)
    kept = capture(lambda: T.render_frame(
        frame, kd_config(), device=DEV, accel=tree,
        scheduling=SchedulingType.BUCKET_TILES), I, "_kd_window_select",
        kind_of)
    calls = {"kd primary chunk (kd frame)": kd_call("kd primary chunk",
                                                    primary, tree),
             "kd shadow (480x480 kd frame)": kd_call(
                 "kd shadow", kept["shadow"], tree)}
    # K1 on the same calls, for comparison.
    for what, a in (("kd primary chunk (kd frame)", primary),
                    ("kd shadow (480x480 kd frame)", kept["shadow"])):
        calls[what]["k1_ms_same_call"] = event_ms(lambda: mt_select_brute(
            a["o"], a["d"], a["v0"], a["e1"], a["e2"], EPS, a["cull"],
            a["tri_mask"], a.get("t_max"), a.get("any_hit", False),
            tri_soa=geom.tri_soa), 5)

    o, d, tmax = random_rays(scene, 8192, seed=14)
    sweep = build_sweep_for_scene(host, partition="kdleaf").to(DEV)
    select = make_sweep_select(sweep)
    solid = geom.tri_valid & ~geom.tri_transmissive
    vs_k1 = {}
    for cull in (True, False):
        brute = mt_select_brute(o, d, geom.v0, geom.e1, geom.e2, EPS, cull,
                                geom.tri_valid)
        for label, got in (
                ("kd", kd_select_cuda(o, d, geom.v0, geom.e1, geom.e2, EPS,
                                      cull, geom.tri_valid, tree)),
                ("kdleaf sweep", select(o, d, geom.v0, geom.e1, geom.e2,
                                        EPS, cull, geom.tri_valid))):
            exact(KD if label == "kd" else SWEEP,
                  f"{label} vs K1 cull={cull}", got, brute, where=brute[1])
            vs_k1[f"{label} cull={cull}"] = int(got[1].sum())
    for any_hit in (False, True):
        brute = mt_select_brute(o, d, geom.v0, geom.e1, geom.e2, EPS, False,
                                solid, tmax, any_hit)
        got = select(o, d, geom.v0, geom.e1, geom.e2, EPS, False, solid,
                     tmax, any_hit)
        exact(SWEEP, f"kdleaf sweep vs K1 window any_hit={any_hit}", got,
              brute, where=brute[1])
        vs_k1[f"kdleaf sweep window any_hit={any_hit}"] = int(got[1].sum())
    torch.cuda.synchronize()
    report("14 kd build and kernel", triangles=int(geom.tri_valid.sum()),
           build_s=secs, nodes=tree.num_nodes,
           leaves=int((tree.leaf_id >= 0).sum()), depth=tree.depth,
           leaf_cap=tree.leaf_cap, leaf_refs=int(leaf_lens.sum()),
           leaf_median=float(leaf_lens.float().median()),
           leaf_max=int(leaf_lens.max()), calls=calls,
           random_rays=len(o), hits_vs_k1=vs_k1,
           kdleaf_slices=sweep.num_slices, exact=True)
    return calls


def phase_refbin(tmp):
    """The reference binary's path at full width: parse the file, build
    the kd-tree, render in bucket tiles through the kd kernel, save the
    PPM; held against the brute-force frame (K1, linear order) and
    profiled as phase 7."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.accel.build import build_kdtree_for_scene
    from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
    from simd_raytracer_tpu_torch.utils.ppm import image_to_u8, read_ppm
    from simd_raytracer_tpu_torch.utils.profiling import PhaseTimer
    from torch_scenes import mixed_doc
    path = os.path.join(tmp, "refbin.crtscene")
    with open(path, "w") as f:
        json.dump(mixed_doc(REFBIN, REFBIN), f)
    timer = PhaseTimer()
    with timer.phase("load"):
        scene = T.parse_scene_file(path)
    with timer.phase("accel_build"):
        tree = build_kdtree_for_scene(scene)
    cfg = kd_config()
    sched = SchedulingType.BUCKET_TILES

    def run():
        return T.render_frame(scene, cfg, device=DEV, accel=tree,
                              scheduling=sched)

    counts_reset()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts()
    need_launches("kd frame", launches, KD)
    out = os.path.join(tmp, "refbin.ppm")
    with timer.phase("save_ppm"):
        T.save_ppm(img, out)
    if read_ppm(out).shape != (REFBIN, REFBIN, 3):
        raise AssertionError("kd frame PPM has the wrong shape")

    ref = T.render_frame(scene, T.RenderConfig(max_ray_depth=5),
                         device=DEV).cpu()
    got = img.cpu()
    err = float((got - ref).abs().max())
    ua, ub = image_to_u8(ref).astype(int), image_to_u8(got).astype(int)
    off = int((ua != ub).sum())
    pixels = int((got != ref).any(dim=-1).sum())
    fields = dict(width=REFBIN, height=REFBIN, spp=1, depth=5,
                  bucket=scene.bucket_size, warm_s=times[0], frame_s=times[1],
                  primary_rays_per_s=REFBIN * REFBIN / times[1],
                  phases_s=dict(timer.seconds), launches=launches,
                  vs_brute_force=dict(max_abs_err=err,
                                      pixels_differing=pixels,
                                      ppm_channels_differing=off,
                                      ppm_max_channel_diff=int(
                                          np.abs(ua - ub).max())))
    if not (bool(torch.isfinite(got).all()) and err <= 1e-4
            and int(np.abs(ua - ub).max()) <= 1 and off <= 0.001 * ua.size):
        report("15 kd frame (failed)", **fields)
        raise AssertionError(f"kd frame differs from the brute-force frame: "
                             f"max |d| {err}, {pixels} pixels, {off} PPM "
                             f"channels")
    wall, busy, n_events, top, by_name = device_profile(run)
    kd_s = sum(t for k, t in by_name.items() if "kd_select" in k)
    fields.update(profiled_wall_s=wall, device_busy_s=busy,
                  device_events=n_events,
                  busy_share_of_profiled_frame=busy / wall,
                  busy_share_of_unprofiled_frame=busy / times[1],
                  kd_kernel_s=kd_s, kd_share_of_busy=kd_s / busy,
                  top_device=top)
    report("15 kd frame (reference binary path)", **fields)
    return launches


def phase_progressive(tmp, full, accel):
    """render_progressive of the headline config (960x960, roulette +
    sweep) at 8 spp in batches of 4, once whole and once stopped after a
    batch and resumed from its checkpoint; a 4-frame orbit at 480x480;
    the wavefront occupancy of one headline chunk; the CLI on a small
    generated scene with --intersector kdtree --scheduling bucket
    --profile."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
    from simd_raytracer_tpu_torch.utils.animation import (orbit_path,
                                                          render_animation)
    from simd_raytracer_tpu_torch.utils.checkpoint import render_progressive
    from simd_raytracer_tpu_torch.utils.profiling import wavefront_occupancy
    from simd_raytracer_tpu_torch.utils.ppm import read_ppm
    from torch_scenes import mixed_doc
    cfg = T.RenderConfig(samples_per_pixel=8, max_ray_depth=5,
                         bounce_mode="roulette", intersector="sweep")
    counts_reset()
    t0 = time.perf_counter()
    whole = render_progressive(full, cfg, 8, 4, accel=accel, device=DEV)
    whole_s = time.perf_counter() - t0
    ck = os.path.join(tmp, "progressive.ckpt.npz")

    class Stop(Exception):
        pass

    def stop(done, _img):
        if done >= 4:
            raise Stop

    try:
        render_progressive(full, cfg, 8, 4, checkpoint_path=ck,
                           on_batch=stop, accel=accel, device=DEV)
        raise AssertionError("progressive render did not stop")
    except Stop:
        pass
    seen = []
    resumed = render_progressive(full, cfg, 8, 4, checkpoint_path=ck,
                                 on_batch=lambda n, _i: seen.append(n),
                                 accel=accel, device=DEV)
    # index_add_ on CUDA sums a pixel's samples with atomics in no fixed
    # order, so the last bits of a resumed batch may differ.
    diff = float(np.abs(resumed - whole).max())
    rel = diff / float(np.abs(whole).max())
    if not (seen == [8] and np.isfinite(resumed).all() and rel <= 1e-6):
        raise AssertionError(f"resumed render: batches {seen}, max |d| "
                             f"{diff} ({rel} relative)")
    launches = counts()
    need_launches("progressive render", launches, SWEEP)

    frame = full.replace(height=FRAME, width=FRAME)
    orbit_cfg = T.RenderConfig(max_ray_depth=5, bounce_mode="roulette",
                               intersector="sweep")
    t0 = time.perf_counter()
    imgs = render_animation(orbit_path(frame, 4), orbit_cfg,
                            out_dir=os.path.join(tmp, "orbit"), accel=accel,
                            device=DEV)
    orbit_s = time.perf_counter() - t0
    ppms = [open(os.path.join(tmp, "orbit", f"frame_{i:04d}.ppm"),
                 "rb").read() for i in range(4)]
    if len(set(ppms)) != 4 or not all(
            read_ppm(os.path.join(tmp, "orbit", f"frame_{i:04d}.ppm")).shape
            == (FRAME, FRAME, 3) for i in range(4)):
        raise AssertionError("orbit frames are not 4 distinct PPMs")

    hcfg = T.RenderConfig(samples_per_pixel=4, max_ray_depth=5,
                          bounce_mode="roulette", intersector="sweep")
    # The chunk that holds the image centre's first sample (the middle
    # chunk of the tiled order lies on the image's left and right edges,
    # where every ray misses).
    ids = make_ray_chunks(full, hcfg)
    centre = (full.height // 2 * full.width + full.width // 2) * 4
    chunk = ids[int(np.nonzero((ids == centre).any(axis=1))[0][0])]
    occ = wavefront_occupancy(full, hcfg, torch.from_numpy(chunk),
                              accel=accel, device=DEV)
    valid = int((chunk < full.height * full.width * 4).sum())
    if not (occ[0] == valid and 0 < occ[1] < occ[0]
            and all(a >= b for a, b in zip(occ, occ[1:]))):
        raise AssertionError(f"occupancy {occ} of {valid} valid rays")

    path = os.path.join(tmp, "cli.crtscene")
    with open(path, "w") as f:
        json.dump(mixed_doc(96, 128, g=32, subdiv=3), f)
    out = os.path.join(tmp, "cli.ppm")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "simd_raytracer_tpu_torch", path, "-o", out,
         "--intersector", "kdtree", "--scheduling", "bucket", "--profile"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0 or read_ppm(out).shape != (96, 128, 3):
        raise AssertionError(f"CLI exit {proc.returncode}:\n{proc.stdout}"
                             f"\n{proc.stderr[-4000:]}")
    report("16 progressive, animation, occupancy, CLI",
           progressive=dict(width=full.width, height=full.height,
                            total_spp=8, spp_per_batch=4, whole_s=whole_s,
                            resumed_batches=seen, max_abs_diff=diff,
                            max_rel_diff=rel,
                            bitwise_equal=bool(np.array_equal(resumed,
                                                              whole))),
           launches=launches,
           orbit=dict(frames=len(imgs), size=FRAME, seconds=orbit_s,
                      distinct_ppms=len(set(ppms))),
           occupancy=occ, cli=dict(exit=proc.returncode, seconds=cli_s,
                                   stdout=proc.stdout.strip().splitlines()))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch import derive_geometry
    from torch_scenes import mixed_doc, terrain_doc

    t_start = time.perf_counter()
    card = smi()
    print(card, flush=True)
    phase_build()

    full = T.parse_scene_dict(mixed_doc(512, 512)).to(DEV)
    phase_k1(full, derive_geometry(full))
    phase_sweep("mixed 106.5k", full)
    phase_sweep("terrain 250k", T.parse_scene_dict(terrain_doc(354, 512, 512)))

    with tempfile.TemporaryDirectory() as tmp:
        phase_small(tmp)
        frames, launches = phase_full(tmp)
        small = small_scene(tmp)
    calls = phase_timed(frames, frames["headline"][0], frames["headline"][2])
    phase_profile("7", {
        label: (frame_run(scene, cfg, accel), frame_s,
                cfg.intersector == "sweep")
        for label, (scene, cfg, accel, frame_s) in frames.items()})

    full, _, accel, _ = frames["headline"]
    runs = {}
    paths = {"5 headline+default+bitmap frames": dict(launches)}
    paths["8 GI frame"], runs["GI frame"] = phase_gi(small, full, accel)
    phase_grad_small(small)
    for label, phase, spp, gi in (("fwd+bwd", "10", 4, 0),
                                  ("northstar", "11", 128, 1)):
        paths[f"{phase} {label}"], runs[f"{label} step"] = phase_train(
            label, phase, full, accel, spp=spp, gi=gi, fd=gi > 0)
    paths["12 refexact frame"], runs["refexact frame"] = phase_refexact(
        small, full, accel)
    phase_profile("13", runs)
    kd_calls = phase_kd(full)
    with tempfile.TemporaryDirectory() as tmp:
        paths["15 kd frame"] = phase_refbin(tmp)
        paths["16 progressive+orbit"] = phase_progressive(tmp, full, accel)
    for name, more in paths.items():
        if name[0] != "5":
            for k in launches:
                launches[k] += more[k]

    # The kernel line: the sweep on the GI frame's full-reach secondary
    # call, K1 on the headline's 16,384-ray primary chunk (phase 6), the
    # kd kernel on the kd frame's (phase 14); `call` names it.
    calls.update(kd_calls)
    for kernel, what in ((K1, "K1 primary chunk (headline)"),
                         (SWEEP, "sweep full-reach secondary (GI frame)"),
                         (KD, "kd primary chunk (kd frame)")):
        call = calls[what]
        KERNELS[kernel].update(
            launches=launches[kernel], max_abs_err=MAX_ERR[kernel],
            ms=call["ms"], plain_ms=call["plain_ms"],
            bound_ms=call["bound_ms"], bound_by=call["bound_by"],
            library_ms=None,
            call={"what": what, "kind": call["kind"], "rays": call["rays"],
                  **{k: call[k] for k in ("tiles", "triangles", "split")
                     if k in call}})
    report("done", seconds=time.perf_counter() - t_start,
           launches_by_path=paths)
    print(card)
    print(json.dumps({"kernels": list(KERNELS.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
