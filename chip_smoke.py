#!/usr/bin/env python3
"""Smoke run of the PyTorch port (simd_raytracer_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --fill-targets   # phase 6 also times the split's
                                           # fill targets
    python3 chip_smoke.py --kd-shapes      # phase 14 also times every shape
                                           # of the kd kernel

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
  5. full-size renders on CUDA, with every kernel launch counted; the
     frames of each config (the headline's at spp 4) bitwise equal;
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
  8. diffuse GI: small renders (64x64) on the CPU and on CUDA with the
     same uniforms (gi 1 and 2, split + brute force and roulette + sweep),
     images within 1e-4; then one timed GI frame of the full scene;
  9. gradients of a small scene on CUDA against the CPU: losses within
     1e-5 relative, every gradient within 1e-3 * max|g_cpu| + 1e-6 plus
     twice the CPU's own float32 error against float64;
 10. the fwd+bwd path at full width (bench.py's backward phase): SGD
     steps of 65,536 rays, timed;
 11. northstar: the same at 128 spp with GI, after a finite-difference
     check of d loss / d light_intensity;
 12. refexact (split + march): small renders (64x64) on the CPU and on
     CUDA under the sweep, brute force and fast selects, then timed
     480x480 frames of the full scene under the sweep, under fast
     (bench.py's own select: every select through the fast kernel, none
     through its plain version) and under brute force, each rendered
     twice, bitwise equal; the fast frame held against the brute-force one
     by phase 15's PPM rule, but for at most FAST_FLIPS (1) pixel that
     must be a last-ulp flip seen on its primary ray (a near tie, or a ray
     on an edge) where the plain fast version picks the kernel's winner;
 13. where the time of phase 8's GI frame, one SGD step of phases 10 and
     11 and phase 12's sweep and fast frames goes, as phase 7;
 14. the kd-tree of the full scene built by NumPy and by the native
     builder (equal arrays); the kd kernel exact against its plain
     version on the middle 16,384-ray primary chunk of phase 15's bucket
     order, on the same rays in a seeded random order and on the largest
     shadow call of a 480x480 kd frame, timed against its bound (the live
     leaf lanes the walk tests x 54 over 67 TFLOP/s) and beside K1 on the
     same calls, with the kernel's counter (triangles staged, pair slots
     run over pairs needed; its pair tests must equal the walk's); with
     --kd-shapes, every instantiated shape of the kd kernel on those
     calls; the depth-14 tree of the full scene (5,735 nodes, more than a
     block's shared memory could hold) on the primary chunk and its own
     480x480 frame's largest
     shadow call, exact and timed; the kd kernel and a kdleaf sweep
     against K1 on 8,192 random rays;
 15. the reference binary's path at full width: parse, native kd build,
     a 960x960 spp 1 depth 5 split frame through the kd kernel in bucket
     tiles (two frames, bitwise equal), save_ppm; held against the
     brute-force frame (max |d| 1e-4, PPM channels off by at most 1 on at
     most 0.1%), timed and profiled; a 480x480 frame on the depth-14 tree
     held against the brute-force frame the same way;
 16. render_progressive of the headline config at 8 spp in batches of 4,
     stopped after one batch and resumed from its checkpoint (bitwise
     equal to the whole render); a 4-frame orbit at 480x480; the
     wavefront occupancy of one headline chunk; the CLI with
     --intersector kdtree --scheduling bucket --profile;
 17. parallel/sharding.py over an NCCL world of one: the headline frame
     sharded (bitwise equal to render_frame with the same per-chunk
     sources, timed beside phase 5's), one sharded SGD step of phase 10's
     65,536 rays (bitwise equal to train_step), the port's dry run
     (graft_entry.dryrun_multichip(1)).
 18. the fast kernel on the calls of a 480x480 refexact frame (split +
     march + fast) of the full scene: its middle 16,384-ray primary chunk
     (which hits), the largest closest-hit march call (a t_max window),
     the largest any-hit shadow call over the solid triangles and the
     largest any-hit probe over the glass ones (the march's second probe),
     each exact against the plain version, timed beside K1 (and the
     kernel alone by the profiler), with its bound (each pair the call
     needs charged FAST_STAGE_OPS for the tests it reaches, over 67
     TFLOP/s); scripts/torch_fast_ab.py times the same calls beside an
     earlier tree's fast select;
 19. the mxu select (torch.matmul and torch ops, no kernel): a 48x48 spp 4
     render on the CPU and on CUDA (JAX's bar for mxu renders: 2e-3 *
     max(1, |a|) on more than 99% of values); the refexact frame's middle
     primary chunk timed beside its products alone (the "library" time)
     and K1, winners against K1 by JAX's select bar; one timed 480x480
     frame of the full scene (split, spp 1, depth 5) against the
     brute-force frame.
 20. the gathers' backward (ops/gather.py::row_sums, csrc/gather_grad.cu)
     at the train step's shapes: 65,536 entries over 2,012 rows (half of
     them on row 0, as missed slots read triangle 0) at widths 3, 6 and 9,
     and one row of 65,536 duplicates: bitwise equal to its plain version
     and to itself run again, timed whole (the sort and both passes), each
     pass by the profiler, beside its bound (its bytes over 3.35 TB/s),
     the plain version and index_put_(accumulate=True); then two
     loss_and_grad calls of phase 10's step with GI (bitwise equal, every
     gradient), the gather kernel's launches counted.
 21. the shading's backward (csrc/shade_grad.cu) on every shade call of
     one SGD step of the benchmark's train cell (the hw15/scene2 stand-in
     of perfbench/, its 65,536 middle ray ids, roulette, one diffuse ray,
     the brute-force select), each call's rows as the render loop made
     them and every float input requiring grad: bitwise the plain
     version on the values, within the float64 yardstick of
     tests/yardstick.py on every gradient, bounce 0's backward timed as
     below (the kernel line's shade_grad entry, with the share of the
     yardstick's allowance used as `yardstick_share`); then one bounce of
     shading (ops/shade.py, csrc/shade.cu) on two calls of
     random rows over the full scene (tests/torch_scenes.py::shade_rows):
     262,144 rows under the GI frame's shading (split, one diffuse ray,
     march occlusion, the fast select) and 16,384 under the kd frame's
     (split, no GI, two lights, fast occlusion, the kd-tree): the fused
     path (three launches) bitwise equal to the plain torch version on
     contrib and every child tensor, and, with every float input
     requiring grad, bitwise on the values through the autograd node and,
     on every input's gradient through its backward (csrc/shade_grad.cu),
     within the float64 yardstick of tests/yardstick.py (the plain
     version's float64 gradient from the same `need` and occlusion);
     each path's host ms (until the call returns), wall ms (to a
     synchronize), device busy ms and launches under torch.profiler, the
     three kernels' own device ms beside their byte bound (the call's
     inputs read once, its contributions, children and shadow rays
     written once, over 3.35 TB/s) and beside the plain version's own
     device ms from the same occlusion (`plain_shading_ms`: neither
     includes the `need` compaction or the occlusion query); the
     backward's two kernels' device ms and its segmented sums' (CUDA
     events around each launch) beside their byte bound (its inputs and
     incoming gradients read once, its gradients written once, over
     3.35 TB/s), and the whole backward's
     host ms, device busy ms and launches beside the plain version's
     autograd backward from the same occlusion.
 22. the hit record (csrc/trace.cu) on bounce 0 of one SGD step of the
     benchmark's train cell (65,536 rays, the brute-force select) and of
     its spp-128 cell (1,048,576 rays, the refitted sweep), the rays and
     winners as the render loop made them: the record bitwise the plain
     version's on every field; with o, d and every table requiring grad
     and random incoming gradients on every float field, the backward's
     gradients within the float64 yardstick of tests/yardstick.py;
     trace_record, and trace_record_grad with its two segmented sums,
     timed with CUDA events around each launch beside their byte bounds
     (each input byte read and each output byte written once, over 3.35
     TB/s), and the whole forward's and backward's host ms, device busy
     ms and events beside the plain version's.
Phases 5, 8-12, 15-17 and 20-22 each count the kernel launches of their
own paths from zero and fail if a kernel of the path never launched; the
kernel line reports their sum, with phase 6's, 14's and 18's times and
bounds of the sweep's full-reach secondary call and K1's, the kd kernel's
and the fast kernel's primary chunks, phase 20's of the gathers'
backward at width 9, phase 21's of the shade kernels on the GI call
and of their backward on the train step's bounce 0, and phase 22's of
the record's kernels on the train step's bounce 0 (named by each
entry's `call`).  The
last three lines are the card, a JSON object per kernel and
{"ok": true, ...}.
Every phase raises on failure, so the script exits non-zero.  It needs a
CUDA device and exits 1 without one.
"""

from __future__ import annotations

import contextlib
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
FAST = "fast_select"
GATHER = "gather_grad"
SHADE = "shade"
SHADE_GRAD = "shade_grad"
TRACE = "trace_record"
TRACE_GRAD = "trace_record_grad"
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
    FAST: {"name": FAST, "route": "cuda",
           "source": "simd_raytracer_tpu_torch/csrc/fast_select.cu",
           "replaces": "simd_raytracer_tpu/ops/intersect_mxu.py:67 (jnp)"},
    GATHER: {"name": GATHER, "route": "cuda",
             "source": "simd_raytracer_tpu_torch/csrc/gather_grad.cu",
             "replaces": "none: the JAX package leaves the gathers' "
                         "transpose (a scatter-add) to XLA"},
    SHADE: {"name": SHADE, "route": "cuda",
            "source": "simd_raytracer_tpu_torch/csrc/shade.cu",
            "replaces": "none: jnp (simd_raytracer_tpu/ops/shade.py, "
                        "which XLA fuses)"},
    SHADE_GRAD: {"name": SHADE_GRAD, "route": "cuda",
                 "source": "simd_raytracer_tpu_torch/csrc/shade_grad.cu",
                 "replaces": "none: the JAX package differentiates its jnp "
                             "shading through XLA"},
    TRACE: {"name": TRACE, "route": "cuda",
            "source": "simd_raytracer_tpu_torch/csrc/trace.cu",
            "replaces": "none: jnp (simd_raytracer_tpu/ops/intersect.py::"
                        "trace's refine and gathers, which XLA fuses)"},
    TRACE_GRAD: {"name": TRACE_GRAD, "route": "cuda",
                 "source": "simd_raytracer_tpu_torch/csrc/trace.cu",
                 "replaces": "none: the JAX package differentiates its jnp "
                             "record through XLA"},
}
# The largest error of each kernel against its plain version; for
# SHADE_GRAD the largest distance of its gradients from the float64
# yardstick's (tests/yardstick.py).
MAX_ERR = {K1: 0, SWEEP: 0, KD: 0, FAST: 0, GATHER: 0, SHADE: 0,
           SHADE_GRAD: 0, TRACE: 0, TRACE_GRAD: 0}
# The largest share of the yardstick's allowance that SHADE_GRAD's and
# TRACE_GRAD's gradients use (1 is the limit).
YARDSTICK_SHARE = {SHADE_GRAD: 0.0, TRACE_GRAD: 0.0}
# Edge of the square frames of phases 5 (default), 8, 12, 18 and 19, and
# the ray ids of each SGD step of phases 10 and 11 (bench.py's chunk).
FRAME = 480
# Pixels of phase 12's fast frame that may break the PPM rule against the
# jnp frame, each a last-ulp flip on its primary ray: the full scene's
# 480x480 frame has one, (8, 387), whose ray meets a triangle on an edge
# that the division-free accept takes and K1 rejects.
FAST_FLIPS = 1
# Edge of the small-scene images that phases 8 and 12 render on the CPU
# and on CUDA.
SMALL_CHECK = 64
TRAIN_RAYS = 65536
# Rows of the gathers' backward timed in phase 20: hw15/scene2's
# triangles, the table the train step's gathers read most.
GATHER_ROWS = 2012
# Edge of the reference binary's full-width frame (phase 15).
REFBIN = 960
# The kernel each select name runs on the card ("mxu" is torch.matmul and
# torch ops).
SELECT_KERNEL = {"jnp": K1, "pallas": K1, "sweep": SWEEP, "kdtree": KD,
                 "fast": FAST}


# The argument names of ops/intersect_sweep.py::sweep_select before eps,
# cull and any_hit, in order (prepare_sweep's tuple).
SWEEP_ARGS = ("count", "order", "tnear", "o", "d", "tmax", "tri_soa", "ids",
              "mask")


def bound_table(intersector: str, geom):
    """The table the render path's select for `intersector` ("jnp" or
    "fast") reads on `geom`, as its binding holds it (ops/intersect.py::
    make_select_fn): the brute-force kernel's packed triangles or the fast
    select's FastTable."""
    from simd_raytracer_tpu_torch.ops.intersect import make_select_fn
    return make_select_fn(intersector, geom=geom).keywords[
        {"jnp": "tri_soa", "fast": "table"}[intersector]]


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
    from simd_raytracer_tpu_torch.utils.profiling import SETUP
    t0 = time.perf_counter()
    kernels.library()
    ptxas = [" ".join(line.split()) for line in kernels.build_log.splitlines()
             if "entry function" in line or "Used" in line or "spill" in line]
    report("1 device+build", device=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda,
           build_s=SETUP.seconds.get("kernel_library"),
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
        t0 = time.perf_counter()
        with counting() as launches:
            imgs[dev] = T.render_frame(
                scene, cfg, device=dev,
                uniforms=lambda c: SeededUniforms(seed, c)).cpu()
        secs[dev] = time.perf_counter() - t0
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
    """One warm frame, then `frames` timed ones; checks the image.  The
    launches are the warm frame's (the timed frames run untraced)."""
    import simd_raytracer_tpu_torch as T
    times, first = [], None
    for i in range(frames + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting() if i == 0 else contextlib.nullcontext() as seen:
            img = T.render_frame(scene, cfg, device=DEV, accel=accel)
        if i == 0:
            launches = seen
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        # The same config and seed: every frame is bitwise the first.
        if first is None:
            first = img
        elif not torch.equal(img, first):
            raise AssertionError(
                f"{label}: two CUDA renders differ: max |d| "
                f"{float((img - first).abs().max())} on "
                f"{int((img != first).any(dim=-1).sum())} pixels")
    bg = scene.background.to(DEV)
    not_bg = float((img != bg).any(dim=-1).float().mean())
    if not (img.shape == (scene.height, scene.width, 3)
            and bool(torch.isfinite(img).all()) and not_bg > 0.01):
        raise AssertionError(f"{label}: bad image (shape {tuple(img.shape)}, "
                             f"non-background share {not_bg})")
    rays = scene.height * scene.width * cfg.samples_per_pixel
    mean = sum(times[1:]) / frames
    report(f"{phase} {label}", width=scene.width, height=scene.height,
           spp=cfg.samples_per_pixel, depth=cfg.max_ray_depth,
           bounce_mode=cfg.bounce_mode, intersector=cfg.intersector,
           warm_s=times[0], frame_s=times[1:], primary_rays_per_s=rays / mean,
           non_background=not_bg, bitwise_equal_frames=frames + 1,
           launches=launches)
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
    img, l_head, s_head = render_timed("headline roulette+sweep", scene,
                                       headline, accel)
    _, l_default, s_default = render_timed("default split+jnp", default,
                                           T.RenderConfig())
    _, l_bitmap, _ = render_timed("bitmap textures", bitmap,
                                  T.RenderConfig())
    launches = {k: l_head[k] + l_default[k] + l_bitmap[k] for k in l_head}

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
# The fast kernel (csrc/fast_select.cu) as written: the float operations a
# pair costs at each test it reaches (a masked triangle costs none), in
# order: det (3 mul, 2 add, the negation), its sign, |det| and the cull
# test; u_num (6 mul, 5 add), its signed value and two comparisons; v_num
# (6 mul, 5 add), its signed value, u + v and two comparisons; t_num (3
# mul, 3 add), its signed value, eps |det| and one comparison; the window
# (t_max |det|, one comparison); an accepted closest-hit pair's division
# and its comparison with the best.  Counted per call by fast_stage_pairs.
# 67 TFLOP/s counts an FMA as two operations; built without contraction,
# the kernel issues one operation an instruction, so it can reach at most
# half that rate (the bound is stated against the published peak).
FAST_STAGE_OPS = (9, 14, 15, 9, 2, 2)


def bound(pairs, n_bytes, ops_per_pair=OPS_PER_PAIR):
    """(bound ms, bound_by) of `pairs` pair tests moving `n_bytes`."""
    ops_ms = pairs * ops_per_pair / PEAK_F32 * 1e3
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
    from simd_raytracer_tpu_torch import kernels
    from simd_raytracer_tpu_torch.accel.sweep import R_TILE
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
                split=kernels.split(p * (R_TILE // S.GROUP), s,
                                    torch.cuda.get_device_properties(0)
                                    .multi_processor_count),
                ms=ms, runs_ms=runs, plain_ms=plain_ms, pairs_needed=pairs,
                bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms,
                pairs_tile_walk=tile_walk,
                bound_ms_tile_walk=bound(tile_walk, 0)[0], exact=True)


def k1_call(label, a):
    """The same for one captured brute-force call.  Pairs: every ray
    against every unmasked triangle; for any-hit, a hit ray needs at least
    one pair and a miss every one."""
    from simd_raytracer_tpu_torch import kernels
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
                split=kernels.split(-(-r // B.RAY_BLOCK),
                                    -(-int(a["v0"].shape[0]) // B.TRI_TILE),
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
              tri_soa=bound_table("jnp", geom))
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
    (kernels, copies, sets).  The port's spans open `srt.<name>` ranges
    under the profiler, which it mirrors onto the device's timeline as
    annotations; they are not work and are left out."""
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
        user = getattr(e, "is_user_annotation", None)
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or (user is not None and user())
                or e.name().startswith("srt.")):
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


@contextlib.contextmanager
def timed_launches(*names):
    """CUDA events around each call of the kernel library's C functions
    `names` (each one or more launches on the calling thread's current
    stream) made in the block -> {name: [ms of each call]}, filled when
    the block ends.  Unlike the profiler, it sees every launch however
    short the window (phase 21's backward).  Each timed call follows a
    spin of about 0.5 ms on the card (`torch.cuda._sleep`), so the host
    has queued the call before the card reaches it and the events time
    the kernels, not the host's launch latency."""
    from simd_raytracer_tpu_torch import kernels
    real = kernels.library
    lib, pairs, out = real(), [], {}

    class Timed:
        def __getattr__(self, attr):
            fn = getattr(lib, attr)
            if attr not in names:
                return fn

            def timed(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                start.record()
                rc = fn(*args)
                end.record()
                pairs.append((attr, start, end))
                return rc

            return timed

    timed_lib = Timed()
    kernels.library = lambda: timed_lib
    try:
        yield out
    finally:
        kernels.library = real
        torch.cuda.synchronize()
        for name, start, end in pairs:
            out.setdefault(name, []).append(start.elapsed_time(end))


def kernel_ms(fn, name, reps):
    """The kernel's own time, without its wrapper's host work: `reps`
    calls of `fn` under torch.profiler -> (mean device ms of the kernels
    whose name holds `name`, how many it recorded).  The mean is over the
    launches recorded, for the profiler can miss one (it has recorded 4
    of 5, PERF.md section 7)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA
          and name in e.name()]
    if not ns:
        raise AssertionError(f"the profiler saw no kernel named {name}")
    return sum(ns) * 1e-6 / len(ns), len(ns)


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


# The port's record counts each select kernel's launches under these
# names (utils/profiling.py).
LAUNCH_COUNTERS = {K1: "select.launches.brute",
                   SWEEP: "select.launches.sweep",
                   KD: "select.launches.kd", FAST: "select.launches.fast",
                   GATHER: "gather.launches", SHADE: "shade.launches",
                   SHADE_GRAD: "shade.backward.launches",
                   TRACE: "trace.launches",
                   TRACE_GRAD: "trace.backward.launches"}


@contextlib.contextmanager
def counting():
    """The select kernels' launches in the block, by kernel: a dict filled
    when the block ends, from the record of the profiling.recording()
    block it runs in (tracing is on inside it, so a timed block inside it
    times the spans' small cost too)."""
    from simd_raytracer_tpu_torch.utils import profiling
    launches = {}
    with profiling.recording() as rec:
        yield launches
    launches.update({k: rec.counts[c] for k, c in LAUNCH_COUNTERS.items()})


def need_launches(what, launches, *kernels) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({launches})")


def torch_source(seed):
    """A uniform source drawing on the card from a generator seeded with
    `seed`: the same seed gives the same estimator."""
    from simd_raytracer_tpu_torch.ops.render import TorchUniforms
    return TorchUniforms.seeded(seed, DEV, torch.float32)


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
    small = small.replace(height=SMALL_CHECK, width=SMALL_CHECK)
    for gi in (1, 2):
        for name, kw in cases.items():
            cfg = T.RenderConfig(diffuse_reflection_ray_count=gi, **kw)
            out[f"gi{gi} {name}"] = render_cpu_vs_cuda(
                f"GI gi={gi} {name}", small, cfg, 20 + gi)
    report("8 GI small render cpu vs cuda", width=SMALL_CHECK,
           height=SMALL_CHECK, triangles=int(small.tri_valid.sum()),
           cases=out)
    cfg = gi_cfg()
    frame = full.replace(height=FRAME, width=FRAME)
    _, launches, frame_s = render_timed("GI frame roulette+sweep gi1", frame,
                                        cfg, accel, frames=1, phase="8")
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
    backward sums terms that cancel (refine's 1/det on grazing hits), so
    last-bit differences of the two devices' forwards move the sums by
    about that error; measured 6.6e-6 on a vertex whose gradient is
    6.3e-3."""
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
    # The launches of one forward pass (the timed steps run untraced).
    with torch.no_grad(), counting() as launches:
        loss1 = float(G.pixel_loss(params, skeleton, cfg, ids, target,
                                   torch_source(0), accel))
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


def refexact_cfg(intersector):
    """bench.py's refexact estimator (split + march, spp 1, depth 5; its
    select is "fast", bench.py:155-158) under `intersector`."""
    import simd_raytracer_tpu_torch as T
    return T.RenderConfig(occlusion_mode="march", intersector=intersector)


def phase_refexact(small, full, accel):
    """Small renders on the CPU and on CUDA under the sweep, brute force
    and fast selects; then the timed 480x480 frame of the full scene under
    the sweep and under fast (bench.py's own select: every select through
    csrc/fast_select.cu, the plain fast version never run on the card),
    each rendered twice, bitwise equal; the fast frame held against the
    brute-force frame of the same configuration by phase 15's PPM rule
    (fast_vs_jnp: fast may flip last-ulp ties on shared edges).  The fast
    wrapper sends CUDA tensors to the kernel only (a failed launch
    raises), so the kernel's launch count shows the frame went through
    it.  The small renders are SMALL_CHECK square: their CPU side is most
    of the phase."""
    out = {}
    small = small.replace(height=SMALL_CHECK, width=SMALL_CHECK)
    for isect in ("sweep", "jnp", "fast"):
        cfg = refexact_cfg(isect)
        out[isect] = render_cpu_vs_cuda(f"refexact {isect}", small, cfg, 30)
    report("12 refexact small render cpu vs cuda", width=SMALL_CHECK,
           height=SMALL_CHECK, triangles=int(small.tri_valid.sum()),
           cases=out)
    frame = full.replace(height=FRAME, width=FRAME)
    cfg = refexact_cfg("sweep")
    _, launches, frame_s = render_timed("refexact frame split+march+sweep",
                                        frame, cfg, accel, frames=1,
                                        phase="12")
    need_launches("refexact frame (sweep)", launches, SWEEP)

    fcfg = refexact_cfg("fast")
    fimg, fast_launches, fast_s = render_timed(
        "refexact frame split+march+fast", frame, fcfg, None, frames=1,
        phase="12")
    need_launches("refexact frame (fast)", fast_launches, FAST)
    jimg, _, jnp_s = render_timed("refexact frame split+march+jnp", frame,
                                  refexact_cfg("jnp"), None, frames=1,
                                  phase="12")
    report("12 refexact frame fast vs jnp", width=FRAME, height=FRAME,
           fast_frame_s=fast_s, jnp_frame_s=jnp_s, sweep_frame_s=frame_s,
           fast_launches=fast_launches[FAST],
           vs_jnp=fast_vs_jnp(frame, fcfg, fimg, jimg))
    for k in launches:
        launches[k] += fast_launches[k]
    return launches, {
        "refexact frame (sweep)": (frame_run(frame, cfg, accel), frame_s,
                                   True),
        "refexact frame (fast)": (frame_run(frame, fcfg, None), fast_s,
                                  False)}


def fast_vs_jnp(frame, cfg, got, ref):
    """Hold the fast frame against the brute-force (jnp) frame of the same
    configuration.  fast may flip a winner where two triangles tie to the
    last ulp, or hit a shared edge that the classic formulation's rounding
    leaves open (or the reverse), and such a pixel may change colour
    wholly: every pixel with a PPM channel off by more than 1 must be
    explained on its pixel-centre primary ray (spp 1) through the fast
    kernel and K1, either by two different winners whose refined t agree
    within 1e-6 * t, or by one side's winner whose ray meets it on an edge
    (its smallest barycentric within 1e-5); the plain fast version on the
    card, a second witness of the estimator, must pick the kernel's
    winner on that ray; and there may be at most FAST_FLIPS such pixels.
    The other pixels keep phase 15's PPM rule (max |d| reported, not
    bounded)."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.models.camera import primary_rays
    from simd_raytracer_tpu_torch.ops import intersect_fast as F
    from simd_raytracer_tpu_torch.ops.intersect import mt_refine
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    from simd_raytracer_tpu_torch.utils.ppm import image_to_u8
    got, ref = got.cpu(), ref.cpu()
    big = (np.abs(image_to_u8(got).astype(int)
                  - image_to_u8(ref).astype(int)) > 1).any(axis=-1)
    ys, xs = np.nonzero(big)
    flips = []
    if len(ys):
        geom = T.derive_geometry(frame)
        px = torch.from_numpy(xs).to(DEV)
        py = torch.from_numpy(ys).to(DEV)
        half = torch.full(px.shape, 0.5, device=DEV)
        o, d = primary_rays(frame, cfg.fov_degrees, px, py, half, half)
        args = (o, d, geom.v0, geom.e1, geom.e2, EPS, True, geom.tri_valid)
        sides = {"fast": F.mt_select_fast(
                     *args, table=bound_table("fast", geom)),
                 "jnp": mt_select_brute(
                     *args, tri_soa=bound_table("jnp", geom))}
        plain = F.mt_select_fast_reference(
            *args, table=bound_table("fast", geom))
        refined = {}
        for name, (idx, _) in sides.items():
            g = idx.long()
            t, u, v = mt_refine(o, d, geom.v0[g], geom.e1[g], geom.e2[g], EPS)
            refined[name] = (t, torch.minimum(torch.minimum(u, v),
                                              1.0 - u - v))
        for i, (y, x) in enumerate(zip(ys.tolist(), xs.tolist())):
            row = {"pixel": [x, y]}
            for name, (idx, hit) in sides.items():
                row[name] = dict(idx=int(idx[i]), hit=bool(hit[i]),
                                 t=float(refined[name][0][i]),
                                 min_barycentric=float(refined[name][1][i]))
            f, j = row["fast"], row["jnp"]
            row["plain_fast_agrees"] = (bool(plain[1][i]) == f["hit"] and (
                not f["hit"] or int(plain[0][i]) == f["idx"]))
            if f["hit"] and j["hit"] and f["idx"] != j["idx"]:
                row["why"] = "near tie"
                row["explained"] = abs(f["t"] - j["t"]) <= 1e-6 * abs(j["t"])
            elif f["hit"] != j["hit"]:
                row["why"] = "edge"
                side = f if f["hit"] else j
                row["explained"] = abs(side["min_barycentric"]) <= 1e-5
            else:
                row["why"] = "same primary winner"
                row["explained"] = False
            flips.append(row)
    keep = torch.from_numpy(~big)
    out = vs_brute_force("refexact frame (fast) outside its flips",
                         got[keep], ref[keep], max_abs=None)
    out.update(max_abs_err_all=float((got - ref).abs().max()),
               pixels_differing_all=int((got != ref).any(dim=-1).sum()),
               flips=flips)
    if not (all(r["explained"] and r["plain_fast_agrees"] for r in flips)
            and len(flips) <= FAST_FLIPS):
        raise AssertionError(f"refexact frame (fast) vs jnp: {out}")
    return out


def fast_stage_pairs(args, hit) -> list:
    """The pairs of one fast call that reach each test of FAST_STAGE_OPS,
    from the call's table and the plain version's numerators
    (ops/intersect_fast.py::numerators: the kernel's bits decide each
    test).  Every ray meets every unmasked triangle, but an any-hit ray
    that hits needs one pair, through every test up to the accept."""
    from simd_raytracer_tpu_torch.models.scene import cross3
    from simd_raytracer_tpu_torch.ops import intersect_fast as F
    tab, eps, cull = args["table"], args["eps"], args["cull"]
    windowed, any_hit = args["t_max"] is not None, args["any_hit"]
    rays = ~hit if any_hit else torch.ones_like(hit)
    o = args["o"].float()[rays] - tab.center[None, :]
    d = args["d"].float()[rays]
    c = cross3(o, d)
    tm = args["t_max"].float()[rays][:, None] if windowed else None
    mask = args["tri_mask"]
    n = torch.zeros(6, dtype=torch.int64, device=o.device)
    step = max(16, (1 << 25) // max(o.shape[0], 1))
    for s in range(0, tab.soa.shape[1], step):
        det, t_num, u_num, v_num = F.numerators(o, d, c,
                                                tab.soa[:, s:s + step])
        sgn = torch.where(det >= 0.0, 1.0, -1.0)
        adet = det * sgn
        us, vs, ts = u_num * sgn, v_num * sgn, t_num * sgn
        reach = torch.ones_like(det, dtype=torch.bool)
        if mask is not None:
            reach = reach & mask[None, s:s + step].bool()
        reached = [reach]
        for test in ((det > eps) if cull else (adet > eps),
                     (us >= 0.0) & (us <= adet),
                     (vs >= 0.0) & (us + vs <= adet),
                     ts > eps * adet,
                     (ts <= tm * adet) if windowed else True):
            reach = reach & test
            reached.append(reach)
        n += torch.stack([x.sum() for x in reached])
    n = n.tolist()
    if not windowed:
        n[4] = 0                # no window test
    if any_hit:
        n[5] = 0                # no division; a hit ends the ray
        hits = int(hit.sum())
        n = [k + hits for k in n[:4]] + [n[4] + hits * windowed, 0]
    return n


def fast_args(a, geom) -> dict:
    """mt_select_fast's arguments for a captured call, reading the frame's
    table (bound_table)."""
    from simd_raytracer_tpu_torch.ops import intersect_fast as F
    return dict(o=a["o"], d=a["d"], v0=geom.v0, e1=geom.e1, e2=geom.e2,
                eps=a["eps"], cull=a["cull"], tri_mask=a["tri_mask"],
                t_max=a["t_max"], any_hit=a["any_hit"],
                table=bound_table("fast", geom))


def fast_call(label, kind, a, geom):
    """Hold the fast kernel on one call exactly against its plain version
    on the same CUDA tensors, both reading the frame's table (bound_table);
    time both and K1 on the same call (the kernel also by the profiler,
    without its wrapper's host work: kernel_ms).  Bound: the operations
    the call's pairs need, each pair charged FAST_STAGE_OPS for the tests
    it reaches (fast_stage_pairs), over 67 TFLOP/s, or the bytes the call
    must move."""
    from simd_raytracer_tpu_torch import kernels
    from simd_raytracer_tpu_torch.ops import intersect_fast as F
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    args = fast_args(a, geom)
    got = F.mt_select_fast(**args)
    exact(FAST, label, got, F.mt_select_fast_reference(**args))
    r, t = args["o"].shape[0], geom.v0.shape[0]
    live = t if args["tri_mask"] is None else int(args["tri_mask"].sum())
    hits = int(got[1].sum())
    stages = fast_stage_pairs(args, got[1])
    ops = sum(k * n for k, n in zip(FAST_STAGE_OPS, stages))
    ms, plain_ms, runs = time_call(lambda: F.mt_select_fast(**args),
                                   lambda: F.mt_select_fast_reference(**args),
                                   5)
    own_ms, seen = kernel_ms(lambda: F.mt_select_fast(**args),
                             "fast_select_kernel", 5)
    k1 = {k: v for k, v in args.items() if k != "table"}
    k1_ms = event_ms(lambda: mt_select_brute(
        **k1, tri_soa=bound_table("jnp", geom)), 5)
    # o, d and t_max in, idx and hit out: 33 bytes a ray; the table's 16
    # constants and the mask's byte: 65 bytes a triangle.
    b_ms, by = bound(ops, 33 * r + 65 * t, 1)
    return dict(kind=kind, rays=r, hits=hits, triangles=t,
                live_triangles=live, width=F.FAST_WIDTH,
                split=kernels.split(
                    -(-r // (F.FAST_THREADS * F.FAST_WIDTH)),
                    -(-t // F.FAST_TILE),
                    torch.cuda.get_device_properties(0).multi_processor_count),
                ms=ms, runs_ms=runs, kernel_ms=own_ms,
                kernel_launches_profiled=seen, plain_ms=plain_ms,
                pairs_reaching_each_test=stages, operations=ops,
                operations_per_pair=ops / max(stages[0], 1),
                bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms,
                k1_ms_same_call=k1_ms, exact=True)


# Phase 18's calls: kind of call -> (name in the result, label).
FAST_CALLS = {"primary": ("fast primary chunk (refexact frame)",
                          "fast primary chunk"),
              "march": ("fast march call (refexact frame)", "fast march"),
              "shadow": ("fast shadow (refexact frame)", "fast shadow"),
              "glass probe": ("fast glass probe (refexact frame)",
                              "fast glass probe")}


def fast_calls(full):
    """The calls of a 480x480 refexact frame (split + march + fast) of the
    full scene that phase 18 times -> (geometry, glass triangles, {kind:
    captured arguments}): the largest closest-hit march call (a t_max
    window), the largest any-hit shadow call over the solid triangles, the
    largest any-hit probe over the glass ones, and its middle 16,384-ray
    primary chunk (linear order: the image's middle rows, which hit the
    scene)."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops import intersect_fast
    from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
    frame = full.replace(height=FRAME, width=FRAME)
    cfg = refexact_cfg("fast")
    geom = T.derive_geometry(frame)
    n_glass = int((geom.tri_valid & geom.tri_transmissive).sum())

    def kind_of(a):
        if a["any_hit"]:
            # The march's two probes (ops/shade.py::occluded) share their
            # rays; the mask's live count tells the glass one.
            glass = int(a["tri_mask"].sum()) == n_glass
            return ("glass probe" if glass else "shadow"), a["o"].shape[0]
        return ("march" if a["t_max"] is not None
                else ray_kind(False, a["cull"])), a["o"].shape[0]

    kept = capture(frame_run(frame, cfg, None), intersect_fast,
                   "mt_select_fast", kind_of)
    chunk = make_ray_chunks(frame, cfg).shape[0] // 2
    o, d = camera_rays(frame, cfg, chunk)
    kept["primary"] = dict(o=o, d=d, eps=EPS, cull=True,
                           tri_mask=geom.tri_valid, t_max=None,
                           any_hit=False)
    return geom, n_glass, kept


def phase_fast(full):
    """The fast kernel at full width on fast_calls' calls, each exact
    against the plain version, timed beside K1 with its bound."""
    geom, n_glass, kept = fast_calls(full)
    calls = {name: fast_call(label, kind, kept[kind], geom)
             for kind, (name, label) in FAST_CALLS.items()}
    torch.cuda.synchronize()
    if (calls["fast primary chunk (refexact frame)"]["hits"]
            < kept["primary"]["o"].shape[0] // 2):
        raise AssertionError("the fast primary chunk misses the scene")
    if calls["fast glass probe (refexact frame)"]["live_triangles"] != n_glass:
        raise AssertionError("the glass probe was not captured")
    report("18 fast kernel on the refexact calls",
           triangles=int(geom.tri_valid.sum()), glass_triangles=n_glass,
           calls_seen={k: int(v["o"].shape[0]) for k, v in kept.items()},
           ops_per_test=FAST_STAGE_OPS, calls=calls, exact=True)
    return calls


def jax_bar(what, a, b) -> dict:
    """JAX's bar for mxu renders (tests/test_bounce_modes.py:109-123):
    |a - b| <= 2e-3 * max(1, |a|) on more than 99% of values."""
    a, b = a.cpu(), b.cpu()
    within = float(((a - b).abs() <= 2e-3 * a.abs().clamp_min(1.0))
                   .float().mean())
    out = dict(max_abs_err=float((a - b).abs().max()),
               share_within_bar=within)
    if not (bool(torch.isfinite(b).all()) and within > 0.99):
        raise AssertionError(f"{what}: {out}")
    return out


def phase_mxu(small, full):
    """The mxu select on the card: a small render on the CPU and on CUDA
    (JAX's bar); the refexact frame's middle primary chunk, timed beside
    the products alone (torch.matmul over the same blocks: the "library"
    time) and K1, its winners held against K1's by JAX's select bar; one
    timed FRAME x FRAME frame of the full scene (the default
    configuration: split, spp 1, depth 5), rendered twice (bitwise equal)
    and held against the brute-force frame by JAX's render bar."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops import intersect_mxu as M
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    from simd_raytracer_tpu_torch.ops.render import make_ray_chunks
    from torch_scenes import SeededUniforms
    t0 = time.perf_counter()
    cfg = T.RenderConfig(max_ray_depth=3, samples_per_pixel=4,
                         intersector="mxu")
    scene = small.replace(height=48, width=48)
    imgs = {dev: T.render_frame(scene, cfg, device=dev,
                                uniforms=lambda c: SeededUniforms(40, c))
            for dev in ("cpu", DEV)}
    small_vs = jax_bar("mxu small render cuda vs cpu", imgs["cpu"], imgs[DEV])
    small_s = time.perf_counter() - t0

    frame = full.replace(height=FRAME, width=FRAME)
    geom = T.derive_geometry(frame)
    chunk = make_ray_chunks(frame, refexact_cfg("mxu")).shape[0] // 2
    o, d = camera_rays(frame, refexact_cfg("mxu"), chunk)
    args = (o, d, geom.v0, geom.e1, geom.e2, EPS, True, geom.tri_valid)
    idx, hit = M.mt_select_mxu(*args)
    k1_idx, k1_hit = mt_select_brute(*args,
                                     tri_soa=bound_table("jnp", geom))
    agree = float((hit == k1_hit).float().mean())
    both = hit & k1_hit
    idx_agree = float((idx[both] == k1_idx[both]).float().mean())
    if not (agree > 0.999 and idx_agree > 0.999 and int(hit.sum()) > 0):
        raise AssertionError(f"mxu chunk vs K1: hit flags agree on {agree}, "
                             f"winners on {idx_agree}")
    r, t = o.shape[0], geom.v0.shape[0]
    rb = min(M.RAY_BLOCK, r)
    tb = M.tri_block(rb)
    feats = M.ray_features(o, d)
    w = M.tri_weights(geom.v0, geom.e1, geom.e2)
    blocks = [w[:, s:s + tb].reshape(-1, 10).T for s in range(0, t, tb)]

    def products():
        with M.full_f32_matmul():
            for rs in range(0, r, rb):
                for wb in blocks:
                    torch.matmul(feats[rs:rs + rb], wb)

    ms = event_ms(lambda: M.mt_select_mxu(*args), 2)
    matmul_ms = event_ms(products, 2)
    k1_ms = event_ms(lambda: mt_select_brute(
        *args, tri_soa=bound_table("jnp", geom)), 5)
    # The products: 4 numerators x 10 multiply-adds a pair (80 float
    # operations), features and weights read once, the (R, 4T) float32
    # numerators written once.  The select's bound counts those operations
    # alone (its epilogue's not counted), the numerators kept on chip.
    mm_bound_ms, mm_by = bound(r * t, 40 * (r + 4 * t) + 16 * r * t, 80)
    chunk_call = dict(rays=r, triangles=t, hits=int(hit.sum()),
                      ray_block=rb, tri_block=tb,
                      products=-(-r // rb) * len(blocks), ms=ms,
                      bound_ms=bound(r * t, 0, 80)[0],
                      matmul_ms=matmul_ms, matmul_bound_ms=mm_bound_ms,
                      matmul_bound_by=mm_by, k1_ms_same_call=k1_ms,
                      hit_flags_agree_with_k1=agree,
                      winners_agree_with_k1=idx_agree)

    mframe = full.replace(height=FRAME, width=FRAME)
    img, _, frame_s = render_timed("mxu frame split", mframe,
                                   T.RenderConfig(intersector="mxu"), None,
                                   frames=1, phase="19")
    ref = T.render_frame(mframe, T.RenderConfig(), device=DEV)
    report("19 mxu select", small_render=dict(
               width=48, height=48, spp=4, depth=3,
               triangles=int(small.tri_valid.sum()), seconds=small_s,
               **small_vs),
           chunk_call=chunk_call,
           frame=dict(width=FRAME, height=FRAME, spp=1, depth=5,
                      frame_s=frame_s,
                      vs_jnp=jax_bar("mxu frame vs jnp", ref, img)))


def kd_args(a, tree):
    return (a["o"], a["d"], a["v0"], a["e1"], a["e2"], a["eps"], a["cull"],
            a["tri_mask"], tree)


def kd_call(label, a, tree, pack):
    """Hold the kd kernel on one call exactly against its plain version
    (accel/traverse.py::kd_select on the same CUDA tensors); time both,
    the kernel with the frame's pack bound as the render path binds it;
    bound: the live leaf lanes the walk tests (kd_work_pairs) x 54 float
    operations over 67 TFLOP/s, or the bytes it must move.  The kernel's
    counter gives the triangles its blocks staged, the pair slots their
    leaf rounds ran and the pair tests run (which must equal the walk's
    pairs)."""
    from simd_raytracer_tpu_torch.accel.traverse import (kd_select,
                                                         kd_work_pairs)
    from simd_raytracer_tpu_torch.ops import intersect_kd as KDM
    args = kd_args(a, tree)
    counter = torch.zeros(3, dtype=torch.int64, device=DEV)
    got = KDM.kd_select_cuda(*args, pack, counter=counter)
    exact(KD, label, got, kd_select(*args))
    pairs = kd_work_pairs(*args)
    staged, slots, tested = counter.tolist()
    if tested != pairs:
        raise AssertionError(f"{label}: the kernel ran {tested} pair tests, "
                             f"the walk needs {pairs}")
    ms, plain_ms, runs = time_call(
        lambda: KDM.kd_select_cuda(*args, pack),
        lambda: kd_select(*args), 10)
    r, t = a["o"].shape[0], a["v0"].shape[0]
    # o, d in and idx, hit out: 29 bytes a ray; the mask: 4 bytes a
    # triangle; the pack: node records, 40 bytes and an id per packed
    # triangle, leaf offsets and lengths.
    n_bytes = 29 * r + 4 * t + nbytes(pack.box, pack.link, pack.tri,
                                      pack.ids, pack.leaf_tile, pack.leaf_len)
    b_ms, by = bound(pairs, n_bytes)
    return dict(kind=ray_kind(a.get("any_hit", False), a["cull"]), rays=r,
                hits=int(got[1].sum()), ms=ms, runs_ms=runs,
                plain_ms=plain_ms, pairs_needed=pairs,
                pairs_per_ray=pairs / max(r, 1), bound_ms=b_ms, bound_by=by,
                share_of_bound=b_ms / ms, triangles_staged=staged,
                pair_slots_run=slots, pairs_run_over_needed=slots / pairs,
                rays_per_block=KDM.KD_SHAPE[0],
                lanes_per_ray=KDM.KD_SHAPE[1], nodes=tree.num_nodes,
                exact=True)


def kd_shapes(calls, tree, pack):
    """With --kd-shapes only: every instantiated (rays per block, lanes
    per ray) shape of the kd kernel on each call of phase 14, exact
    against the shape the wrapper launches; ms per call (the measurement
    behind ops/intersect_kd.py::KD_SHAPE, PERF.md)."""
    from simd_raytracer_tpu_torch.ops import intersect_kd as KDM
    ref = {what: KDM.kd_select_cuda(*kd_args(a, tree), pack)
           for what, a in calls.items()}
    keep, out = KDM.KD_SHAPE, {}
    try:
        for shape in KDM.KD_SHAPES + KDM.KD_SHAPES[::-1]:
            KDM.KD_SHAPE = shape
            row = out.setdefault(f"{shape[0]}x{shape[1]}", {})
            for what, a in calls.items():
                args = kd_args(a, tree)
                exact(KD, f"kd shape {shape} {what}",
                      KDM.kd_select_cuda(*args, pack), ref[what])
                row.setdefault(what, []).append(event_ms(
                    lambda: KDM.kd_select_cuda(*args, pack), 5))
    finally:
        KDM.KD_SHAPE = keep
    return out


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
    from simd_raytracer_tpu_torch.ops import intersect_kd as KDM
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    from simd_raytracer_tpu_torch.ops.intersect_kd import (kd_select_cuda,
                                                           pack_kd)
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
        scheduling=SchedulingType.BUCKET_TILES), KDM, "kd_window_select",
        kind_of)
    # The same chunk with its rays in a seeded random order: the worst
    # case for a block's rays sharing leaves.
    perm = torch.from_numpy(np.random.default_rng(14).permutation(len(o))
                            ).to(DEV)
    shuffled = dict(primary, o=o[perm].contiguous(), d=d[perm].contiguous())
    inputs = {"kd primary chunk (kd frame)": primary,
              "kd primary chunk shuffled (kd frame)": shuffled,
              "kd shadow (480x480 kd frame)": kept["shadow"]}
    pack = pack_kd(tree, geom.v0, geom.e1, geom.e2)
    pack_ms = event_ms(lambda: pack_kd(tree, geom.v0, geom.e1, geom.e2), 5)
    calls = {what: kd_call(what, a, tree, pack) for what, a in inputs.items()}
    # K1 on the same calls, for comparison.
    for what, a in inputs.items():
        calls[what]["k1_ms_same_call"] = event_ms(lambda: mt_select_brute(
            a["o"], a["d"], a["v0"], a["e1"], a["e2"], EPS, a["cull"],
            a["tri_mask"], a.get("t_max"), a.get("any_hit", False),
            tri_soa=bound_table("jnp", geom)), 5)
    more = {}
    if "--kd-shapes" in sys.argv[1:]:
        more["shape_ms"] = kd_shapes(inputs, tree, pack)
    # The depth-14 tree of the same scene (5,735 nodes, 229 KB of node
    # records): the primary chunk and its own 480x480 frame's largest
    # shadow call.
    deep = build_kdtree_for_scene(host, max_depth=14).to(DEV)
    print(f"depth-14 kd-tree: {deep.num_nodes} nodes", flush=True)
    deep_shadow = capture(lambda: T.render_frame(
        frame, kd_config(), device=DEV, accel=deep,
        scheduling=SchedulingType.BUCKET_TILES), KDM, "kd_window_select",
        kind_of)["shadow"]
    deep_pack = pack_kd(deep, geom.v0, geom.e1, geom.e2)
    for what, a in (("kd primary chunk (kd frame), depth-14 tree", primary),
                    ("kd shadow (480x480 kd frame), depth-14 tree",
                     deep_shadow)):
        calls[what] = kd_call(what, a, deep, deep_pack)

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
           leaf_max=int(leaf_lens.max()), packed_tiles=pack.ids.shape[0],
           pack_bytes=nbytes(pack.box, pack.link, pack.tri, pack.ids,
                             pack.leaf_tile, pack.leaf_len),
           pack_ms=pack_ms, calls=calls, random_rays=len(o),
           hits_vs_k1=vs_k1, kdleaf_slices=sweep.num_slices,
           deep_tree=dict(nodes=deep.num_nodes, depth=deep.depth,
                          leaves=int((deep.leaf_id >= 0).sum()),
                          packed_tiles=deep_pack.ids.shape[0]),
           exact=True, **more)
    return calls


def vs_brute_force(what, got, ref, max_abs=1e-4):
    """Hold a frame (or a set of its pixels) against the brute-force
    frame: max |d| at most max_abs (None: reported only), PPM channels off
    by at most 1 on at most 0.1% -> the differences."""
    from simd_raytracer_tpu_torch.utils.ppm import image_to_u8
    got, ref = got.cpu(), ref.cpu()
    err = float((got - ref).abs().max())
    ua, ub = image_to_u8(ref).astype(int), image_to_u8(got).astype(int)
    off = int((ua != ub).sum())
    out = dict(max_abs_err=err,
               pixels_differing=int((got != ref).any(dim=-1).sum()),
               ppm_channels_differing=off,
               ppm_max_channel_diff=int(np.abs(ua - ub).max()))
    if not (bool(torch.isfinite(got).all())
            and (max_abs is None or err <= max_abs)
            and out["ppm_max_channel_diff"] <= 1 and off <= 0.001 * ua.size):
        raise AssertionError(f"{what} differs from the brute-force frame: "
                             f"{out}")
    return out


def phase_refbin(tmp):
    """The reference binary's path at full width: parse the file, build
    the kd-tree, render in bucket tiles through the kd kernel, save the
    PPM; held against the brute-force frame (K1, linear order) and
    profiled as phase 7.  Then a 480x480 frame on the depth-14 tree (5,735
    nodes), held against brute force too."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.accel.build import build_kdtree_for_scene
    from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
    from simd_raytracer_tpu_torch.utils.ppm import read_ppm
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

    times, imgs = [], []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # The launches of the warm frame; the timed one runs untraced.
        with counting() if i == 0 else contextlib.nullcontext() as seen:
            imgs.append(run())
        if i == 0:
            launches = seen
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    need_launches("kd frame", launches, KD)
    img = imgs[1]
    if not torch.equal(imgs[0], img):
        raise AssertionError("kd frame: two CUDA renders differ")
    out = os.path.join(tmp, "refbin.ppm")
    with timer.phase("save_ppm"):
        T.save_ppm(img, out)
    if read_ppm(out).shape != (REFBIN, REFBIN, 3):
        raise AssertionError("kd frame PPM has the wrong shape")

    fields = dict(width=REFBIN, height=REFBIN, spp=1, depth=5,
                  bucket=scene.bucket_size, warm_s=times[0], frame_s=times[1],
                  bitwise_equal_frames=2,
                  primary_rays_per_s=REFBIN * REFBIN / times[1],
                  phases_s=dict(timer.seconds), launches=dict(launches))
    ref = T.render_frame(scene, T.RenderConfig(max_ray_depth=5), device=DEV)
    fields["vs_brute_force"] = vs_brute_force("kd frame", img, ref)
    wall, busy, n_events, top, by_name = device_profile(run)
    kd_s = sum(t for k, t in by_name.items() if "kd_select" in k)
    fields.update(profiled_wall_s=wall, device_busy_s=busy,
                  device_events=n_events,
                  busy_share_of_profiled_frame=busy / wall,
                  busy_share_of_unprofiled_frame=busy / times[1],
                  kd_kernel_s=kd_s, kd_share_of_busy=kd_s / busy,
                  top_device=top)

    small = scene.replace(height=FRAME, width=FRAME)
    deep = build_kdtree_for_scene(scene, max_depth=14)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting() as deep_launches:
        deep_img = T.render_frame(small, cfg, device=DEV, accel=deep,
                                  scheduling=sched)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    need_launches("depth-14 kd frame", deep_launches, KD)
    for k in launches:
        launches[k] += deep_launches[k]
    fields["depth14_frame"] = dict(
        width=FRAME, height=FRAME, nodes=deep.num_nodes, depth=deep.depth,
        frame_s=deep_s, launches=deep_launches,
        vs_brute_force=vs_brute_force(
            "depth-14 kd frame", deep_img,
            T.render_frame(small, T.RenderConfig(max_ray_depth=5),
                           device=DEV)))
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
    with counting() as launches:
        resumed = render_progressive(full, cfg, 8, 4, checkpoint_path=ck,
                                     on_batch=lambda n, _i: seen.append(n),
                                     accel=accel, device=DEV)
    # Batch b is seeded from (seed, b) alone and the fold-back adds in a
    # fixed order, so the resumed render is bitwise the whole one.
    diff = float(np.abs(resumed - whole).max())
    rel = diff / float(np.abs(whole).max())
    if not (seen == [8] and np.isfinite(resumed).all()
            and np.array_equal(resumed, whole)):
        raise AssertionError(f"resumed render: batches {seen}, max |d| "
                             f"{diff} ({rel} relative)")
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


def phase_sharded(full, accel, headline_s):
    """parallel/sharding.py over an NCCL world of one (NCCL takes one rank
    per card): the headline frame sharded, bitwise equal to render_frame
    with the same per-chunk sources; one sharded SGD step on phase 10's
    65,536 ray ids, bitwise equal to train_step with the same source (an
    all-reduce over one rank is the identity); the port's dry run in the
    same group."""
    import torch.distributed as dist
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.graft_entry import (dryrun_multichip,
                                                      free_port)
    from simd_raytracer_tpu_torch.ops import grad as G
    from simd_raytracer_tpu_torch.parallel import sharding as S
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    S.init_distributed(DEV, world_size=1, rank=0)
    try:
        mesh = S.make_mesh(device=DEV)
        cfg = T.RenderConfig(samples_per_pixel=4, max_ray_depth=5,
                             bounce_mode="roulette", intersector="sweep")
        # Sharded and single-process frames in turns, each timed; only the
        # sharded frames' launches are counted.
        sources = S.chunk_uniforms(cfg, DEV, torch.float32)
        launches = dict.fromkeys(KERNELS, 0)
        times, ref_times = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting() as seen:
                img = S.render_frame_sharded(full, cfg, mesh, accel=accel)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, v in seen.items():
                launches[k] += v
            t0 = time.perf_counter()
            ref = T.render_frame(full, cfg, device=DEV, accel=accel,
                                 uniforms=sources)
            torch.cuda.synchronize()
            ref_times.append(time.perf_counter() - t0)
            if not (img.shape == ref.shape and torch.equal(img, ref)):
                raise AssertionError(
                    f"sharded frame differs from render_frame: max |d| "
                    f"{float((img - ref).abs().max())}")

        tcfg = T.RenderConfig(samples_per_pixel=4, max_ray_depth=5,
                              chunk_size=TRAIN_RAYS, bounce_mode="roulette",
                              intersector="sweep")
        ids = interior_ids(full, tcfg, TRAIN_RAYS)
        target = torch.zeros((len(ids), 3), device=DEV)
        params, skeleton = G.split_params(full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting() as seen:
            new, loss = S.train_step_sharded(
                params, skeleton, tcfg, mesh, ids[None], target[None],
                torch.tensor([[7]]), accel=accel)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        for k, v in seen.items():
            launches[k] += v
        ref_new, ref_loss = G.train_step(params, skeleton, tcfg, ids, target,
                                         torch_source(7), accel=accel)
        moved = [k for k in new if not torch.equal(new[k], ref_new[k])]
        if not (torch.isfinite(loss) and torch.equal(loss, ref_loss)
                and not moved):
            raise AssertionError(f"sharded step differs from train_step: "
                                 f"loss {float(loss)} vs {float(ref_loss)}, "
                                 f"params {moved}")

        t0 = time.perf_counter()
        with counting() as seen:
            dryrun_multichip(1, device=DEV)
        dryrun_s = time.perf_counter() - t0
        for k, v in seen.items():
            launches[k] += v
        need_launches("sharded paths", launches, SWEEP, K1)
        report("17 sharded (NCCL world of one)", world_size=mesh.size,
               backend=dist.get_backend(), width=full.width,
               height=full.height, spp=4, depth=5, frame_s=times,
               render_frame_same_sources_s=ref_times,
               headline_frame_s_phase5=headline_s,
               bitwise_equal_to_render_frame=True, step_rays=len(ids),
               step_s=step_s, step_loss=float(loss),
               bitwise_equal_to_train_step=True, dryrun_s=dryrun_s,
               launches=launches)
    finally:
        dist.destroy_process_group()
    return launches


def gather_call(label, n_rows, idx, width, seed):
    """row_sums on one gather's shapes: exact against the plain version and
    against itself, timed whole and by pass, beside its bound, the plain
    version and index_put_(accumulate=True)."""
    from simd_raytracer_tpu_torch.ops.gather import (row_sums,
                                                     row_sums_reference)
    g = torch.Generator(device=DEV).manual_seed(seed)
    vals = torch.randn((len(idx), width), device=DEV, generator=g)
    idx = torch.as_tensor(idx, device=DEV)
    got = row_sums(idx, vals, n_rows)
    plain = row_sums_reference(idx, vals, n_rows)
    again = row_sums(idx, vals, n_rows)
    err = float((got - plain).abs().max())
    MAX_ERR[GATHER] = max(MAX_ERR[GATHER], err)
    if not (torch.equal(got, plain) and torch.equal(got, again)):
        raise AssertionError(f"{label}: gather_grad max |d| {err} against "
                             f"its plain version, equal to itself run "
                             f"again: {torch.equal(got, again)}")

    def library():
        return torch.zeros((n_rows, width), device=DEV).index_put_(
            (idx,), vals, accumulate=True)

    lib_err = float((got - library()).abs().max())
    n_bytes = nbytes(vals, idx) + n_rows * width * 4
    ms = event_ms(lambda: row_sums(idx, vals, n_rows), 50)
    pass1, _ = kernel_ms(lambda: row_sums(idx, vals, n_rows),
                         "piece_sums_kernel", 20)
    pass2, _ = kernel_ms(lambda: row_sums(idx, vals, n_rows),
                         "row_sums_kernel", 20)
    bound_ms, bound_by = bound(0, n_bytes)
    return {"entries": len(idx), "rows": n_rows, "width": width,
            "largest_run": int(torch.bincount(idx).max()),
            "ms": ms, "pass1_ms": pass1, "pass2_ms": pass2,
            "sort_ms": event_ms(lambda: torch.sort(idx, stable=True), 50),
            "plain_ms": event_ms(
                lambda: row_sums_reference(idx, vals, n_rows), 5),
            "library_ms": event_ms(library, 10),
            "library_max_abs_diff": lib_err,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}


def phase_gather(full, accel):
    """The gathers' backward at the train step's shapes, then in the train
    path (phase 10's step with one diffuse ray): two loss_and_grad calls
    of one source bitwise equal, the kernel launched twice a call."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops import grad as G
    rng = np.random.default_rng(20)
    calls = {}
    for width in (3, 6, 9):
        idx = rng.integers(0, GATHER_ROWS, TRAIN_RAYS)
        idx[rng.random(TRAIN_RAYS) < 0.5] = 0
        calls[f"{GATHER_ROWS} rows, width {width}"] = gather_call(
            f"width {width}", GATHER_ROWS, idx, width, seed=width)
    calls[f"one row of {TRAIN_RAYS:,}"] = gather_call(
        "one row", 1, np.zeros(TRAIN_RAYS, np.int64), 3, seed=1)

    cfg = T.RenderConfig(samples_per_pixel=4, max_ray_depth=5,
                         chunk_size=TRAIN_RAYS, diffuse_reflection_ray_count=1,
                         bounce_mode="roulette", intersector="sweep")
    ids = interior_ids(full, cfg, TRAIN_RAYS)
    target = torch.zeros((len(ids), 3), device=DEV)
    params, skeleton = G.split_params(full)
    runs = []
    with counting() as launches:
        for _ in range(2):
            runs.append(G.loss_and_grad(params, skeleton, cfg, ids, target,
                                        torch_source(3), accel))
    need_launches("20 train step", launches, GATHER)
    (l0, g0), (l1, g1) = runs
    differ = [k for k in G.DIFF_PARAM_NAMES if not torch.equal(g0[k], g1[k])]
    if differ or not torch.equal(l0, l1):
        raise AssertionError(f"loss_and_grad is not reproducible: {differ}")
    report("20 gathers' backward", calls=calls, train_launches=launches,
           bitwise_repeat=True)
    return launches, calls


# Phase 21's grad calls: every shade call of one step of the train cell.
TRAIN_SHADE = "train step (hw15_scene2.train)"
# Rows of phase 21's shade calls: a GI split bounce's wavefront (16,384
# primary rays, two slots a bounce, at depth 4) and a kd frame's chunk.
SHADE_ROWS = {"gi": 262144, "kd": 16384}


def shade_cfgs():
    """Phase 21's shading: the GI frame's and the kd frame's."""
    import simd_raytracer_tpu_torch as T
    return {"gi": T.RenderConfig(diffuse_reflection_ray_count=1,
                                 bounce_mode="split", intersector="fast",
                                 occlusion_mode="march"),
            "kd": T.RenderConfig(diffuse_reflection_ray_count=0,
                                 bounce_mode="split", intersector="kdtree",
                                 occlusion_mode="fast")}


def shade_bytes(args, out, need) -> int:
    """What the fused kernels must move at least: every input of the call
    read once (the hit record's fields shading reads, d_in, weight, the
    uniforms, `need`, the texture and light tables) and the contributions,
    children and shadow rays (12 + 12 + 4 bytes a pair) written once."""
    scene, _, hit, d_in, weight, _, _, coin, rnd_gi = args
    n_lights = scene.light_pos.shape[0]
    return (nbytes(hit.mask, hit.mat_tag, hit.position, hit.hit_n,
                   hit.face_n, hit.smooth, hit.ior, hit.albedo, hit.tex,
                   hit.u, hit.v, hit.w, hit.uvs, d_in, weight, coin, rnd_gi,
                   need, scene.tex_tag, scene.tex_color_a, scene.tex_color_b,
                   scene.tex_param, scene.tex_offset, scene.tex_width,
                   scene.tex_height, scene.atlas, scene.light_pos,
                   scene.light_intensity)
            + nbytes(out[0], *out[1]) + 28 * n_lights * need.numel())


def shade_call(label, scene, geom, cfg, accel, n, seed):
    """One shade call over `n` random rows: the fused path against the
    plain version (bitwise), each timed on the host and the device."""
    from simd_raytracer_tpu_torch.ops import shade as S
    from simd_raytracer_tpu_torch.ops.intersect import HitRecord
    from torch_scenes import shade_rows
    gi = cfg.diffuse_reflection_ray_count
    rows = shade_rows(n, seed, int(scene.tex_tag.shape[0]), gi,
                      scene.vertices.min(0).values.cpu().numpy(),
                      scene.vertices.max(0).values.cpu().numpy())
    t = {k: torch.from_numpy(v).to(DEV) for k, v in rows.items()}
    d_in, weight, coin, rnd_gi = (t.pop(k) for k in
                                  ("d_in", "weight", "rnd_coin", "rnd_gi"))
    hit = HitRecord(**t)
    args = (scene, geom, hit, d_in, weight, cfg, accel,
            coin if cfg.bounce_mode == "roulette" else None,
            rnd_gi if gi > 0 else None)
    with counting() as launches:
        got = S.shade(*args)
    need_launches(f"21 {label}", launches, SHADE)
    ref = S.shade_reference(*args)
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        if a.dtype != torch.bool:
            MAX_ERR[SHADE] = max(MAX_ERR[SHADE],
                                 float((a - b).abs().max()) if a.numel()
                                 else 0.0)
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: the shade kernels differ from "
                                 f"the plain version (max |d| "
                                 f"{MAX_ERR[SHADE]})")
    backward = shade_grad_check(label, args)
    launches[SHADE_GRAD] += backward["launches"]
    need = S.need_rows(hit, weight)
    n_bytes = shade_bytes(args, got, need)
    out = {"rows": n, "needed_rows": need.numel(),
           "lights": int(scene.light_pos.shape[0]), "launches": launches,
           "bitwise_equal": True, "bytes": n_bytes}
    for path, fn in (("fused", lambda: S.shade_fused(*args)),
                     ("plain", lambda: S.shade_reference(*args))):
        host, wall = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        _, busy, events, top, by_name = device_profile(fn)
        own = {k: v for k, v in by_name.items() if "select" not in k}
        out[path] = {"host_ms": 1e3 * float(np.median(host)),
                     "ms": 1e3 * float(np.median(wall)),
                     "device_busy_ms": 1e3 * busy, "device_events": events,
                     "device_ms_outside_select": 1e3 * sum(own.values()),
                     "top": top}
    kernels_ms = sum(v for k, v in device_profile(
        lambda: S.shade_fused(*args))[4].items() if "shade_" in k) * 1e3
    # The plain version's own device time, the same scope as the three
    # kernels: its shading from the fused path's own occlusion, so neither
    # the `need` compaction nor the occlusion query is in either.
    occ, _ = S._shadow(scene, geom, hit, cfg, accel, need)
    plain_ms = 1e3 * sum(device_profile(lambda: S.shade_reference(
        *args, lights=(need, occ)))[4].values())
    bound_ms, bound_by = bound(0, n_bytes)
    out.update(kernels_ms=kernels_ms, plain_shading_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / kernels_ms,
               host_ms_saved=(out["plain"]["host_ms"]
                              - out["fused"]["host_ms"]),
               backward=backward)
    return out


def same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def shade_grad_check(label, args, timed=True):
    """The call with every float input requiring grad, as in an SGD step:
    `shade` (the kernels under the autograd node) against the plain
    version, bitwise on the values and, on every input's gradient, within
    the float64 yardstick (tests/yardstick.py: the plain version's
    float64 gradient from the call's own `need` and occlusion); with
    `timed`, then the backward timed beside the plain version's autograd
    backward from the same occlusion -> the backward's fields of phase
    21's line."""
    from simd_raytracer_tpu_torch.ops import shade as S
    from yardstick import gradient_gaps, leaf_grads, shade_grads, shade_loss
    scene, geom, hit, _, weight, cfg, accel, _, _ = args
    need = S.need_rows(hit, weight)
    occ, _ = S._shadow(scene, geom, hit, cfg, accel, need)
    n, k = weight.shape[0], cfg.child_slots
    gen = torch.Generator(device=DEV).manual_seed(21)
    outs = [torch.rand(shape, generator=gen, device=DEV)
            for shape in ((n, 3), (n * k, 3), (n * k, 3), (n * k,))]

    def plain(*a):
        return S.shade_reference(*a, lights=(need, occ))

    with counting() as launches:
        vals, got = shade_grads(S.shade, args, outs)
    if launches[SHADE] == 0 or launches[SHADE_GRAD] == 0:
        raise AssertionError(f"{label}: the grad call launched no kernel "
                             f"({launches})")
    vals_p, plain32 = shade_grads(S.shade_reference, args, outs)
    for a, b in zip(vals, vals_p):
        if not same_bits(a, b):
            raise AssertionError(f"{label}: the autograd node's values "
                                 f"differ from the plain version")
    _, exact = shade_grads(plain, args, outs, torch.float64)
    gaps = gradient_gaps(got, plain32, exact)
    for i, (gap, allowed) in enumerate(gaps):
        if gap > allowed:
            raise AssertionError(f"{label}: gradient {i} off the float64 "
                                 f"yardstick: {gap} > {allowed}")
    gap = max(g for g, _ in gaps)
    share = max(g / a if a else 0.0 for g, a in gaps)
    MAX_ERR[SHADE_GRAD] = max(MAX_ERR[SHADE_GRAD], gap)
    YARDSTICK_SHARE[SHADE_GRAD] = max(YARDSTICK_SHARE[SHADE_GRAD], share)
    out = {"rows": n, "needed_rows": need.numel(),
           "launches": launches[SHADE_GRAD], "values_bitwise_equal": True,
           "max_abs_gap": gap, "yardstick_share": share}
    if not timed:
        return out
    # The two kernels and the segmented sums (two launches a call), each
    # call between CUDA events, over five backward calls.
    reps = 5
    with timed_launches("srt_shade_bounce_grad", "srt_shade_lights_grad",
                        "srt_gather_grad") as ms:
        for _ in range(reps):
            _, loss, leaves = shade_loss(S.shade, args, outs)
            leaf_grads(loss, leaves)
    out.update(
        kernels_ms=sum(sum(ms.get(k, [])) for k in (
            "srt_shade_bounce_grad", "srt_shade_lights_grad")) / reps,
        sums_ms=sum(ms.get("srt_gather_grad", [])) / reps)
    for path, fn in (("kernels", S.shade), ("plain", plain)):
        host, prof = [], None
        for rep in range(6):
            _, loss, leaves = shade_loss(fn, args, outs)
            torch.cuda.synchronize()
            if rep == 5:
                prof = device_profile(lambda: leaf_grads(loss, leaves))
                continue
            t0 = time.perf_counter()
            leaf_grads(loss, leaves)
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        _, busy, events, top, _ = prof
        out[path] = {"host_ms": 1e3 * float(np.median(host)),
                     "device_busy_ms": 1e3 * busy, "device_events": events,
                     "top": top}
    n_bytes = shade_grad_bytes(args, vals, got, need)
    bound_ms, bound_by = bound(0, n_bytes)
    out.update(bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / (out["kernels_ms"]
                                          + out["sums_ms"]),
               host_ms_saved=out["plain"]["host_ms"]
               - out["kernels"]["host_ms"])
    return out


def train_cell(config_name: str, traffic_name: str):
    """One SGD step's set-up of a benchmark train cell
    (perfbench/configs/<config_name>.json under perfbench/traffic/
    <traffic_name>.json) on the card -> (params, skeleton, cfg, ids,
    accel)."""
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch.ops import grad as G
    from simd_raytracer_tpu_torch.ops.render import build_accel
    sys.path.insert(0, os.path.join(ROOT, "perfbench"))
    from pb import scenes
    from pb.program import render_settings
    with open(os.path.join(ROOT, "perfbench/configs",
                           f"{config_name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "perfbench/traffic",
                           f"{traffic_name}.json")) as f:
        traffic = json.load(f)
    scene = T.parse_scene_dict(scenes.scene_doc(config))
    cfg = T.RenderConfig(**render_settings(config, traffic))
    accel = build_accel(scene, cfg)
    accel = None if accel is None else accel.to(DEV)
    scene = scene.to(DEV)
    ids = interior_ids(scene, cfg, int(traffic["rays"]))
    params, skeleton = G.split_params(scene)
    return params, skeleton, cfg, ids, accel


def train_shade_calls():
    """The shade calls of one SGD step of the benchmark's train cell
    (perfbench/configs/hw15_scene2.json under perfbench/traffic/train.json:
    the frozen hw15/scene2 stand-in at 1920x1920, its 65,536 middle ray
    ids at spp 8, depth 5, roulette, one diffuse ray, the brute-force
    select, fast occlusion), each call's arguments as the render loop
    passes them -> [args], one a bounce."""
    from simd_raytracer_tpu_torch.ops import grad as G
    from simd_raytracer_tpu_torch.ops import render
    params, skeleton, cfg, ids, accel = train_cell("hw15_scene2", "train")
    calls, real = [], render.shade

    def keep(scene, geom, hit, d_in, weight, cfg, accel, rnd_coin=None,
             rnd_gi=None):
        def own(t):
            return None if t is None else t.detach().clone()

        calls.append((scene.map(own), geom.map(own), hit.map(own),
                      own(d_in), own(weight), cfg, accel, own(rnd_coin),
                      own(rnd_gi)))
        return real(scene, geom, hit, d_in, weight, cfg, accel,
                    rnd_coin=rnd_coin, rnd_gi=rnd_gi)

    render.shade = keep
    try:
        with torch.no_grad():
            G.pixel_loss(params, skeleton, cfg, ids,
                         torch.zeros((len(ids), 3), device=DEV),
                         torch_source(19), accel)
    finally:
        render.shade = real
    return calls


def shade_grad_bytes(args, vals, got, need) -> int:
    """What the backward must move at least: the call's inputs it reads
    once (the hit record's fields, d_in, weight, the uniforms, `need`, its
    visibility, the factor, the texture and light tables), the incoming
    gradients of contrib and the children once, and every input's
    gradient written once."""
    scene, _, hit, d_in, weight, _, _, coin, rnd_gi = args
    n_lights = scene.light_pos.shape[0]
    return (nbytes(hit.mask, hit.mat_tag, hit.position, hit.hit_n,
                   hit.face_n, hit.smooth, hit.ior, hit.albedo, hit.tex,
                   hit.u, hit.v, hit.w, hit.uvs, d_in, weight, coin, rnd_gi,
                   need, scene.tex_tag, scene.tex_color_a, scene.tex_color_b,
                   scene.tex_param, scene.tex_offset, scene.tex_width,
                   scene.tex_height, scene.atlas, scene.light_pos,
                   scene.light_intensity, *vals[:4], *got)
            + n_lights * need.numel() + 4 * weight.numel())


def phase_shade(full):
    """Phase 21: the fused shading against the plain version on a GI split
    call and a kd call of random rows over the full scene."""
    from simd_raytracer_tpu_torch import derive_geometry
    from simd_raytracer_tpu_torch.ops.render import build_accel
    geom = derive_geometry(full)
    calls, launches = {}, {}
    train = {}
    for depth, args in enumerate(train_shade_calls()):
        train[f"bounce {depth}"] = shade_grad_check(
            f"train bounce {depth}", args, timed=depth == 0)
        launches[SHADE_GRAD] = (launches.get(SHADE_GRAD, 0)
                                + train[f"bounce {depth}"]["launches"])
    calls[TRAIN_SHADE] = train
    for which, cfg in shade_cfgs().items():
        accel = build_accel(full, cfg)
        accel = None if accel is None else accel.to(DEV)
        label = f"{which} {SHADE_ROWS[which]:,} rows"
        calls[label] = shade_call(label, full, geom, cfg, accel,
                                  SHADE_ROWS[which], seed=21)
        for k, v in calls[label]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    report("21 shade", calls=calls)
    return launches, calls


# The benchmark's train cells whose first bounce phase 22 captures: the
# train step's 65,536 rays and the spp-128 step's 1,048,576.
TRACE_CELLS = {"hw15_scene2.train": ("hw15_scene2", "train"),
               "hw15_scene2_spp128.sweep_refit": ("hw15_scene2_spp128",
                                                  "sweep_refit")}


def first_trace_call(config_name: str, traffic_name: str):
    """The record of bounce 0 of one SGD step of a benchmark train cell:
    (o, d, idx, hit, scene, geom, eps) as `trace` passes them to
    ops/intersect.py::record_fused, copied."""
    from simd_raytracer_tpu_torch.ops import grad as G
    from simd_raytracer_tpu_torch.ops import intersect as I
    params, skeleton, cfg, ids, accel = train_cell(config_name, traffic_name)
    calls, real = [], I.record_fused

    def keep(o, d, idx, hit, scene, geom, eps):
        if not calls:
            def own(t):
                return t.detach().clone()

            calls.append((own(o), own(d), own(idx), own(hit),
                          scene.map(own), geom.map(own), eps))
        return real(o, d, idx, hit, scene, geom, eps)

    I.record_fused = keep
    try:
        with torch.no_grad():
            G.pixel_loss(params, skeleton, cfg, ids,
                         torch.zeros((len(ids), 3), device=DEV),
                         torch_source(22), accel)
    finally:
        I.record_fused = real
    return calls[0]


def record_bytes(o, d, idx, hit, scene, geom, record) -> int:
    """What trace_record must move at least: the rays, winners and flags
    and every table it reads once, and the record written once."""
    from simd_raytracer_tpu_torch.ops import intersect as I
    return (nbytes(o, d, idx, hit, *I._grad_tables(scene, geom),
                   geom.tri_mat, geom.tri_mesh, scene.mat_tag,
                   scene.mat_smooth, scene.mat_tex)
            + nbytes(*(getattr(record, k)
                       for k in I._GRAD_FIELDS + I._INT_FIELDS)))


def record_grad_bytes(o, d, idx, hit, geom, outs, grads) -> int:
    """What the record's backward must move at least: the rays, winners,
    flags and the tables it recomputes from read once, the incoming
    gradients read once, and every input's gradient written once."""
    return (nbytes(o, d, idx, hit, geom.v0, geom.e1, geom.e2, geom.vn,
                   geom.tri_mat, *outs) + nbytes(*grads))


def host_ms(fn, reps=5):
    """Median host ms of `fn` until it returns, each call after a
    synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * float(np.median(times))


def trace_record_call(label, o, d, idx, hit, scene, geom, eps):
    """One captured record call: the kernel's record against the plain
    version's (bitwise, every field) and, with o, d and every table
    requiring grad and random incoming gradients on every float field,
    the backward's gradients against the float64 yardstick; then each
    timed (CUDA events around each launch, five calls) beside its byte
    bound, and the host's ms and the device's busy ms and events of the
    whole forward and backward beside the plain version's."""
    from simd_raytracer_tpu_torch.ops import intersect as I
    from yardstick import (RECORD_LEAVES, gradient_gaps, leaf_grads,
                           record_grads, record_loss)
    n = o.shape[0]
    with counting() as launches:
        got = I.record_fused(o, d, idx, hit, scene, geom, eps)
    ref = I.record_reference(o, d, idx, hit, scene, geom, eps)
    for k in I._GRAD_FIELDS + I._INT_FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        if a.dtype == torch.float32:
            MAX_ERR[TRACE] = max(MAX_ERR[TRACE], float((a - b).abs().max()))
        if not same_bits(a, b):
            raise AssertionError(f"{label}: the record's {k} differs from "
                                 f"the plain version's")
    gen = torch.Generator(device=DEV).manual_seed(22)
    outs = [torch.randn(getattr(ref, k).shape, generator=gen, device=DEV)
            for k in I._GRAD_FIELDS]
    args = (scene, geom, o, d, idx, hit, outs)
    with counting() as grad_launches:
        _, grads = record_grads(I.record_fused, *args, eps=eps)
    _, plain = record_grads(I.record_reference, *args, eps=eps)
    _, exact = record_grads(I.record_reference, *args,
                            dtype=torch.float64, eps=eps)
    gaps = gradient_gaps(grads, plain, exact)
    for leaf, (gap, allowed) in zip(RECORD_LEAVES, gaps):
        if gap > allowed:
            raise AssertionError(f"{label}: the gradient of {leaf} is off "
                                 f"the float64 yardstick: {gap} > {allowed}")
    MAX_ERR[TRACE_GRAD] = max(MAX_ERR[TRACE_GRAD],
                              max(g for g, _ in gaps))
    share = max(g / a if a else 0.0 for g, a in gaps)
    YARDSTICK_SHARE[TRACE_GRAD] = max(YARDSTICK_SHARE[TRACE_GRAD], share)
    launches[TRACE_GRAD] = grad_launches[TRACE_GRAD]
    need_launches(f"22 {label}", launches, TRACE, TRACE_GRAD)

    reps = 5
    with timed_launches("srt_trace_record") as fwd:
        for _ in range(reps):
            I.record_fused(o, d, idx, hit, scene, geom, eps)
    with timed_launches("srt_trace_record_grad", "srt_gather_grad") as bwd:
        for _ in range(reps):
            record_grads(I.record_fused, *args, eps=eps)
    fwd_bytes = record_bytes(o, d, idx, hit, scene, geom, got)
    bwd_bytes = record_grad_bytes(o, d, idx, hit, geom, outs, grads)
    out = {"rays": n, "hits": int(hit.sum()), "launches": launches,
           "bitwise_equal": True, "yardstick_share": share,
           "forward": {"kernel_ms": sum(fwd["srt_trace_record"]) / reps,
                       "bytes": fwd_bytes},
           "backward": {
               "kernel_ms": sum(bwd["srt_trace_record_grad"]) / reps,
               "sums_ms": sum(bwd["srt_gather_grad"]) / reps,
               "bytes": bwd_bytes}}
    for part, n_bytes in (("forward", fwd_bytes), ("backward", bwd_bytes)):
        ms = out[part]["kernel_ms"] + out[part].get("sums_ms", 0.0)
        bound_ms, bound_by = bound(0, n_bytes)
        out[part].update(bound_ms=bound_ms, bound_by=bound_by,
                         share_of_bound=bound_ms / ms)
    for path, fn in (("kernels", I.record_fused),
                     ("plain", I.record_reference)):
        def forward():
            return fn(o, d, idx, hit, scene, geom, eps)

        _, busy, events, _, _ = device_profile(forward)
        fields = {"forward_host_ms": host_ms(forward),
                  "forward_device_busy_ms": 1e3 * busy,
                  "forward_device_events": events}
        backward_host = []
        for rep in range(6):
            _, loss, leaves = record_loss(fn, *args, eps=eps)
            torch.cuda.synchronize()
            if rep == 5:
                _, busy, events, _, _ = device_profile(
                    lambda: leaf_grads(loss, leaves))
                continue
            t0 = time.perf_counter()
            leaf_grads(loss, leaves)
            backward_host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        fields.update(backward_host_ms=1e3 * float(np.median(backward_host)),
                      backward_device_busy_ms=1e3 * busy,
                      backward_device_events=events)
        out[path] = fields
    return out


def phase_trace():
    """Phase 22: the hit record (csrc/trace.cu) on bounce 0 of one SGD step
    of the benchmark's two train cells."""
    calls, launches = {}, {}
    for label, cell in TRACE_CELLS.items():
        calls[label] = trace_record_call(label, *first_trace_call(*cell))
        for k, v in calls[label]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    report("22 trace record", calls=calls)
    return launches, calls


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

    full, _, accel, headline_s = frames["headline"]
    runs = {}
    paths = {"5 headline+default+bitmap frames": dict(launches)}
    paths["8 GI frame"], runs["GI frame"] = phase_gi(small, full, accel)
    phase_grad_small(small)
    for label, phase, spp, gi in (("fwd+bwd", "10", 4, 0),
                                  ("northstar", "11", 128, 1)):
        paths[f"{phase} {label}"], runs[f"{label} step"] = phase_train(
            label, phase, full, accel, spp=spp, gi=gi, fd=gi > 0)
    paths["12 refexact frames"], more = phase_refexact(small, full, accel)
    runs.update(more)
    phase_profile("13", runs)
    kd_calls = phase_kd(full)
    with tempfile.TemporaryDirectory() as tmp:
        paths["15 kd frame"] = phase_refbin(tmp)
        paths["16 progressive+orbit"] = phase_progressive(tmp, full, accel)
    paths["17 sharded"] = phase_sharded(full, accel, headline_s)
    calls.update(phase_fast(full))
    phase_mxu(small, full)
    paths["20 gathers' backward"], gather_calls = phase_gather(full, accel)
    paths["21 shade"], shade_calls = phase_shade(full)
    paths["22 trace record"], trace_calls = phase_trace()
    for name, more in paths.items():
        if name[0] != "5":
            for k in launches:
                launches[k] += more[k]

    # The kernel line: the sweep on the GI frame's full-reach secondary
    # call, K1 on the headline's 16,384-ray primary chunk (phase 6), the
    # kd kernel on the kd frame's (phase 14), the fast kernel on the
    # refexact frame's (phase 18); `call` names it.
    calls.update(kd_calls)
    for kernel, what in ((K1, "K1 primary chunk (headline)"),
                         (SWEEP, "sweep full-reach secondary (GI frame)"),
                         (KD, "kd primary chunk (kd frame)"),
                         (FAST, "fast primary chunk (refexact frame)")):
        call = calls[what]
        KERNELS[kernel].update(
            launches=launches[kernel], max_abs_err=MAX_ERR[kernel],
            ms=call["ms"], plain_ms=call["plain_ms"],
            bound_ms=call["bound_ms"], bound_by=call["bound_by"],
            library_ms=None,
            call={"what": what, "kind": call["kind"], "rays": call["rays"],
                  **{k: call[k] for k in ("tiles", "triangles", "split")
                     if k in call}})
    what = f"{GATHER_ROWS} rows, width 9"
    call = gather_calls[what]
    KERNELS[GATHER].update(
        launches=launches[GATHER], max_abs_err=MAX_ERR[GATHER],
        ms=call["ms"], plain_ms=call["plain_ms"], bound_ms=call["bound_ms"],
        bound_by=call["bound_by"], library_ms=call["library_ms"],
        call={"what": what, "entries": call["entries"],
              "rows": call["rows"], "width": call["width"]})
    what = f"gi {SHADE_ROWS['gi']:,} rows"
    call = shade_calls[what]
    KERNELS[SHADE].update(
        launches=launches[SHADE], max_abs_err=MAX_ERR[SHADE],
        ms=call["kernels_ms"], plain_ms=call["plain_shading_ms"],
        bound_ms=call["bound_ms"], bound_by=call["bound_by"],
        library_ms=None, call={"what": what, "rows": call["rows"]})
    call = shade_calls[TRAIN_SHADE]["bounce 0"]
    KERNELS[SHADE_GRAD].update(
        launches=launches[SHADE_GRAD], max_abs_err=MAX_ERR[SHADE_GRAD],
        yardstick_share=YARDSTICK_SHARE[SHADE_GRAD],
        ms=call["kernels_ms"] + call["sums_ms"],
        plain_ms=call["plain"]["device_busy_ms"], bound_ms=call["bound_ms"],
        bound_by=call["bound_by"], library_ms=None,
        call={"what": f"the backward of bounce 0 of one {TRAIN_SHADE}, "
                      f"every float input requiring grad",
              "rows": call["rows"]})
    call = trace_calls["hw15_scene2.train"]
    for kernel, part in ((TRACE, "forward"), (TRACE_GRAD, "backward")):
        entry = call[part]
        KERNELS[kernel].update(
            launches=launches[kernel], max_abs_err=MAX_ERR[kernel],
            ms=entry["kernel_ms"] + entry.get("sums_ms", 0.0),
            plain_ms=call["plain"][f"{part}_device_busy_ms"],
            bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
            library_ms=None,
            call={"what": f"the {part} of bounce 0's record of one "
                          f"hw15_scene2.train step", "rays": call["rays"]})
    KERNELS[TRACE_GRAD]["yardstick_share"] = YARDSTICK_SHARE[TRACE_GRAD]
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
