"""CLI: `python -m simd_raytracer_tpu_torch SCENE.crtscene -o out.ppm`
renders the scene on the chosen device and writes an ASCII PPM, printing
the render wall time (reference src/main.cpp:27-46: parse, build the
kd-tree, render in bucket tiles)."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="simd_raytracer_tpu_torch",
        description="PyTorch/CUDA port of the simd_raytracer_tpu renderer")
    ap.add_argument("scene", help=".crtscene file")
    ap.add_argument("-o", "--output", default="image.ppm")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--gi-rays", type=int, default=0,
                    help="diffuse_reflection_ray_count")
    ap.add_argument("--fov", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--width", type=int, default=None,
                    help="override the scene's width")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--intersector", default="jnp",
                    choices=["jnp", "fast", "pallas", "kdtree", "sweep"],
                    help="jnp and pallas both run the brute-force select")
    ap.add_argument("--bounce-mode", default="split",
                    choices=["split", "roulette"])
    ap.add_argument("--occlusion", default="fast", choices=["fast", "march"],
                    help="shadow query: march re-origins through glass hop "
                         "by hop (render.hpp:110-131)")
    ap.add_argument("--ray-order", default="auto",
                    choices=["auto", "linear", "tiled"],
                    help="ray-id order: tiled walks 32x32 screen blocks; "
                         "auto picks tiled for --intersector sweep.  Changes "
                         "which samples each pixel draws, not the estimator")
    ap.add_argument("--scheduling", default="linear",
                    choices=["linear", "single", "region", "bucket"],
                    help="tile order (reference tile/*.hpp); bucket is the "
                         "reference binary's (main.cpp:17)")
    ap.add_argument("--progressive-batch", type=int, default=0,
                    help="render --spp in batches of this many samples, "
                         "checkpointing after each (0 = one shot)")
    ap.add_argument("--checkpoint", default=None,
                    help="accumulation checkpoint path for progressive mode")
    ap.add_argument("--profile", action="store_true",
                    help="print per-phase timings (load, accel_build, "
                         "render)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to render "
                         "on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from simd_raytracer_tpu_torch import (RenderConfig, parse_scene_file,
                                          render_frame, save_ppm)
    from simd_raytracer_tpu_torch.ops.render import build_accel
    from simd_raytracer_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    with timer.phase("load"):
        scene = parse_scene_file(args.scene)
        if args.width or args.height:
            scene = scene.replace(width=args.width or scene.width,
                                  height=args.height or scene.height)
    cfg = RenderConfig(
        samples_per_pixel=args.spp, max_ray_depth=args.max_depth,
        diffuse_reflection_ray_count=args.gi_rays, fov_degrees=args.fov,
        rng_seed=args.seed, chunk_size=args.chunk,
        intersector=args.intersector, bounce_mode=args.bounce_mode,
        occlusion_mode=args.occlusion, ray_order=args.ray_order)

    accel = None
    if args.intersector in ("kdtree", "sweep"):
        with timer.phase("accel_build"):
            accel = build_accel(scene, cfg)

    scheduling = None
    if args.scheduling != "linear":
        from simd_raytracer_tpu_torch.parallel.tiles import SchedulingType
        scheduling = {"single": SchedulingType.SINGLE,
                      "region": SchedulingType.REGION_GRID,
                      "bucket": SchedulingType.BUCKET_TILES}[args.scheduling]

    t0 = time.perf_counter()
    with timer.phase("render"):
        if args.progressive_batch:
            from simd_raytracer_tpu_torch.utils.checkpoint import (
                render_progressive)
            img = render_progressive(
                scene, cfg, total_spp=args.spp,
                spp_per_batch=args.progressive_batch,
                checkpoint_path=args.checkpoint, accel=accel,
                device=args.device)
        else:
            img = render_frame(scene, cfg, device=args.device, accel=accel,
                               scheduling=scheduling)
            if img.is_cuda:
                torch.cuda.synchronize(img.device)
    print(f"Rendering took {time.perf_counter() - t0} seconds.")
    if args.profile:
        print(timer.report())
    save_ppm(img, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
