"""CLI: `python -m simd_raytracer_tpu_torch SCENE.crtscene -o out.ppm`
renders the scene on the chosen device and writes an ASCII PPM, printing
the render wall time (reference src/main.cpp:27-46)."""

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
                    choices=["jnp", "fast", "pallas", "sweep"],
                    help="jnp and pallas both run the brute-force select")
    ap.add_argument("--bounce-mode", default="split",
                    choices=["split", "roulette"])
    ap.add_argument("--occlusion", default="fast", choices=["fast", "march"],
                    help="shadow query: march re-origins through glass hop "
                         "by hop (render.hpp:110-131)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to render "
                         "on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from simd_raytracer_tpu_torch import (RenderConfig, parse_scene_file,
                                          render_frame, save_ppm)

    scene = parse_scene_file(args.scene)
    if args.width or args.height:
        scene = scene.replace(width=args.width or scene.width,
                              height=args.height or scene.height)
    cfg = RenderConfig(
        samples_per_pixel=args.spp, max_ray_depth=args.max_depth,
        diffuse_reflection_ray_count=args.gi_rays, fov_degrees=args.fov,
        rng_seed=args.seed, chunk_size=args.chunk,
        intersector=args.intersector, bounce_mode=args.bounce_mode,
        occlusion_mode=args.occlusion)

    t0 = time.perf_counter()
    img = render_frame(scene, cfg, device=args.device)
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    print(f"Rendering took {time.perf_counter() - t0} seconds.")
    save_ppm(img, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
