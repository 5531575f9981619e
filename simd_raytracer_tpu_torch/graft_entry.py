"""Entry points of the port: one render step, and a data-parallel dry run.

Counterpart of the repository's `__graft_entry__.py` for the JAX package:
`entry` returns a render step and its arguments on a tiny generated scene,
and `dryrun_multichip` runs one sharded render and one sharded SGD step
(`parallel/sharding.py`) over n ranks.

    python -m simd_raytracer_tpu_torch.graft_entry 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

# Seconds a dry-run process may take before it is killed.
DRYRUN_TIMEOUT = 300


def _tiny_scene(height=16, width=16):
    """Small synthetic scene (no file deps): a lit box of diffuse,
    reflective and refractive quads in front of the camera."""
    from .models.scene import build_scene

    def quad(cx, cy, z, s=0.8):
        v = np.array([[cx - s, cy - s, z], [cx + s, cy - s, z],
                      [cx + s, cy + s, z], [cx - s, cy + s, z]], np.float32)
        t = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
        return v, t

    meshes = [quad(-1.0, 0.0, -4.0), quad(1.0, 0.0, -5.0),
              quad(0.0, -1.2, -4.5)]
    return build_scene(
        mesh_vertices=[m[0] for m in meshes],
        mesh_tri_vidx=[m[1] for m in meshes],
        mesh_uvs=[None] * 3,
        mesh_material=[0, 1, 2],
        materials=[
            {"tag": 0, "albedo": (0.8, 0.3, 0.2), "smooth": False},
            {"tag": 1, "albedo": (0.9, 0.9, 0.9), "smooth": True},
            {"tag": 2, "ior": 1.5, "smooth": True},
        ],
        textures=[],
        lights=[((0.0, 2.0, -2.0), 60.0)],
        cam_pos=(0, 0, 0), cam_mat=np.eye(3), background=(0.05, 0.05, 0.1),
        height=height, width=width, bucket_size=8,
    )


def entry(device="cuda"):
    """(fn, args): fn(scene, ids, uniforms) renders one 256-ray chunk of the
    tiny scene to (256, 3) colors (chunk 256, depth 3), on `device` (the
    card unless the caller asks for "cpu")."""
    from .config import RenderConfig
    from .models.scene import derive_geometry
    from .ops.render import TorchUniforms, render_chunk, resolve_device

    dev = resolve_device(device)
    cfg = RenderConfig(chunk_size=256, max_ray_depth=3)
    scene = _tiny_scene().to(dev)

    def fn(scene, ids, uniforms):
        return render_chunk(scene, derive_geometry(scene), cfg, ids,
                            uniforms)

    ids = torch.arange(256, dtype=torch.int32, device=dev)
    return fn, (scene, ids, TorchUniforms.seeded(0, dev, torch.float32))


def _dryrun(device) -> None:
    """One sharded render (8x8) and one sharded SGD step (64 ray ids a
    rank) over the initialised process group."""
    from .config import RenderConfig
    from .ops.grad import split_params
    from .parallel.sharding import (make_mesh, render_frame_sharded,
                                    train_step_sharded)

    cfg = RenderConfig(chunk_size=64, max_ray_depth=2)
    mesh = make_mesh(device=device)
    scene = _tiny_scene(height=8, width=8).to(mesh.device)
    img = render_frame_sharded(scene, cfg, mesh)
    if img.shape != (8, 8, 3):
        raise AssertionError(f"sharded image of shape {tuple(img.shape)}")

    params, skeleton = split_params(scene)
    n, per_dev = mesh.size, 64
    ids = torch.arange(n * per_dev, dtype=torch.int32).reshape(n, per_dev)
    target = torch.zeros((n, per_dev, 3))
    seeds = torch.arange(n).reshape(n, 1)
    _, loss = train_step_sharded(params, skeleton, cfg, mesh, ids, target,
                                 seeds)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"sharded train step loss {float(loss)}")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, n_devices: int, port: int, device: str) -> None:
    import torch.distributed as dist

    from .parallel.sharding import init_distributed
    init_distributed(device, init_method=f"tcp://127.0.0.1:{port}",
                     world_size=n_devices, rank=rank)
    try:
        _dryrun(device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded render and one sharded SGD step over n_devices ranks on
    `device` (the card unless the caller asks for "cpu").

    n_devices == 1 runs in this process: in its process group where one is
    initialised, else in a world of one made and torn down here.  More
    ranks run as that many fresh processes, gloo on the CPU or NCCL with
    one card each, each killed after DRYRUN_TIMEOUT seconds; a rank that
    fails raises here with its output."""
    import torch.distributed as dist

    from .ops.render import resolve_device
    dev = resolve_device(device)
    if n_devices == 1:
        if dist.is_initialized():
            _dryrun(dev)
        else:
            _worker(0, 1, free_port(), str(dev))
        return
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need as many cards, not "
                         f"{torch.cuda.device_count()}")
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "simd_raytracer_tpu_torch.graft_entry",
         str(n_devices), "--device", dev.type, "--rank", str(rank),
         "--port", str(port)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DRYRUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {rank} exited {p.returncode}:\n{out}"
              for rank, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError("dry run failed: " + "\n".join(failed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One sharded render and SGD step over n ranks.")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int,
                    help="run as this rank of a rendezvous at --port")
    ap.add_argument("--port", type=int)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_devices, args.device)
    else:
        _worker(args.rank, args.n_devices, args.port, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
