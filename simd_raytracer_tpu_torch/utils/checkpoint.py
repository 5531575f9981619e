"""Progressive rendering with checkpoint/resume.

Counterpart of `simd_raytracer_tpu.utils.checkpoint`.  The samples of a
long render are streamed in batches; after each batch the running sample
sum is checkpointed, so a killed render resumes at the last completed
batch.  The state is a plain npz, as in the JAX package: `accum` (the
float64 sample-sum image), `samples_done`, and a `fingerprint` over every
RenderConfig field, the batch size and the scene's tensors, which guards
against resuming another render's buffer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import SCENE_TENSOR_FIELDS, Scene


def _fingerprint(scene: Scene, cfg: RenderConfig, spp_per_batch: int) -> str:
    """Hash of every RenderConfig field (any of them changes what a sample
    means), spp_per_batch (it sets the per-batch seeds) and the scene's
    contents."""
    h = hashlib.sha256()
    h.update(repr((scene.height, scene.width, spp_per_batch,
                   dataclasses.astuple(cfg))).encode())
    for name in SCENE_TENSOR_FIELDS:
        h.update(getattr(scene, name).detach().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def batch_seed(seed: int, batch: int) -> int:
    """The torch.Generator seed of batch `batch`: a function of (seed,
    batch) alone, so a resumed render draws what the uninterrupted one
    drew."""
    return int(np.random.SeedSequence([seed, batch]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def render_progressive(
    scene: Scene,
    cfg: RenderConfig,
    total_spp: int,
    spp_per_batch: int = 8,
    checkpoint_path: Optional[str] = None,
    on_batch: Optional[Callable[[int, np.ndarray], None]] = None,
    accel=None,
    *,
    device="cuda",
    uniforms: Optional[Callable[[int], Callable[[int], object]]] = None,
) -> np.ndarray:
    """Render total_spp samples per pixel in resumable batches on `device`
    (the card unless the caller asks for "cpu") -> (H, W, 3) float32.

    Batch b renders spp_per_batch fresh samples.  By default it draws
    from a torch.Generator seeded from (cfg.rng_seed, b) alone
    (`batch_seed`); `uniforms` replaces that: batch -> (chunk -> uniform
    source), as render_frame takes it.  Each batch adds its sample sum to
    the buffer and, with checkpoint_path, writes the checkpoint
    atomically; a resume skips the batches the checkpoint holds.
    on_batch(samples_done, running_mean_image) is a progress hook."""
    from ..ops.render import build_accel, render_frame, resolve_device

    if spp_per_batch <= 0 or total_spp % spp_per_batch != 0:
        raise ValueError("total_spp must be a positive multiple of "
                         "spp_per_batch")
    dev = resolve_device(device)
    n_batches = total_spp // spp_per_batch
    h, w = scene.height, scene.width
    fp = _fingerprint(scene, cfg, spp_per_batch)

    accum = np.zeros((h, w, 3), np.float64)
    done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path, allow_pickle=False) as ck:
            if str(ck["fingerprint"]) == fp:
                accum = ck["accum"]
                done = int(ck["samples_done"])
            else:
                # A long render resumed under another scene or config
                # would silently throw away its samples: say so.
                warnings.warn(
                    f"checkpoint {checkpoint_path!r} was written for a "
                    f"different scene/config (fingerprint "
                    f"{str(ck['fingerprint'])[:8]}... != {fp[:8]}...); "
                    f"restarting from scratch ("
                    f"{int(ck['samples_done'])} samples discarded)",
                    stacklevel=2)

    seed = cfg.rng_seed if cfg.rng_seed is not None else 0
    if accel is None:
        accel = build_accel(scene, cfg)
    for b in range(done // spp_per_batch, n_batches):
        batch_cfg = dataclasses.replace(cfg, samples_per_pixel=spp_per_batch,
                                        rng_seed=batch_seed(seed, b))
        img = render_frame(scene, batch_cfg, device=dev, accel=accel,
                           uniforms=None if uniforms is None else uniforms(b))
        accum += img.to(torch.float64).cpu().numpy() * spp_per_batch
        done += spp_per_batch
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp.npz"   # savez keeps an .npz name
            np.savez(tmp, accum=accum, samples_done=done, fingerprint=fp)
            os.replace(tmp, checkpoint_path)     # atomic swap
        if on_batch:
            on_batch(done, (accum / max(done, 1)).astype(np.float32))

    return (accum / max(done, 1)).astype(np.float32)
