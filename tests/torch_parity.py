"""Helpers shared by the PyTorch port's parity tests: the JAX side's
uniforms as an injectable source, and one scene on both sides."""

import jax
import jax.numpy as jnp
import numpy as np

from simd_raytracer_tpu_torch.models.scene import (SCENE_TENSOR_FIELDS,
                                                   scene_from_arrays)


class JaxUniforms:
    """The uniforms JAX's render_chunk draws for one chunk key
    (ops/render.py:70-96 of the JAX package), in `dtype`."""

    def __init__(self, key, dtype=jnp.float32):
        self.key, self.dtype = key, dtype

    def jitter(self, n):
        return np.array(jax.random.uniform(
            jax.random.fold_in(self.key, 0), (n, 2), self.dtype))

    def coin(self, depth, n):
        k = jax.random.fold_in(jax.random.fold_in(self.key, depth + 1), 1)
        return np.array(jax.random.uniform(k, (n,), self.dtype))

    def gi(self, depth, n, count):
        # Drawn from the bounce key itself, not a fold of it.
        return np.array(jax.random.uniform(
            jax.random.fold_in(self.key, depth + 1), (n, count, 2),
            self.dtype))


def to_x64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        tree)


def port_scene(js, device="cpu"):
    """The port's Scene holding a JAX Scene's arrays (dtype kept)."""
    return scene_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in SCENE_TENSOR_FIELDS},
        height=js.height, width=js.width, bucket_size=js.bucket_size,
        num_meshes=js.num_meshes, device=device)
