"""PyTorch port: data-parallel rendering and SGD steps
(parallel/sharding.py) over two gloo processes on the CPU, and the port's
entry points (graft_entry.py), against the port in one process and the
JAX package's sharding on a 2-device mesh.

The two ranks run once, as fresh interpreters, for every case of this
file (module fixture); each is killed after TIMEOUT seconds.  A sharded
frame must equal the single-process frame with the same per-chunk sources
bit for bit (the chunks are folded in chunk order on every rank), and
JAX's sharded frame within 1e-4 (as every render parity test).  The float64
step must equal JAX's within rtol 1e-6 (as every gradient parity test)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import simd_raytracer_tpu as J
import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu.ops.grad import split_params as j_split_params
from simd_raytracer_tpu.parallel import sharding as JS
from simd_raytracer_tpu_torch import graft_entry
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.parallel import sharding
from torch_parity import JaxUniforms, to_x64
from torch_scenes import mixed_doc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
RENDER_DOC = mixed_doc(16, 24, g=12, subdiv=2)
TRAIN_DOC = mixed_doc(8, 8, g=8, subdiv=2)
# 384 or 768 ray ids in chunks of 80: 5 or 10 chunks, so one rank of two
# renders a padding slot at spp 1.
RENDER_CASES = {
    "split-deterministic": dict(chunk_size=80, max_ray_depth=3),
    "roulette-jax-keys": dict(chunk_size=80, max_ray_depth=3,
                              samples_per_pixel=2, bounce_mode="roulette"),
}
RENDER_SEED = 11
TRAIN_CFG = dict(max_ray_depth=2, samples_per_pixel=2, bounce_mode="roulette",
                 chunk_size=32, bounce_skip=False)
TRAIN_IDS = np.arange(64, dtype=np.int32).reshape(2, 32)
TRAIN_TARGET = np.full((2, 32, 3), 0.1)
TRAIN_SEEDS = np.array([[3], [5]], np.uint32)
TRAIN_LR = 2e-3


def jax_uniforms(seed, dtype=jnp.float32):
    """Chunk (or shard) index -> JAX's source for fold_in(key(seed), index)."""
    key = jax.random.PRNGKey(seed)
    return lambda c: JaxUniforms(jax.random.fold_in(key, int(c)), dtype)


def double(scene):
    return scene.map(lambda t: t.double() if t.is_floating_point() else t)


def render_sources(case, cfg):
    """The per-chunk sources of a case: the sharded frame's default for the
    deterministic case, JAX's chunk keys for the roulette one."""
    if case == "split-deterministic":
        return sharding.chunk_uniforms(cfg, "cpu", torch.float32)
    return jax_uniforms(RENDER_SEED)


def run_rank(out_dir: str) -> None:
    """One rank's work (run in a worker process): every render case and
    the float64 train step, saved to out_dir/rank<r>.npz."""
    rank = torch.distributed.get_rank()
    res = {}
    for case, kw in RENDER_CASES.items():
        img = sharding.render_frame_sharded(
            T.parse_scene_dict(RENDER_DOC), T.RenderConfig(**kw),
            device="cpu",
            uniforms=(None if case == "split-deterministic"
                      else jax_uniforms(RENDER_SEED)))
        res[case] = img.numpy()
    scene = double(T.parse_scene_dict(TRAIN_DOC))
    params, skeleton = G.split_params(scene)
    with enable_x64():
        new, loss = sharding.train_step_sharded(
            params, skeleton, T.RenderConfig(**TRAIN_CFG), None,
            torch.from_numpy(TRAIN_IDS), torch.from_numpy(TRAIN_TARGET),
            TRAIN_SEEDS, TRAIN_LR, uniforms=jax_uniforms(0, jnp.float64))
    res["loss"] = loss.numpy()
    res.update({f"param_{k}": v.numpy() for k, v in new.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


_WORKER = r"""
import sys
rank, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch.distributed as dist
from simd_raytracer_tpu_torch.parallel.sharding import init_distributed
init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                 rank=rank)
try:
    import test_torch_sharding
    test_torch_sharding.run_rank(out_dir)
finally:
    dist.destroy_process_group()
print("OK", rank)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results: [rank0, rank1], each {name: array}."""
    out = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    port = graft_entry.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(rank), str(port), str(out)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {rank}" in log, log[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_sharded_render_matches_one_process_and_jax(two_ranks, case):
    kw = RENDER_CASES[case]
    a, b = (r[case] for r in two_ranks)
    assert np.array_equal(a, b)
    cfg = T.RenderConfig(**kw)
    one = T.render_frame(T.parse_scene_dict(RENDER_DOC), cfg, device="cpu",
                         uniforms=render_sources(case, cfg))
    assert np.array_equal(a, one.numpy())
    ref = np.asarray(JS.render_frame_sharded(
        J.parse_scene_dict(RENDER_DOC), J.RenderConfig(**kw),
        JS.make_mesh(2), jax.random.PRNGKey(RENDER_SEED)))
    np.testing.assert_allclose(a, ref, rtol=0, atol=1e-4)
    assert np.abs(a).max() > 0


def test_sharded_train_step_matches_jax_and_the_shard_mean(two_ranks):
    got = two_ranks[0]
    for k, v in got.items():
        if k.startswith("param_") or k == "loss":
            assert np.array_equal(v, two_ranks[1][k]), k
    with enable_x64():
        js = to_x64(J.parse_scene_dict(TRAIN_DOC))
        jp, jsk = j_split_params(js)
        j_new, j_loss = JS.train_step_sharded(
            jp, jsk, J.RenderConfig(**TRAIN_CFG), JS.make_mesh(2),
            jnp.asarray(TRAIN_IDS), jnp.asarray(TRAIN_TARGET),
            jnp.asarray(TRAIN_SEEDS), TRAIN_LR)
        # The mean of the port's loss_and_grad over the two shards.
        params, skeleton = G.split_params(double(T.parse_scene_dict(
            TRAIN_DOC)))
        shards = [G.loss_and_grad(
            params, skeleton, T.RenderConfig(**TRAIN_CFG),
            torch.from_numpy(TRAIN_IDS[s]), torch.from_numpy(TRAIN_TARGET[s]),
            jax_uniforms(0, jnp.float64)(TRAIN_SEEDS[s, 0]))
            for s in range(2)]
    mean_loss = (float(shards[0][0]) + float(shards[1][0])) / 2
    np.testing.assert_allclose(got["loss"], float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(got["loss"], mean_loss, rtol=1e-6)
    for k in G.DIFF_PARAM_NAMES:
        g = (shards[0][1][k] + shards[1][1][k]).numpy() / 2
        mean_new = params[k].numpy() - TRAIN_LR * g
        np.testing.assert_allclose(got[f"param_{k}"], np.asarray(j_new[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(got[f"param_{k}"], mean_new, rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    assert not np.array_equal(got["param_vertices"],
                              params["vertices"].numpy())


def test_graft_entry_matches_jax():
    import __graft_entry__ as jg
    fn, (scene, ids, _) = graft_entry.entry(device="cpu")
    got = fn(scene, ids, JaxUniforms(jax.random.PRNGKey(0)))
    j_fn, j_args = jg.entry()
    ref = np.asarray(jax.jit(j_fn)(*j_args))
    assert tuple(got.shape) == (256, 3) and ref.shape == (256, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_gloo(n):
    """One rank runs in this process (a world of one made and torn down
    there), two as fresh processes."""
    graft_entry.dryrun_multichip(n, device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_the_whole_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        sharding.make_mesh(device="cpu")
