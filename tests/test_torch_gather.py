"""PyTorch port: the row gather of differentiable tables (ops/gather.py)
and the plain version of its backward, on the CPU.

The backward sums each row's gradients in a fixed order of pieces, lanes
and trees; in float64 it agrees with index_put_(accumulate=True) to
rounding: within 1e-12 of the sum of the magnitudes it adds.  The CUDA
kernel is held against the plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import simd_raytracer_tpu_torch as T
from simd_raytracer_tpu_torch.ops import grad as G
from simd_raytracer_tpu_torch.ops.gather import (PIECE, GatherRows,
                                                 gather_rows,
                                                 row_sums_reference)
from simd_raytracer_tpu_torch.utils import profiling
from torch_scenes import SeededUniforms, mixed_doc

torch.set_num_threads(2)


def skewed_idx(n_rows, n, seed):
    """n indices into n_rows rows, as the render's gathers draw them: a
    third on row 0 (missed slots, untextured materials), the rest
    uniform."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n)
    idx[rng.random(n) < 1 / 3] = 0
    return torch.from_numpy(idx)


def assert_sums(idx, values, n_rows):
    """row_sums_reference against index_put_(accumulate=True), float64:
    within 1e-12 of each row's sum of |values|."""
    got = row_sums_reference(idx, values, n_rows)
    want = torch.zeros((n_rows, values.shape[1]), dtype=values.dtype
                       ).index_put_((idx,), values, accumulate=True)
    scale = torch.zeros_like(want).index_put_((idx,), values.abs(),
                                              accumulate=True)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert bool(((got - want).abs() <= 1e-12 * scale).all())
    return got


@pytest.mark.parametrize("width", [1, 3, 6, 9])
@pytest.mark.parametrize("n_rows", [1, 3, 12, 2012])
def test_plain_backward_matches_index_put(n_rows, width):
    idx = skewed_idx(n_rows, 5000, seed=n_rows * 10 + width)
    values = torch.randn(5000, width, dtype=torch.float64)
    assert_sums(idx, values, n_rows)


@pytest.mark.parametrize("case", ["one_row_65536", "runs_cross_pieces",
                                  "piece_edges", "empty", "distinct",
                                  "unsorted_many_rows"])
def test_plain_backward_edge_cases(case):
    g = torch.Generator().manual_seed(3)
    if case == "one_row_65536":
        idx, n_rows = torch.zeros(65536, dtype=torch.long), 1
    elif case == "runs_cross_pieces":
        # Runs of 300, 700 and 1,000 start and end inside pieces.
        idx = torch.repeat_interleave(torch.tensor([2, 0, 1]),
                                      torch.tensor([300, 700, 1000]))
        idx, n_rows = idx[torch.randperm(2000, generator=g)], 4
    elif case == "piece_edges":
        # Runs of exactly a piece, a piece +- 1 and one entry.
        idx = torch.repeat_interleave(
            torch.arange(5), torch.tensor([PIECE, PIECE - 1, 1, PIECE + 1,
                                           2 * PIECE]))
        n_rows = 6
    elif case == "empty":
        idx, n_rows = torch.zeros(0, dtype=torch.long), 5
    elif case == "distinct":
        idx, n_rows = torch.randperm(700, generator=g), 700
    else:
        idx, n_rows = torch.randint(0, 2012, (65536,), generator=g), 2012
    values = torch.randn(idx.numel(), 3, dtype=torch.float64, generator=g)
    got = assert_sums(idx, values, n_rows)
    if case == "empty":
        assert bool((got == 0).all())


@pytest.mark.parametrize("shape", [(20, 3), (20, 3, 3), (20, 3, 2), (20,)],
                         ids=["v0", "vn", "uv", "ior"])
@pytest.mark.parametrize("idx_shape", [(4000,), (300, 3)])
@pytest.mark.parametrize("grad_on", [True, False])
def test_forward_is_plain_indexing(shape, idx_shape, grad_on):
    table = torch.randn(shape, dtype=torch.float32).requires_grad_(grad_on)
    idx = skewed_idx(shape[0], int(np.prod(idx_shape)), seed=1).reshape(
        idx_shape)
    got = gather_rows(table, idx)
    assert got.shape == idx_shape + shape[1:]
    assert torch.equal(got.detach(), table.detach()[idx])


@pytest.mark.parametrize("shape", [(7, 3), (5, 3, 3), (6, 3, 2), (4,)],
                         ids=["v0", "vn", "uv", "ior"])
def test_gradcheck(shape):
    table = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    idx = skewed_idx(shape[0], 120, seed=2).reshape(60, 2)
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, idx), (table,))


@pytest.mark.parametrize("case", ["no_grad_table", "grad_off",
                                  "grad_on"])
def test_bypass_without_a_gradient(case):
    table = torch.randn(12, 3, requires_grad=case != "no_grad_table")
    idx = skewed_idx(12, 1000, seed=4)
    if case == "grad_off":
        with torch.no_grad():
            got = gather_rows(table, idx)
    else:
        got = gather_rows(table, idx)
    plain = table[idx]
    assert type(got) is type(plain)
    if case == "grad_on":
        assert type(got.grad_fn).__name__ == GatherRows.__name__ + "Backward"
    else:
        assert got.grad_fn is None and torch.equal(got, plain)


@pytest.mark.parametrize("n", [0, 300, 65536])
def test_counters_under_recording(n):
    table = torch.randn(12, 3, 2, requires_grad=True)
    idx = skewed_idx(12, n, seed=5)
    with profiling.recording() as rec:
        out = gather_rows(table, idx)
        (g,) = torch.autograd.grad(out.sum(), table)
    assert rec.counts["gather.backward.calls"] == 1
    assert rec.counts["gather.backward.rows"] == n
    assert rec.counts["gather.backward.pieces"] == -(-n // PIECE)
    # The plain version launches nothing.
    assert rec.counts["gather.launches"] == 0
    # d sum / d table: how often each row was read.
    assert torch.equal(g.reshape(12, 6), torch.bincount(
        idx, minlength=12).float()[:, None].expand(12, 6))
    # Off: nothing is counted.
    before = profiling.record()["counts"].get("gather.backward.calls", 0)
    torch.autograd.grad(gather_rows(table, idx).sum(), table)
    assert profiling.record()["counts"].get("gather.backward.calls",
                                            0) == before


@pytest.fixture(scope="module")
def small():
    return T.parse_scene_dict(mixed_doc(12, 16, g=8, subdiv=2))


@pytest.mark.parametrize("path", ["train", "frame"])
def test_training_engages_and_frames_bypass(small, path):
    """An SGD step's differentiable gathers go through GatherRows (the
    triangle, material and texture tables of every bounce and the
    geometry's); a frame's tables need no gradient and bypass it."""
    cfg = T.RenderConfig(max_ray_depth=2, bounce_mode="roulette",
                         diffuse_reflection_ray_count=1)
    with profiling.recording() as rec:
        if path == "train":
            params, skeleton = G.split_params(small)
            n = 12 * 16
            G.loss_and_grad(params, skeleton, cfg, torch.arange(n),
                            torch.full((n, 3), 0.1), SeededUniforms(8, 0))
        else:
            T.render_frame(small, cfg, device="cpu")
    calls = rec.counts["gather.backward.calls"]
    if path == "train":
        # The geometry's 4, then up to 12 a bounce (8 in trace, 4 in
        # sample_texture): those whose output reaches the loss.
        assert calls >= 4 + 12
        assert rec.counts["gather.backward.rows"] > 0
    else:
        assert calls == 0
