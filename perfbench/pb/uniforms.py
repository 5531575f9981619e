"""The estimator's uniforms, drawn from the run's `--seed`.

One source serves one chunk of one unit of work (a frame, or an SGD step)
and has the three methods the port's `render_chunk` calls: `jitter(n)`,
`coin(depth, n)` and `gi(depth, n, count)`.  Each draw comes from one
`torch.Generator` per device, seeded anew by a hash of (seed, unit,
chunk, draw), so a draw does not depend on which draws came before it:
the plain reference asks for the same (unit, chunk, draw) at the same
width and gets the same numbers, whatever order it works in.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1
JITTER, COIN, GI = 0, 1, 2


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def draw_seed(*key: int) -> int:
    """A 63-bit generator seed from a tuple of whole numbers."""
    h = 0x243F6A8885A308D3
    for k in key:
        h = _mix(h ^ (int(k) & _MASK))
    return h >> 1


_GENERATORS = {}


def _generator(device: torch.device) -> torch.Generator:
    """One generator per device, made once: every draw seeds it anew."""
    if device not in _GENERATORS:
        _GENERATORS[device] = torch.Generator(device=device)
    return _GENERATORS[device]


class Source:
    """Uniforms of chunk `chunk` of unit `unit` of a run seeded `seed`."""

    def __init__(self, seed: int, unit: int, chunk: int, device,
                 dtype=torch.float32):
        self.key = (seed, unit, chunk)
        self.device = torch.device(device)
        self.dtype = dtype

    def _rand(self, shape, *draw: int) -> torch.Tensor:
        gen = _generator(self.device)
        gen.manual_seed(draw_seed(*self.key, *draw))
        return torch.rand(shape, generator=gen, device=self.device,
                          dtype=torch.float32).to(self.dtype)

    def jitter(self, n: int) -> torch.Tensor:
        return self._rand((n, 2), JITTER)

    def coin(self, depth: int, n: int) -> torch.Tensor:
        return self._rand((n,), COIN, depth)

    def gi(self, depth: int, n: int, count: int) -> torch.Tensor:
        return self._rand((n, count, 2), GI, depth)
