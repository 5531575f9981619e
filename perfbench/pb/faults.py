"""Faults are planted in the program's timed path by patching the port
while a context is open.  Each kind of work lists its own faults under
`FAULTS` in `perfbench/kinds/<kind>.py`; the check has to come out not
correct under every one (`controls.py` reads them on the card, the
checks' tests on the CPU).
"""

from __future__ import annotations

import contextlib
import importlib

PORT = "simd_raytracer_tpu_torch"


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    """`PORT.<module>.<attr>` replaced by `make(original)` while open."""
    mod = importlib.import_module(f"{PORT}.{module}")
    inner = getattr(mod, attr)
    setattr(mod, attr, make(inner))
    try:
        yield
    finally:
        setattr(mod, attr, inner)
