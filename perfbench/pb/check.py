"""How `correct` is decided: the program's answers against the plain
reference's (`perfbench/kinds/<kind>.py`: `reference` and `compare`), one
number per check, each held to its limit from
`perfbench/limits/<workload>.json`.  The reference runs after the window,
once the program's state is freed.
"""

from __future__ import annotations

import numpy as np

NOT_FINITE = 1e300


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number
    is at most its limit.  A missing or non-finite number fails and is
    shown as NOT_FINITE, which JSON can hold."""
    rows = {}
    ok = True
    for name, lim in limits.items():
        v = numbers.get(name, float("inf"))
        if not np.isfinite(v):
            v = NOT_FINITE
        rows[name] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    return ok, rows
