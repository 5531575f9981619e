"""What the process did on the host while the window ran, for the record
on standard error: its own CPU seconds and Python's garbage collections
and their seconds.  Nothing here is a metric."""

from __future__ import annotations

import gc
import resource
import time


class Watch:
    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None

    def _collected(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1
            self._t = None

    def __enter__(self):
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._collected)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collected)
        self.ru1 = resource.getrusage(resource.RUSAGE_SELF)

    def report(self) -> str:
        r0, r1 = self.ru0, self.ru1
        return (f"host: process user {r1.ru_utime - r0.ru_utime:.3f} s sys "
                f"{r1.ru_stime - r0.ru_stime:.3f} s; gc {self.gc_n} "
                f"collections {self.gc_s:.4f} s")
