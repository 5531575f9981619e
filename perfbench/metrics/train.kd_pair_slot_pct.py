"""Share of the kd kernel's pair slots that ran a needed pair test in the
traced SGD steps: 100 * the kernel's `kd.tests` counter over `kd.slots`
(the staged live triangles of each leaf round times the block's rays).
It shows how the kd walk fills its lanes on the boxes refitted to each
step's vertices."""

from pb import counters


def read(run):
    return counters.share_pct(run, "sgd_steps", "kd.tests", "kd.slots")
