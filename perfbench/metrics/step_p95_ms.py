"""95th percentile of the host milliseconds of every SGD step of the
window, each ending in a synchronize (inclusive quantiles)."""

import statistics


def read(run):
    if run["kind"] != "sgd_steps" or len(run.get("unit_s", ())) < 2:
        return None
    ms = [1e3 * s for s in run["unit_s"]]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
