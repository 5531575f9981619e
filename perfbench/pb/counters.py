"""The port's profiling counters as a per-layer reader reads them."""


def share_pct(run, kind, part, whole):
    """100 * counter `part` over counter `whole` in the traced units of a
    run of `kind`; None in an untraced run, a run of another kind, or
    where the program counted no `whole`."""
    if run["kind"] != kind or run.get("trace") is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    counts = {} if record is None else record()["counts"]
    if not counts.get(whole):
        return None
    return 100.0 * counts.get(part, 0) / counts[whole]
