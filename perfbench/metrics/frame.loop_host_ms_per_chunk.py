"""Host milliseconds of the render loop a chunk of a traced frame:
the self time of the port's `chunk` span (`ops/render.py::render_chunk`
less its trace, shade and wait spans) over its calls."""


def read(run):
    if run["kind"] != "frames" or run.get("trace") is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    chunk = None if record is None else record()["spans"].get("chunk")
    if chunk is None or chunk["calls"] == 0:
        return None
    return 1e3 * chunk["self_s"] / chunk["calls"]
