"""Host seconds of the port's set-up phase `load`: parsing the scene
(`models/loader.py`), as `utils/profiling.py::SETUP` times it; nothing
from a port without that timer."""


def read(run):
    from simd_raytracer_tpu_torch.utils import profiling
    setup = getattr(profiling, "SETUP", None)
    return None if setup is None else setup.seconds.get("load")
