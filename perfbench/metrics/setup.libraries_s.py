"""Host seconds of the port's set-up phases `kernel_library` (the nvcc
build or load of the CUDA kernels, and their binding) and
`native_library` (the g++ build or load of the native host code), as
`utils/profiling.py::SETUP` times them; nothing where neither ran or the
port has no such timer."""

PHASES = ("kernel_library", "native_library")


def read(run):
    from simd_raytracer_tpu_torch.utils import profiling
    setup = getattr(profiling, "SETUP", None)
    if setup is None or not any(p in setup.seconds for p in PHASES):
        return None
    return sum(setup.seconds.get(p, 0.0) for p in PHASES)
