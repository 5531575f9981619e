"""simd_raytracer_tpu_torch - simd_raytracer_tpu's render and training
paths in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

`.crtscene` loading, the flat scene model, camera rays and moves,
textures, the brute-force, block-sparse sweep, kd-tree and division-free
"fast" selects, Whitted shading with diffuse GI and fast or march
occlusion, the chunked wavefront render loop with the reference's tile
schedules, gradients and SGD steps (`ops.grad`), progressive rendering,
animation and profiling (`utils`), held against the JAX package of the
same module paths and names.  On CUDA tensors the brute-force, sweep, kd
and fast selects and the gathers' backward (`ops/gather.py`) run the
kernels in `csrc/` (built with nvcc at first use, see kernels.py); on CPU
tensors their plain torch versions.
"""

from .config import DEFAULT_CONFIG, RenderConfig
from .models.loader import parse_scene_dict, parse_scene_file
from .models.scene import Scene, derive_geometry
from .ops.render import render_frame
from .utils.ppm import ppm_bytes, save_ppm, write_ppm

__version__ = "0.1.0"
