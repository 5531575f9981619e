"""ASCII P3 PPM writer, byte-compatible with the reference writer
(reference: include/raytracer/io/image/ppm.hpp:7-25) and with
`simd_raytracer_tpu.utils.ppm`: header `P3`, `W H`, `255`, then one image
row per line with `R G B\t` per pixel, each channel
`uint8(255.999 * clamp(c, 0, 1))` (truncating cast), in float32.  The C++
encoder of `native/ppm.cpp` (through `..native`) writes the same bytes.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np


def _to_numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):          # a torch tensor, on any device
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float32)


def image_to_u8(img) -> np.ndarray:
    """(H, W, 3) float -> uint8 via the reference's 255.999*clamp cast."""
    return (np.float32(255.999) * np.clip(_to_numpy(img), 0.0, 1.0)
            ).astype(np.uint8)


def write_ppm(img, stream) -> None:
    """Write an (H, W, 3) float image as ASCII P3 to a text stream."""
    u8 = image_to_u8(img)
    h, w = u8.shape[:2]
    stream.write(f"P3\n{w} {h}\n255\n")
    for row in u8:
        stream.write("".join(f"{r} {g} {b}\t" for r, g, b in row) + "\n")


def ppm_bytes(img, use_native: Optional[bool] = None) -> bytes:
    """Encode to P3 bytes.  use_native: True forces the C++ encoder
    (raising where its library cannot be built), False the Python one;
    None takes the C++ encoder when its library builds."""
    if use_native is None or use_native:
        from ..native import native_ppm_encode
        out = native_ppm_encode(_to_numpy(img))
        if out is not None:
            return out
        if use_native:
            raise RuntimeError("native PPM encoder requested, but its "
                               "library could not be built")
    buf = io.StringIO()
    write_ppm(img, buf)
    return buf.getvalue().encode()


def save_ppm(img, path: str) -> None:
    with open(path, "wb") as f:
        f.write(ppm_bytes(img))


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM back into an (H, W, 3) uint8 array."""
    with open(path, "r") as f:
        tokens = f.read().split()
    if tokens[0] != "P3" or tokens[3] != "255":
        raise ValueError(f"{path}: not an ASCII P3 PPM with maxval 255")
    w, h = int(tokens[1]), int(tokens[2])
    data = np.array(tokens[4:4 + w * h * 3], dtype=np.int64)
    return data.reshape(h, w, 3).astype(np.uint8)
