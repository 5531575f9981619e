"""ctypes bindings to the native C++ host components in `native/`.

The kd-tree builder (`native/kdtree.cpp`), the `.crtscene` parser
(`native/loader.cpp`) and the PPM encoder (`native/ppm.cpp`) are read in
place and compiled at first use with g++ under the flags of
`native/Makefile` into one shared library in this package's git-ignored
`_build/`, named by a hash of the sources, the flags and the host CPU (a
changed source rebuilds, an unchanged one loads at once).  Nothing is
compiled or loaded at import time.

Every entry point returns None when the library cannot be built or loaded
(no compiler, no `native/` sources), and its caller then takes the Python
implementation, which gives the same output: the tests hold the two
against each other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("kdtree.cpp", "ppm.cpp", "loader.cpp")
# native/Makefile's CXXFLAGS.  -march=native ties the library to the CPU
# it was built on, so the library's name also hashes that CPU's model and
# feature flags: a checkout copied to another machine builds its own.
CXXFLAGS = ["-O3", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-march=native"]

_lock = threading.Lock()
_lib = None
_lib_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cpu_id() -> bytes:
    """The host CPU's model and feature lines (empty where /proc/cpuinfo
    cannot be read)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = (b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def library_path() -> Optional[str]:
    """Where the library for the current sources, flags and CPU lives
    (None when the sources are absent)."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_cpu_id())
    for name in SOURCES:
        path = os.path.join(NATIVE_DIR, name)
        if not os.path.exists(path):
            return None
        h.update(name.encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsrt_native_{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    """Compile the sources into `out` (atomically); True on success."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXXFLAGS, "-shared", "-o", tmp,
           *(os.path.join(NATIVE_DIR, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.srt_kdtree_build.restype = ctypes.c_void_p
    lib.srt_kdtree_build.argtypes = [
        _F32P, _F32P, _I32P, ctypes.c_int32,        # tri_min, tri_max, ids, n
        ctypes.c_int32, ctypes.c_int32]             # max_depth, max_leaf
    lib.srt_kdtree_counts.restype = None
    lib.srt_kdtree_counts.argtypes = [ctypes.c_void_p, _I32P, _I32P, _I32P]
    lib.srt_kdtree_export.restype = None
    lib.srt_kdtree_export.argtypes = [ctypes.c_void_p] + [_F32P] * 2 + \
        [_I32P] * 4
    lib.srt_kdtree_free.restype = None
    lib.srt_kdtree_free.argtypes = [ctypes.c_void_p]

    lib.srt_ppm_encode.restype = ctypes.c_int64
    lib.srt_ppm_encode.argtypes = [_F32P, ctypes.c_int32, ctypes.c_int32,
                                   _U8P, ctypes.c_int64]

    lib.srt_scene_parse.restype = ctypes.c_void_p
    lib.srt_scene_parse.argtypes = [ctypes.c_char_p]
    lib.srt_scene_error.restype = ctypes.c_char_p
    lib.srt_scene_error.argtypes = [ctypes.c_void_p]
    lib.srt_scene_header.restype = None
    lib.srt_scene_header.argtypes = [ctypes.c_void_p] + [_I32P] * 3 + \
        [_F32P] * 3 + [_I32P] * 4
    lib.srt_scene_lights.restype = None
    lib.srt_scene_lights.argtypes = [ctypes.c_void_p, _F32P, _F32P]
    lib.srt_scene_material.restype = None
    lib.srt_scene_material.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       _I32P, _F32P, _F32P, _I32P, _I32P]
    lib.srt_scene_texture.restype = ctypes.c_int32
    lib.srt_scene_texture.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                      _I32P, _F32P, _F32P, _F32P,
                                      ctypes.c_char_p, ctypes.c_int32]
    lib.srt_scene_object_counts.restype = None
    lib.srt_scene_object_counts.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                            _I32P, _I32P, _I32P, _I32P]
    lib.srt_scene_object_data.restype = None
    lib.srt_scene_object_data.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                          _F32P, _F32P, _I32P]
    lib.srt_scene_free.restype = None
    lib.srt_scene_free.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first call; None when it cannot be."""
    global _lib, _lib_tried
    with _lock:
        if _lib is None and not _lib_tried:
            _lib_tried = True
            path = library_path()
            if path is not None and (os.path.exists(path) or _build(path)):
                try:
                    _lib = _bind(ctypes.CDLL(path))
                except OSError:
                    _lib = None
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def native_build_kdtree(tri_min: np.ndarray, tri_max: np.ndarray,
                        valid: Optional[np.ndarray], max_depth: int,
                        max_leaf: int, required: bool = False):
    """The C++ kd-tree build -> KdTree of CPU tensors, or None when the
    library is missing (RuntimeError instead with required=True)."""
    lib = _load()
    if lib is None:
        if required:
            raise RuntimeError(
                "native kd-tree builder requested, but the library could "
                f"not be built from {NATIVE_DIR} with g++")
        return None
    from .accel.build import kdtree_from_arrays

    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    if tri_min.shape != tri_max.shape or tri_min.shape[1:] != (3,):
        raise ValueError(f"tri_min {tri_min.shape} / tri_max "
                         f"{tri_max.shape}: expected two (T, 3) arrays")
    ids = (np.flatnonzero(np.asarray(valid)) if valid is not None
           else np.arange(len(tri_min)))
    ids = np.ascontiguousarray(ids, np.int32)
    handle = lib.srt_kdtree_build(_fp(tri_min), _fp(tri_max), _ip(ids),
                                  len(ids), int(max_depth), int(max_leaf))
    try:
        n, nl, cap = (np.zeros(1, np.int32) for _ in range(3))
        lib.srt_kdtree_counts(handle, _ip(n), _ip(nl), _ip(cap))
        nn, nl, cap = int(n[0]), int(nl[0]), int(cap[0])
        out = dict(node_min=np.zeros((nn, 3), np.float32),
                   node_max=np.zeros((nn, 3), np.float32),
                   child0=np.zeros(nn, np.int32),
                   child1=np.zeros(nn, np.int32),
                   leaf_id=np.zeros(nn, np.int32),
                   leaf_tris=np.zeros((max(1, nl), cap), np.int32))
        lib.srt_kdtree_export(handle, _fp(out["node_min"]),
                              _fp(out["node_max"]), _ip(out["child0"]),
                              _ip(out["child1"]), _ip(out["leaf_id"]),
                              _ip(out["leaf_tris"]))
    finally:
        lib.srt_kdtree_free(handle)
    return kdtree_from_arrays(out)


def native_ppm_encode(img: np.ndarray) -> Optional[bytes]:
    """The C++ P3 PPM encoder -> bytes, or None when the library is
    missing."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    cap = h * w * 3 * 4 + 64          # "255\t" per channel plus the header
    out = np.zeros(cap, np.uint8)
    n = lib.srt_ppm_encode(_fp(img), h, w, out.ctypes.data_as(_U8P), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def native_parse_scene(path: str):
    """Parse a `.crtscene` with the C++ loader -> a dict of host arrays
    mirroring what models/loader.py extracts (a bitmap texture carries its
    file path; decoding stays in Python), or None when the library is
    missing.  Raises ValueError on a malformed scene, as the Python loader
    does."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.srt_scene_parse(os.fsencode(path))
    try:
        err = lib.srt_scene_error(handle)
        if err:
            raise ValueError(err.decode())
        h, w, bucket = (np.zeros(1, np.int32) for _ in range(3))
        background = np.zeros(3, np.float32)
        cam_pos = np.zeros(3, np.float32)
        cam_mat = np.zeros(9, np.float32)
        counts = np.zeros(4, np.int32)
        lib.srt_scene_header(handle, _ip(h), _ip(w), _ip(bucket),
                             _fp(background), _fp(cam_pos), _fp(cam_mat),
                             _ip(counts[0:]), _ip(counts[1:]),
                             _ip(counts[2:]), _ip(counts[3:]))
        nl, nm, nx, no = (int(c) for c in counts)

        light_pos = np.zeros((nl, 3), np.float32)
        light_intensity = np.zeros(nl, np.float32)
        if nl:
            lib.srt_scene_lights(handle, _fp(light_pos),
                                 _fp(light_intensity))

        materials = []
        for i in range(nm):
            tag, smooth, tex = (np.zeros(1, np.int32) for _ in range(3))
            albedo = np.zeros(3, np.float32)
            ior = np.zeros(1, np.float32)
            lib.srt_scene_material(handle, i, _ip(tag), _fp(albedo),
                                   _fp(ior), _ip(smooth), _ip(tex))
            materials.append({
                "tag": int(tag[0]), "albedo": tuple(albedo.tolist()),
                "ior": float(ior[0]), "smooth": bool(smooth[0]),
                "tex": int(tex[0])})

        textures = []
        for i in range(nx):
            tag = np.zeros(1, np.int32)
            ca = np.zeros(3, np.float32)
            cb = np.zeros(3, np.float32)
            param = np.zeros(1, np.float32)
            buf = ctypes.create_string_buffer(4096)
            n = lib.srt_scene_texture(handle, i, _ip(tag), _fp(ca), _fp(cb),
                                      _fp(param), buf, 4096)
            textures.append({
                "tag": int(tag[0]), "color_a": tuple(ca.tolist()),
                "color_b": tuple(cb.tolist()), "param": float(param[0]),
                "file_path": buf.raw[:n].decode() if n else None})

        objects = []
        for i in range(no):
            mat, nv, nu, nt = (np.zeros(1, np.int32) for _ in range(4))
            lib.srt_scene_object_counts(handle, i, _ip(mat), _ip(nv),
                                        _ip(nu), _ip(nt))
            verts = np.zeros(int(nv[0]), np.float32)
            uvs = np.zeros(int(nu[0]), np.float32)
            tris = np.zeros(int(nt[0]), np.int32)
            lib.srt_scene_object_data(handle, i, _fp(verts), _fp(uvs),
                                      _ip(tris))
            objects.append({
                "material_index": int(mat[0]),
                "vertices": verts.reshape(-1, 3),
                "uvs": uvs.reshape(-1, 2) if int(nu[0]) else None,
                "triangles": tris.reshape(-1, 3).astype(np.int64)})

        return {
            "height": int(h[0]), "width": int(w[0]),
            "bucket_size": int(bucket[0]), "background": background,
            "cam_pos": cam_pos, "cam_mat": cam_mat.reshape(3, 3),
            "light_pos": light_pos, "light_intensity": light_intensity,
            "materials": materials, "textures": textures,
            "objects": objects,
        }
    finally:
        lib.srt_scene_free(handle)
