"""ctypes binding of the host image preprocessing (``image_ops.cpp``).

``crop_resize_normalize`` and ``resize_normalize`` turn a uint8 HWC RGB
image into the normalized float32 HWC array the towers take, in one pass
that is bit-exact with PIL's resampler followed by ToTensor and Normalize
(``cmh_tpu/native/__init__.py``'s functions, the same C ABI). The library
is built at first use (``_build.py``); a failed build raises with the
compiler's message and a failed self-test raises too: nothing falls back to
PIL. ``data/transforms.py`` calls these.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

BILINEAR = 0
BICUBIC = 1


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _configure(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c_int = ctypes.c_int
    lib.crop_resize_normalize.argtypes = [
        u8p, c_int, c_int, c_int, c_int, c_int, c_int, f32p, c_int, c_int, c_int,
        f32p, f32p, c_int]
    lib.crop_resize_normalize.restype = None
    lib.resize_normalize.argtypes = [
        u8p, c_int, c_int, f32p, c_int, c_int, c_int, f32p, f32p, c_int]
    lib.resize_normalize.restype = None


def _self_test(lib: ctypes.CDLL) -> bool:
    """Any interpolation of a constant image must give exactly its
    normalized value, both filters, flipped or not."""
    src = np.full((8, 8, 3), 128, dtype=np.uint8)
    mean = np.full(3, 0.5, dtype=np.float32)
    std = np.full(3, 0.25, dtype=np.float32)
    want = (np.float32(128) / np.float32(255) - np.float32(0.5)) / np.float32(0.25)
    for mode in (BILINEAR, BICUBIC):
        for flip in (0, 1):
            dst = np.empty((4, 4, 3), dtype=np.float32)
            lib.resize_normalize(_ptr(src, ctypes.c_uint8), 8, 8, _ptr(dst, ctypes.c_float),
                                 4, 4, mode, _ptr(mean, ctypes.c_float),
                                 _ptr(std, ctypes.c_float), flip)
            if not np.all(dst == want):
                return False
    return True


def library() -> ctypes.CDLL:
    return _build.load("image_ops", _configure, _self_test)


def crop_resize_normalize(src: np.ndarray, box, size: int, mode: int, mean: np.ndarray,
                          std: np.ndarray, flip: bool = False) -> np.ndarray:
    """uint8 (H, W, 3) RGB → normalized float32 (size, size, 3): the rows
    [y, y + h) and columns [x, x + w) of ``box = (y, x, h, w)`` resized with
    ``mode`` (``BILINEAR`` or ``BICUBIC``); with ``flip`` the box addresses
    the horizontally flipped image."""
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"src must be uint8 (H, W, 3), got {src.dtype} {src.shape}")
    y, x, h, w = (int(v) for v in box)
    if not (0 <= y and 0 <= x and 0 < h and 0 < w and y + h <= src.shape[0]
            and x + w <= src.shape[1]):
        raise ValueError(f"crop box {box} (y, x, h, w) outside the {src.shape[:2]} image")
    if mode not in (BILINEAR, BICUBIC) or size <= 0:
        raise ValueError(f"mode {mode} or size {size} not supported")
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std must hold 3 values")
    dst = np.empty((size, size, 3), dtype=np.float32)
    library().crop_resize_normalize(
        _ptr(src, ctypes.c_uint8), src.shape[0], src.shape[1], y, x, h, w,
        _ptr(dst, ctypes.c_float), size, size, int(mode), _ptr(mean, ctypes.c_float),
        _ptr(std, ctypes.c_float), int(bool(flip)))
    return dst


def resize_normalize(src: np.ndarray, size: int, mode: int, mean: np.ndarray,
                     std: np.ndarray, flip: bool = False) -> np.ndarray:
    """The whole image resized to (size, size) and normalized."""
    src = np.asarray(src)
    return crop_resize_normalize(src, (0, 0, src.shape[0], src.shape[1]), size, mode,
                                 mean, std, flip)
