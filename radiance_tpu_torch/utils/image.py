"""Image IO: PNG/JPG write + RMSE (the golden-image test metric).

Port of radiance_tpu/utils/image.py (reference: samples/sample1.cpp:437-439
writes timestamped JPGs).  PNG is written with numpy and zlib, so an
image can be saved where PIL is missing; JPEG writes and every read go
through PIL, imported when called.
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray) -> bytes:
    """[H, W, 3|4] uint8 -> PNG bytes (8-bit RGB or RGBA, no filter)."""
    arr = np.ascontiguousarray(np.asarray(rgba, np.uint8))
    if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
        raise ValueError(f"expected an [H, W, 3|4] image, got {arr.shape}")
    h, w, c = arr.shape
    # each row is preceded by its filter type byte (0: none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _pil(path: str):
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(f"{path}: reading images and writing JPEG need "
                          f"PIL, which is not installed (PNG writes do "
                          f"not)") from e
    return PILImage


def write_image(path: str, rgba: np.ndarray) -> str:
    """Write an [H, W, 3|4] uint8 image; format from extension (PNG
    unless .jpg/.jpeg)."""
    arr = np.asarray(rgba, np.uint8)
    if path.lower().endswith((".jpg", ".jpeg")):
        _pil(path).fromarray(np.ascontiguousarray(arr[..., :3]),
                             "RGB").save(path)
    else:
        with open(path, "wb") as f:
            f.write(encode_png(arr))
    return path


def read_image(path: str) -> np.ndarray:
    return np.asarray(_pil(path).open(path).convert("RGBA"))


def timestamped_path(prefix: str = "output", ext: str = "png") -> str:
    """Like the reference's `output.<ctime>.jpg` naming (sample1.cpp:433)."""
    return f"{prefix}.{int(time.time())}.{ext}"


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between images in 0..255 space."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
