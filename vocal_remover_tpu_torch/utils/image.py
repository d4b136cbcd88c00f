"""Image writing for `--output_image` (reference lib/utils.py `imwrite`)
and reading.

Counterpart of vocal_remover_tpu/utils/image.py `imwrite` / `imread`:
PIL writes the file when it imports; without PIL a stdlib PNG encoder
writes it, with the extension swapped to `.png`. `imread` needs PIL.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["imwrite", "imread"]


def _write_png(path: str, img: np.ndarray):
    """Minimal PNG writer for uint8 grayscale / RGB / RGBA (H, W[, C])."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        color_type, data = 0, img[:, :, None]
    else:
        color_type, data = {1: 0, 3: 2, 4: 6}[img.shape[2]], img
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        c = tag + payload
        return (struct.pack(">I", len(payload)) + c
                + struct.pack(">I", zlib.crc32(c)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> bool:
    """Write a uint8 image; False (the error printed) when it cannot be
    written, as the reference's cv2 wrapper does."""
    try:
        try:
            from PIL import Image
        except ImportError:
            _write_png(os.path.splitext(path)[0] + ".png", img)
        else:
            Image.fromarray(np.asarray(img, np.uint8)).save(path)
        return True
    except Exception as e:
        print(e)
        return False


def imread(path: str):
    """The image as a numpy array, or None (the error printed) when it
    cannot be read or PIL cannot be imported, as the JAX package's."""
    try:
        from PIL import Image
    except ImportError:
        print("PIL unavailable")
        return None
    try:
        return np.asarray(Image.open(path))
    except Exception as e:
        print(e)
        return None
