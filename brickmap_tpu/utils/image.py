"""Minimal dependency-free PNG/PPM output (this build's "present" path —
no GL interop needed, SURVEY.md §7 milestone 7)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_png", "write_png", "write_ppm", "to_uint8"]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [H, W, 3] in [0,1] -> uint8."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """Encode [H, W, 3] image (float 0-1 or uint8) as an 8-bit RGB PNG."""
    arr = img if img.dtype == np.uint8 else to_uint8(img)
    h, w, _ = arr.shape
    raw = b"".join(
        b"\x00" + arr[row].tobytes() for row in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] image (float 0-1 or uint8) as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_ppm(path: str, img: np.ndarray) -> None:
    arr = img if img.dtype == np.uint8 else to_uint8(img)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())
