"""Image helpers: PNG encode/save, tonemap/gamma, PSNR.

The interactive app routes screenshots through the async native sidecar
(app/screenshot.py + runtime/native); these are the synchronous helpers.
"""

from __future__ import annotations

import os

import numpy as np


def linear_to_srgb_u8(img: np.ndarray) -> np.ndarray:
    """Gamma-2.2 encode like post.wgsl:279 and clamp to u8."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (np.power(img, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img_u8: np.ndarray) -> None:
    from . import png

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    png.write(path, img_u8)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
