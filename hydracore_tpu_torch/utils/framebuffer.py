"""Framebuffer: accumulate raw HDR, normalize + tonemap only at readback.

A copy of the JAX package's utils/framebuffer.py (numpy, the same
arithmetic bit for bit). It keeps the reference contract: spp
normalization happens only at readback (GetLDRImage/GetHDRImage), so
callers add per-pass radiance into an (H, W, 3) float32 accumulator and
convert once.
"""
from __future__ import annotations

import numpy as np


def hdr_to_ldr(img, gamma: float = 2.2, exposure: float = 1.0):
    """sRGB-ish gamma map (RealColorToRGB256 semantics, screen.cl:493)."""
    x = np.nan_to_num(np.asarray(img, np.float32), nan=0.0,
                      posinf=1e6, neginf=0.0) * exposure
    x = np.clip(x, 0.0, None)
    x = np.power(x, 1.0 / gamma)
    return np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_png(path: str, img_ldr: np.ndarray):
    from PIL import Image

    Image.fromarray(img_ldr, "RGB").save(path)


def save_hdr_as_png(path: str, hdr: np.ndarray, gamma: float = 2.2):
    save_png(path, hdr_to_ldr(hdr, gamma=gamma))


def mse(a, b) -> float:
    """Per-image MSE over 8-bit LDR values: the reference pass criterion is
    mse < 50.0 (hydra_app/main_app_tests.cpp:149)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))
