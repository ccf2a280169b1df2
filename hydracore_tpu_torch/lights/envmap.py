"""Environment-map importance sampling: 2D piecewise-constant pdf tables.

Host-side numpy builds row-marginal + per-row-conditional CDFs over
luminance x sin(theta) (build_env_pdf, the JAX package's lights/envmap.py);
the device side inverts them with searchsorted. This slice ports constant
skies only, whose tables come from a uniform 8x16 image.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hydracore_tpu_torch.utils.math3d import normalize3, sqrt


def build_env_pdf(img: np.ndarray | None, max_size: int = 512):
    """img: (H, W, >=3) float env texture (lat-long) or None.
    Returns (rows_cdf (H+1,), cols_cdf (H, W+1), pdf (H, W)) numpy arrays;
    trivial 1x1 uniform tables when img is None."""
    if img is None:
        return (
            np.array([0.0, 1.0], np.float32),
            np.array([[0.0, 1.0]], np.float32),
            np.ones((1, 1), np.float32),
        )
    H, W = img.shape[:2]
    if max(H, W) > max_size:  # downscale by striding (cheap, conservative)
        sy, sx = max(H // max_size, 1), max(W // max_size, 1)
        img = img[::sy, ::sx]
        H, W = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    theta = (np.arange(H) + 0.5) / H * np.pi
    w = lum * np.sin(theta)[:, None]
    w = np.maximum(w, 1e-8)

    row_w = w.sum(axis=1)
    rows_cdf = np.concatenate([[0.0], np.cumsum(row_w / row_w.sum())]).astype(np.float32)
    rows_cdf[-1] = 1.0
    cols = w / row_w[:, None]
    cols_cdf = np.concatenate(
        [np.zeros((H, 1)), np.cumsum(cols, axis=1)], axis=1
    ).astype(np.float32)
    cols_cdf[:, -1] = 1.0

    # pdf over (u, v) in [0,1)^2 -> solid-angle pdf = pdf_uv / (2 pi^2 sin)
    pdf_uv = w / w.sum() * (H * W)
    return rows_cdf, cols_cdf, pdf_uv.astype(np.float32)


def sample_env_dir(rows_cdf, cols_cdf, pdf_uv, u1, u2):
    """Inverse-CDF sample: returns (dir (R,3), pdf_w (R,))."""
    Ht, Wt = pdf_uv.shape
    row = torch.clamp(torch.searchsorted(rows_cdf, u1.contiguous(), right=True) - 1,
                      0, Ht - 1)
    lo = rows_cdf[row]
    hi = rows_cdf[row + 1]
    fr = (u1 - lo) / torch.clamp(hi - lo, min=1e-12)
    ccdf = cols_cdf[row]  # (R, Wt+1)
    col = torch.clamp((ccdf <= u2[:, None]).sum(dim=1) - 1, 0, Wt - 1)
    lo2 = torch.gather(ccdf, 1, col[:, None])[:, 0]
    hi2 = torch.gather(ccdf, 1, (col + 1)[:, None])[:, 0]
    fc = (u2 - lo2) / torch.clamp(hi2 - lo2, min=1e-12)

    v = (row.to(torch.float32) + fr) / Ht
    u = (col.to(torch.float32) + fc) / Wt
    theta = v * math.pi
    phi = (u - 0.5) * (2.0 * math.pi)
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                     -sin_t * torch.cos(phi)], -1)
    pdf_w = pdf_uv[row, col] / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-8)
    return normalize3(d), pdf_w


def env_pdf_for_dir(rows_cdf, cols_cdf, pdf_uv, d):
    """Solid-angle pdf of sample_env_dir producing direction d (R,3)."""
    Ht, Wt = pdf_uv.shape
    u = 0.5 + torch.atan2(d[:, 0], -d[:, 2]) * (0.5 / math.pi)
    v = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0)) * (1.0 / math.pi)
    row = torch.clamp((v * Ht).to(torch.int64), 0, Ht - 1)
    col = torch.clamp((u * Wt).to(torch.int64), 0, Wt - 1)
    sin_t = sqrt(torch.clamp(1.0 - d[:, 1] ** 2, 1e-8, 1.0))
    return pdf_uv[row, col] / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-8)
