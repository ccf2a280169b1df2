"""Image-space filters: bilateral, non-local means, height->normal.

The JAX package's utils/denoise.py (reference post ops
CPUBilateralFilter2D.cpp:16, shaders/image.cl: BilateralFilter:123,
NonLocalMeansFilter:241, NormalmapFromHeight:37) in PyTorch: every tap is
a rolled copy of the image (torch.roll), so a filter is a stack of dense
elementwise operations on the device the image lies on. The weights are
float32, as in the JAX package: the spatial weight of a tap is the float32
exp of the float32-rounded exponent (jnp.exp of a Python float).
"""
from __future__ import annotations

import torch


def _shift2(img, dy, dx):
    return torch.roll(img, (dy, dx), dims=(0, 1))


def _f32_exp(x: float, ref: torch.Tensor) -> torch.Tensor:
    """exp of a Python float rounded to float32 first, on ref's device."""
    return torch.exp(torch.tensor(x, dtype=torch.float32, device=ref.device))


def bilateral_filter(img, sigma_s: float = 2.0, sigma_r: float = 0.1,
                     radius: int = 3):
    """Edge-preserving smoothing of (H, W, 3)."""
    img = torch.as_tensor(img)
    acc = torch.zeros_like(img)
    wacc = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shift2(img, dy, dx)
            w_s = _f32_exp(-(dy * dy + dx * dx) / (2 * sigma_s * sigma_s), img)
            d = ((nb - img) ** 2).sum(-1)
            w = w_s * torch.exp(-d / (2 * sigma_r * sigma_r))
            acc = acc + nb * w[..., None]
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-8)[..., None]


def nlm_filter(img, h: float = 0.1, search_radius: int = 4,
               patch_radius: int = 1):
    """Non-local means over (H, W, 3): patch distances via box-filtered
    squared differences of shifted images."""
    img = torch.as_tensor(img)

    def boxf(x):
        k = 2 * patch_radius + 1
        for axis in (0, 1):
            x = sum(torch.roll(x, s, dims=axis)
                    for s in range(-patch_radius, patch_radius + 1)) / k
        return x

    acc = torch.zeros_like(img)
    wacc = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            nb = _shift2(img, dy, dx)
            d2 = boxf(((nb - img) ** 2).sum(-1))
            w = torch.exp(-torch.clamp(d2 - 2 * h * h, min=0.0) / (h * h))
            acc = acc + nb * w[..., None]
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-8)[..., None]


def normalmap_from_height(height, amount: float = 1.0):
    """(H, W) height -> (H, W, 3) tangent-space normal map in [-1, 1]
    (Sobel gradients, ref image.cl:37)."""
    h = torch.as_tensor(height)

    def sobel(img, axis):
        # roll(+1) fetches the PREVIOUS texel, so the forward neighbor is
        # shift(-1): gradient = (next - prev) taps
        if axis == 0:  # d/dy
            g = (_shift2(img, -1, -1) + 2 * _shift2(img, -1, 0) + _shift2(img, -1, 1)
                 - _shift2(img, 1, -1) - 2 * _shift2(img, 1, 0) - _shift2(img, 1, 1))
        else:  # d/dx
            g = (_shift2(img, -1, -1) + 2 * _shift2(img, 0, -1) + _shift2(img, 1, -1)
                 - _shift2(img, -1, 1) - 2 * _shift2(img, 0, 1) - _shift2(img, 1, 1))
        return g / 8.0

    gx = sobel(h, 1) * amount
    gy = sobel(h, 0) * amount
    n = torch.stack([-gx, -gy, torch.ones_like(h)], -1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)
