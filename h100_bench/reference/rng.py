"""Counter-based RNG: every uniform a pure function of (sample index,
bounce, dimension group, seed), a PCG3D / lowbias32 hash, with the screen
jitter from a scrambled Sobol net. u32 arithmetic is held in int64 tensors
with every product split into 16-bit halves. A frozen copy of the stream
definition the renderer keys its samples on, so both draw the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(a, b):
    """(a * b) mod 2^32 for u32 values held in int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def add32(a, b):
    return (a + b) & M32


def pcg3d(v):
    v = add32(mul32(v & M32, 1664525), 1013904223)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = add32(x, mul32(y, z))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = add32(x, mul32(y, z))
    y = add32(y, mul32(z, x))
    z = add32(z, mul32(x, y))
    return torch.stack([x, y, z], dim=-1)


def hash_u32(x):
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def unit_float(bits, dtype=torch.float32):
    """Top 24 bits of a u32 as a float in [0, 1)."""
    return ((bits >> 8).to(torch.float32) * (1.0 / 16777216.0)).to(dtype)


def rand4(sample_index, bounce: int, group: int, seed: int,
          dtype=torch.float32):
    """Four uniforms (..., 4) for (sample, bounce, dimension group)."""
    s = sample_index & M32
    mix = ((bounce * 0x9E3779B9) & M32) ^ ((group * 0x85EBCA6B) & M32)
    key = torch.stack([s, torch.full_like(s, mix),
                       torch.full_like(s, seed & M32)], dim=-1)
    h = pcg3d(key)
    w = hash_u32(h[..., 0] ^ h[..., 1] ^ h[..., 2] ^ 0x27220A95)
    return unit_float(torch.stack([h[..., 0], h[..., 1], h[..., 2], w], -1),
                      dtype)


def _sobol_directions(n_dims: int = 2) -> np.ndarray:
    """Direction numbers of the first Sobol dimensions (0: van der
    Corput; 1: s = 1, a = 0, m = [1])."""
    V = np.zeros((n_dims, 32), dtype=np.uint64)
    for i in range(32):
        V[0, i] = 1 << (31 - i)
    for i in range(32):
        V[1, i] = (np.uint64(1) << np.uint64(31 - i)) if i < 1 else \
            V[1, i - 1] ^ (V[1, i - 1] >> np.uint64(1))
    return V.astype(np.uint32)


_SOBOL = _sobol_directions()


def sobol(index, dim: int):
    idx = index & M32
    bits = torch.zeros_like(idx)
    for b in range(32):
        bits = bits ^ (((idx >> b) & 1) * int(_SOBOL[dim, b]))
    return unit_float(bits)


def screen_sample(sample_index, pixel):
    """Pixel jitter: Sobol (0, 1) Cranley-Patterson rotated by a hash of
    the pixel."""
    sx = sobol(sample_index, 0)
    sy = sobol(sample_index, 1)
    ph = pixel & M32
    rot = pcg3d(torch.stack([ph, ph ^ 0xDEADBEEF,
                             torch.full_like(ph, 0x12345678)], dim=-1))
    jx = sx + unit_float(rot[..., 0])
    jy = sy + unit_float(rot[..., 1])
    return torch.stack([jx - torch.floor(jx), jy - torch.floor(jy)], dim=-1)
