"""Stateless counter-based RNG + low-discrepancy sampling, bit-exact with
the JAX package's ops/rng.py.

Every random number is a pure function of (sample_index, bounce,
dimension group, seed): a PCG3D / lowbias32 hash construction, so a ray
carries no generator state and any order of evaluation gives the same
numbers.

u32 arithmetic is emulated in int64 tensors holding values in [0, 2^32):
PyTorch's uint32 lacks add and shifts on the CPU, and a plain int64 product
of two u32 values can overflow, so products are split into 16-bit halves
(mul32) and every result is masked back to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """int / array / tensor -> int64 tensor of u32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x) & M32, dtype=torch.int64, device=device)
    return torch.as_tensor(np.asarray(x).astype(np.int64) & M32,
                           device=device)


def mul32(a, b):
    """(a * b) mod 2^32 for u32 values held in int64 (no int64 overflow)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def add32(a, b):
    return (a + b) & M32


def pcg3d(v):
    """PCG3D hash (Jarzynski & Olano, JCGT 2020): u32[...,3] -> u32[...,3]."""
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
    """lowbias32 scalar hash."""
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _to_unit_float(bits):
    """u32 -> float32 in [0, 1) using the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def rand4(sample_index, bounce, dim_group: int, seed=0):
    """Four uniform floats (..., 4) for (sample, bounce, dimension-group).
    bounce is an int, or an integer tensor of one bounce per sample (the
    regenerating wavefront keys each lane by its own depth)."""
    s = sample_index & M32
    group_mix = (dim_group * 0x85EBCA6B) & M32
    if isinstance(bounce, torch.Tensor):
        mix = mul32(bounce.to(torch.int64) & M32, 0x9E3779B9) ^ group_mix
        mix = torch.broadcast_to(mix, s.shape)
    else:
        mix = torch.full_like(s, ((bounce * 0x9E3779B9) & M32) ^ group_mix)
    seed_t = u32(seed, s.device)
    key = torch.stack([s, mix, torch.broadcast_to(seed_t, s.shape)], dim=-1)
    h = pcg3d(key)
    w = hash_u32(h[..., 0] ^ h[..., 1] ^ h[..., 2] ^ 0x27220A95)
    bits = torch.stack([h[..., 0], h[..., 1], h[..., 2], w], dim=-1)
    return _to_unit_float(bits)


def rand1(sample_index, bounce, dim_group, seed=0):
    return rand4(sample_index, bounce, dim_group, seed)[..., 0]


def rand2(sample_index, bounce, dim_group, seed=0):
    return rand4(sample_index, bounce, dim_group, seed)[..., :2]


# ----------------------------------------------------------------------------
# Sobol (base-2 digital net) with random digit scrambling for screen dims
# ----------------------------------------------------------------------------

def _sobol_direction_numbers(n_dims: int = 8) -> np.ndarray:
    """Direction numbers for the first few Sobol dimensions (Joe-Kuo style);
    dimension 0 is van der Corput."""
    table = [
        (1, 0, [1]),
        (2, 1, [1, 3]),
        (3, 1, [1, 3, 1]),
        (3, 2, [1, 1, 1]),
        (4, 1, [1, 1, 3, 3]),
        (4, 4, [1, 3, 5, 13]),
        (5, 2, [1, 1, 5, 5, 17]),
    ]
    V = np.zeros((n_dims, 32), dtype=np.uint64)
    for i in range(32):
        V[0, i] = 1 << (31 - i)
    for d in range(1, n_dims):
        s, a, m = table[(d - 1) % len(table)]
        m = list(m)
        for i in range(32):
            if i < s:
                V[d, i] = np.uint64(m[i]) << np.uint64(31 - i)
            else:
                v = V[d, i - s] ^ (V[d, i - s] >> np.uint64(s))
                for k in range(1, s):
                    if (a >> (s - 1 - k)) & 1:
                        v ^= V[d, i - k]
                V[d, i] = v
    return V.astype(np.uint32)


_SOBOL_V = _sobol_direction_numbers(8)


def sobol(index, dim: int, scramble: int = 0):
    """Sobol sample for u32 index (any shape), dimension dim, XOR-scrambled."""
    idx = index & M32
    bits = torch.zeros_like(idx)
    for b in range(32):
        bit = (idx >> b) & 1
        bits = bits ^ (bit * int(_SOBOL_V[dim, b]))
    bits = bits ^ (scramble & M32)
    return _to_unit_float(bits)


def screen_sample(sample_index, pixel_hash, dim0: int = 0):
    """2D anti-aliasing jitter: Sobol in (dim0, dim0+1), Cranley-Patterson
    rotated per pixel."""
    sx = sobol(sample_index, dim0)
    sy = sobol(sample_index, dim0 + 1)
    ph = pixel_hash & M32
    rot = pcg3d(torch.stack([ph, ph ^ 0xDEADBEEF,
                             torch.full_like(ph, 0x12345678)], dim=-1))
    rx = _to_unit_float(rot[..., 0])
    ry = _to_unit_float(rot[..., 1])
    jx = sx + rx
    jy = sy + ry
    return torch.stack([jx - torch.floor(jx), jy - torch.floor(jy)], dim=-1)
