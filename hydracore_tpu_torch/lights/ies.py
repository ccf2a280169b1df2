"""IESNA LM-63 photometric file parser -> spherical intensity texture.

Host-side rebuild of the reference IES path (IESRender.cpp:29
CreateSphericalTextureFromIES + utils/ies_parser): the candela grid is
resampled onto a (n_theta, n_phi) texture normalized to peak 1; point/spot
lights modulate their intensity by it (spherical lookup around the light
axis). The port's own copy of the JAX package's lights/ies.py; the
device-side lookup is not ported yet (scenes with IES profiles raise)."""
from __future__ import annotations

import numpy as np


def parse_ies(text: str):
    """Parse an IESNA file (TILT=NONE). Returns (v_angles (Nv,), h_angles
    (Nh,), candela (Nh, Nv)) in degrees / candela."""
    lines = text.replace(",", " ").splitlines()
    it = iter(lines)
    for line in it:
        if line.upper().startswith("TILT"):
            if "NONE" not in line.upper():
                # consume the 4 tilt lines we don't support
                for _ in range(4):
                    next(it)
            break
    nums: list[float] = []
    for line in it:
        for tok in line.split():
            try:
                nums.append(float(tok))
            except ValueError:
                pass
    if len(nums) < 13:
        raise ValueError("truncated IES payload")
    n_v = int(nums[3])
    n_h = int(nums[4])
    # skip: lamps, lumens/lamp, multiplier, n_v, n_h, photometric type,
    # units, width, length, height, ballast, future, input watts
    head = 13
    v_angles = np.asarray(nums[head : head + n_v], np.float32)
    h_angles = np.asarray(nums[head + n_v : head + n_v + n_h], np.float32)
    c = np.asarray(nums[head + n_v + n_h : head + n_v + n_h + n_v * n_h], np.float32)
    if c.size != n_v * n_h:
        raise ValueError("candela grid size mismatch")
    return v_angles, h_angles, c.reshape(n_h, n_v) * float(nums[2])


def ies_to_texture(v_angles, h_angles, candela, n_theta: int = 64, n_phi: int = 64):
    """Resample to a (n_theta, n_phi, 4) normalized intensity texture
    (theta: 0=along light axis .. 180; phi wraps; symmetries expanded)."""
    thetas = (np.arange(n_theta) + 0.5) / n_theta * 180.0
    phis = (np.arange(n_phi) + 0.5) / n_phi * 360.0

    h_max = h_angles[-1] if len(h_angles) > 1 else 0.0
    out = np.zeros((n_theta, n_phi), np.float32)
    for j, ph in enumerate(phis):
        if h_max <= 0.0:
            row = candela[0]
        else:
            if h_max <= 90.0:  # quadrant symmetry
                p = ph % 180.0
                p = p if p <= 90.0 else 180.0 - p
            elif h_max <= 180.0:  # bilateral symmetry
                p = ph if ph <= 180.0 else 360.0 - ph
            else:
                p = ph % h_max
            hi = np.searchsorted(h_angles, p).clip(1, len(h_angles) - 1)
            f = (p - h_angles[hi - 1]) / max(h_angles[hi] - h_angles[hi - 1], 1e-6)
            row = candela[hi - 1] * (1 - f) + candela[hi] * f
        out[:, j] = np.interp(thetas, v_angles, row, left=row[0], right=row[-1])
    peak = max(out.max(), 1e-9)
    tex = np.zeros((n_theta, n_phi, 4), np.float32)
    tex[..., :3] = (out / peak)[..., None]
    tex[..., 3] = 1.0
    return tex, float(peak)


def load_ies_texture(path: str, n_theta: int = 64, n_phi: int = 64):
    with open(path, "r", errors="replace") as f:
        v, h, c = parse_ies(f.read())
    return ies_to_texture(v, h, c, n_theta, n_phi)
