"""The GGX directional albedo E(alpha, mu) that the Kulla-Conty
multiple-scattering term of the GGX lobe reads: baked here by the
published procedure (NDF importance sampling, 2,048 samples a cell from a
numpy generator seeded 1, cells in row order), so the reference derives
the table itself and reads nothing the renderer ships."""
from __future__ import annotations

from functools import lru_cache

import numpy as np

SIZE = 64
SAMPLES = 2048


def _albedo(mu: float, alpha: float, n: int, rng) -> float:
    wo = np.array([np.sqrt(max(1 - mu * mu, 0.0)), 0.0, mu])
    u1 = rng.random(n)
    u2 = rng.random(n)
    a2 = alpha * alpha
    ct2 = (1 - u1) / np.maximum(1 + (a2 - 1) * u1, 1e-12)
    ct = np.sqrt(np.clip(ct2, 0, 1))
    st = np.sqrt(np.clip(1 - ct2, 0, 1))
    phi = 2 * np.pi * u2
    h = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
    woh = h @ wo
    wi = 2 * woh[:, None] * h - wo
    cos_i = wi[:, 2]
    valid = (cos_i > 0) & (woh > 0)

    def g1(c):
        c = np.maximum(c, 1e-6)
        return 2 * c / (c + np.sqrt(a2 + (1 - a2) * c * c))

    w = g1(mu) * g1(np.abs(cos_i)) * woh / np.maximum(mu * ct, 1e-9)
    return float(np.where(valid, w, 0.0).mean())


@lru_cache(maxsize=1)
def ggx_tables():
    """(E (64, 64) rows alpha, columns mu; E_avg (64,)) float32."""
    rng = np.random.default_rng(1)
    E = np.zeros((SIZE, SIZE), np.float32)
    for i in range(SIZE):
        alpha = max((i + 0.5) / SIZE, 1e-3)
        for j in range(SIZE):
            E[i, j] = _albedo(max((j + 0.5) / SIZE, 1e-3), alpha, SAMPLES,
                              rng)
    E = np.clip(E, 0.0, 1.0).astype(np.float32)
    mu = (np.arange(SIZE) + 0.5) / SIZE
    e_avg = (2.0 * (E * mu[None, :]).mean(axis=1)).astype(np.float32)
    return E, e_avg
